"""Checkpoint / resume of the whole engine state (port of
``semantic_slam_tpu.io.checkpoint``: its npz format).

The reference can only dump its graph at shutdown (``saveGraph``,
``graph_slam.cpp:236-239``) and has no load path (SURVEY.md §5). Here the
solver, association and trajectory state round-trip through one compressed
npz, in the JAX package's format: the same keys (``g_*`` graph, ``t_*``
landmark table, ``p_*`` plane nodes, ``fl_*`` fixed-lag prior with its
plane part ``fl_Hpl``/``fl_pl_ref``/``fl_gpl0``, ``fl_archived``, the
trajectories) and the same JSON ``meta`` (keyframes, gate, ``kf_base``,
``stats_history``). So a checkpoint written here loads in the JAX package,
and one written there loads here:

* a point-landmark session writes no ``p_*`` keys and no plane prior (the
  JAX loader fills both in); it drops the JAX package's plane nodes
  when they hold no plane and edge, and the prior's plane part when its
  information and gradient are zero, and keeps them otherwise;
* a plane-landmark session writes and reads them all; a file without plane
  nodes keeps the engine's fresh ones, and the prior's plane part grows with
  the landmark capacity;
* every float array is cast to the engine's dtype and device; integer
  arrays load as int32.

Arrays load at the capacities saved in the file, which may exceed a fresh
engine's after capacity doubling. Keyframe clouds are not checkpointed (they
are replay-log data); neither is sensor data still pending, nor the
engine's tick counter, so ``optimize_every_n_ticks`` counts from 0 after a
resume, as in the JAX package. The JAX package's orbax backend is not
ported.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from semantic_slam_tpu_torch.assoc.association import TABLE_FIELDS, LandmarkTable, table_to_numpy
from semantic_slam_tpu_torch.graph import planes as gp
from semantic_slam_tpu_torch.graph import state as gs
from semantic_slam_tpu_torch.solver import fixed_lag as fl

PLANE_PRIOR = ("Hpl", "pl_ref", "gpl0")  # the prior's plane part, empty (and not written) in point sessions


def save_checkpoint(path: str, engine) -> None:
    gate = engine.gate
    meta = {
        "keyframes": [
            {
                "stamp": k.stamp,
                "odom": k.odom.tolist(),
                "robot_pose": k.robot_pose.tolist(),
                "accum_distance": k.accum_distance,
                "node_idx": k.node_idx,
            }
            for k in engine.keyframes
        ],
        "gate": {
            "is_first": gate.is_first,
            "accum_distance": gate.accum_distance,
            "prev_keypose": gate.prev_keypose.tolist(),
            "prev_time": gate.prev_time,
        },
        "first_key_added": engine.first_key_added,
        "dtype": str(np.dtype(engine._npdt)),
        "stats_history": engine.stats_history,
        "kf_base": engine._kf_base,
    }
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        robot_pose=engine.robot_pose,
        vio_pose=engine.vio_pose,
        prev_odom=engine.prev_odom,
        map2odom=engine.map2odom,
        marginals=engine.marginals.detach().cpu().numpy(),
        robot_traj_t=np.array([s for s, _ in engine.robot_traj]),
        robot_traj_p=np.array([p for _, p in engine.robot_traj]).reshape(-1, 7),
        vio_traj_t=np.array([s for s, _ in engine.vio_traj]),
        vio_traj_p=np.array([p for _, p in engine.vio_traj]).reshape(-1, 7),
        **{f"g_{k}": v for k, v in gs.graph_to_numpy(engine.graph).items()},
        **{f"t_{k}": v for k, v in table_to_numpy(engine.table).items()},
        **({} if engine.plane_nodes is None else
           {f"p_{k}": v for k, v in gp.plane_nodes_to_numpy(engine.plane_nodes).items()}),
        **{f"fl_{k}": v for k, v in fl.prior_to_numpy(engine.prior).items()
           if engine.prior.Hpl.shape[0] or k not in PLANE_PRIOR},
        fl_archived=np.asarray(engine.archived_poses, np.float64).reshape(-1, 7),
    )


def load_checkpoint(path: str, engine) -> None:
    """Restore in place into a freshly constructed engine (same config)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    planes = engine.cfg.use_plane_landmarks

    def arr(key: str) -> torch.Tensor:
        a = z[key]
        dt = torch.int32 if a.dtype.kind in "iu" else engine.dtype
        return torch.as_tensor(a).to(device=engine.device, dtype=dt)

    engine.graph = gs.GraphState(**{k: arr(f"g_{k}") for k in gs.FIELDS})
    engine.table = LandmarkTable(**{k: arr(f"t_{k}") for k in TABLE_FIELDS})
    if "p_planes" in z.files and (planes or int(z["p_num_planes"]) or int(z["p_num_pe"])):
        engine.plane_nodes = gp.PlaneNodes(**{k: arr(f"p_{k}") for k in gp.FIELDS})
    if "fl_Hp" in z.files:
        # the file's plane part, or an empty one at the engine's plane capacity
        plane_part = "fl_Hpl" in z.files and z["fl_Hpl"].shape[0] > 0 and (
            planes or any(np.any(z[f"fl_{k}"] != 0) for k in ("Hpl", "gpl0")))
        fresh = fl.empty_prior(z["fl_Hl"].shape[0], PB=z["fl_Hp"].shape[0] // 6,
                               Pl=engine.plane_nodes.max_planes if planes else 0, dtype=engine.dtype,
                               device=engine.device)
        engine.prior = fl.MarginalPrior(**{
            k: arr(f"fl_{k}") if (plane_part or k not in PLANE_PRIOR) else getattr(fresh, k)
            for k in fl.MarginalPrior._fields
        })
        engine.archived_poses = [p.copy() for p in z["fl_archived"]]
    if engine.cfg.solver.fixed_lag_window > 0:
        # the prior's landmark (and plane) part spans the graph's landmark
        # capacity, which the next capacity doubling grows together with it
        engine.prior = fl.grow_prior(engine.prior, engine.graph.max_landmarks)
    engine.marginals = arr("marginals")
    engine.robot_pose = z["robot_pose"].astype(np.float64)
    engine.vio_pose = z["vio_pose"].astype(np.float64)
    engine.prev_odom = z["prev_odom"].astype(np.float64)
    engine.map2odom = z["map2odom"].astype(np.float64)
    engine.robot_traj = [(float(s), p.copy()) for s, p in zip(z["robot_traj_t"], z["robot_traj_p"])]
    engine.vio_traj = [(float(s), p.copy()) for s, p in zip(z["vio_traj_t"], z["vio_traj_p"])]

    from semantic_slam_tpu_torch.runtime.engine import KeyframeMeta

    engine.first_key_added = bool(meta["first_key_added"])
    engine.stats_history = meta["stats_history"]
    engine.keyframes = [
        KeyframeMeta(
            stamp=k["stamp"],
            odom=np.asarray(k["odom"]),
            robot_pose=np.asarray(k["robot_pose"]),
            accum_distance=k["accum_distance"],
            cloud=None,
            boxes=None,
            class_ids=None,
            probs=None,
            node_idx=k["node_idx"],
        )
        for k in meta["keyframes"]
    ]
    engine._kf_base = int(meta.get("kf_base", 0))
    gate = meta["gate"]
    engine.gate.is_first = bool(gate["is_first"])
    engine.gate.accum_distance = float(gate["accum_distance"])
    engine.gate.prev_keypose = np.asarray(gate["prev_keypose"])
    engine.gate.prev_time = float(gate["prev_time"])
    _restore_count_mirrors(engine)


def _restore_count_mirrors(engine) -> None:
    """The host mirrors of the device counts follow the restored graph: the
    capacity check and ``get_keyframe_poses`` read them before the next
    tick's fetch would refresh them."""
    engine._n_poses = int(engine.graph.num_poses)
    engine._n_landmarks = int(engine.graph.num_landmarks)
    engine._n_odom = int(engine.graph.num_odom)
    engine._n_lme = int(engine.graph.num_lme)
