"""Checkpoint / resume of the whole engine state (port of
``semantic_slam_tpu.io.checkpoint``: its npz format, point landmarks only).

The reference can only dump its graph at shutdown (``saveGraph``,
``graph_slam.cpp:236-239``) and has no load path (SURVEY.md §5). Here the
solver, association and trajectory state round-trip through one compressed
npz, in the JAX package's format: the same keys (``g_*`` graph, ``t_*``
landmark table, ``fl_*`` fixed-lag prior, ``fl_archived``, the trajectories)
and the same JSON ``meta`` (keyframes, gate, ``kf_base``, ``stats_history``).
So a checkpoint written here loads in the JAX package, whose loader fills the
plane nodes and the prior's plane part it does not find, and one written
there loads here:

* plane nodes (``p_*``) are dropped when the file holds none, and the
  prior's plane part (``fl_Hpl``, ``fl_pl_ref``, ``fl_gpl0``) when its
  information and gradient are zero; otherwise the load raises (plane
  landmarks are not ported);
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
from semantic_slam_tpu_torch.graph import state as gs
from semantic_slam_tpu_torch.solver import fixed_lag as fl

PLANES_UNPORTED = "not ported to semantic_slam_tpu_torch yet: a checkpoint with plane landmarks (P7a)"


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
        **{f"fl_{k}": v.detach().cpu().numpy() for k, v in engine.prior._asdict().items()},
        fl_archived=np.asarray(engine.archived_poses, np.float64).reshape(-1, 7),
    )


def load_checkpoint(path: str, engine) -> None:
    """Restore in place into a freshly constructed engine (same config)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if "p_planes" in z.files and (int(z["p_num_planes"]) or int(z["p_num_pe"])):
        raise NotImplementedError(PLANES_UNPORTED)
    if any(k in z.files and np.any(z[k] != 0) for k in ("fl_Hpl", "fl_gpl0")):
        raise NotImplementedError(PLANES_UNPORTED)

    def arr(key: str) -> torch.Tensor:
        a = z[key]
        dt = torch.int32 if a.dtype.kind in "iu" else engine.dtype
        return torch.as_tensor(a).to(device=engine.device, dtype=dt)

    engine.graph = gs.GraphState(**{k: arr(f"g_{k}") for k in gs.FIELDS})
    engine.table = LandmarkTable(**{k: arr(f"t_{k}") for k in TABLE_FIELDS})
    if "fl_Hp" in z.files:
        engine.prior = fl.MarginalPrior(**{k: arr(f"fl_{k}") for k in fl.MarginalPrior._fields})
        engine.archived_poses = [p.copy() for p in z["fl_archived"]]
    if engine.cfg.solver.fixed_lag_window > 0:
        # the prior's landmark part spans the graph's landmark capacity, which
        # the next capacity doubling grows together with it
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
