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
resume, as in the JAX package.

``save_checkpoint_dist`` / ``load_checkpoint_dist`` are the counterpart of
the JAX package's orbax route (``save_checkpoint_orbax``): a directory with
the device state (graph, table, plane nodes, marginals, prior) written by
``torch.distributed.checkpoint`` under ``device_state/`` and the host state
beside it in ``host_state.json``, with the keys and values of the JAX
package's ``_engine_host_meta``. The engine's state lives on the controller
(rank 0 of a mesh), which writes it. Orbax's ``device_state/`` is a JAX
library's format, so neither package loads the other's.
"""

from __future__ import annotations

import contextlib
import json
import warnings

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

    _restore_keyframes_and_gate(engine, meta)
    _restore_count_mirrors(engine)


def _restore_keyframes_and_gate(engine, meta: dict) -> None:
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


def _restore_count_mirrors(engine) -> None:
    """The host mirrors of the device counts follow the restored graph: the
    capacity check and ``get_keyframe_poses`` read them before the next
    tick's fetch would refresh them."""
    engine._n_poses = int(engine.graph.num_poses)
    engine._n_landmarks = int(engine.graph.num_landmarks)
    engine._n_odom = int(engine.graph.num_odom)
    engine._n_lme = int(engine.graph.num_lme)


# ---------------------------------------------------------------------------
# the distributed checkpoint (torch.distributed.checkpoint + host_state.json)
# ---------------------------------------------------------------------------

LEGACY_PRIOR = tuple(f for f in fl.MarginalPrior._fields if f not in PLANE_PRIOR)


def _engine_host_meta(engine) -> dict:
    """``host_state.json``: the JAX package's ``_engine_host_meta`` keys and
    values. Its engine keeps plane nodes and a plane prior part in point
    sessions too (at the initial landmark and edge capacities, the prior's
    plane part as wide as its landmark part), so those capacities are
    written as it writes them."""
    gate = engine.gate
    pn, prior = engine.plane_nodes, engine.prior
    Pl, E3 = (pn.max_planes, pn.max_edges) if pn is not None else engine._plane_caps0
    return {
        "keyframes": [
            {"stamp": k.stamp, "odom": k.odom.tolist(), "robot_pose": k.robot_pose.tolist(),
             "accum_distance": k.accum_distance, "node_idx": k.node_idx}
            for k in engine.keyframes
        ],
        "gate": {"is_first": gate.is_first, "accum_distance": gate.accum_distance,
                 "prev_keypose": gate.prev_keypose.tolist(), "prev_time": gate.prev_time},
        "first_key_added": engine.first_key_added,
        "stats_history": engine.stats_history,
        "kf_base": engine._kf_base,
        "archived_poses": [np.asarray(p).tolist() for p in engine.archived_poses],
        "robot_pose": engine.robot_pose.tolist(),
        "vio_pose": engine.vio_pose.tolist(),
        "prev_odom": engine.prev_odom.tolist(),
        "map2odom": engine.map2odom.tolist(),
        "robot_traj": [[s, p.tolist()] for s, p in engine.robot_traj],
        "vio_traj": [[s, p.tolist()] for s, p in engine.vio_traj],
        "capacities": {
            "K": engine.graph.poses.shape[0], "L": engine.graph.landmarks.shape[0],
            "E1": engine.graph.odom_i.shape[0], "E2": engine.graph.lme_k.shape[0], "Pl": Pl, "E3": E3,
            "PB": prior.max_poses, "PL": prior.Hl.shape[0],
            "PPl": prior.Hpl.shape[0] if pn is not None else prior.Hl.shape[0],
        },
    }


@contextlib.contextmanager
def _single_process():
    """``torch.distributed.checkpoint`` without its warning that no process
    group takes part: one process writes and reads the whole state."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _device_state(engine) -> dict:
    """The state dict ``torch.distributed.checkpoint`` writes: nested dicts
    of the engine's tensors (a point session's empty plane prior left out)."""
    prior = engine.prior
    state = {
        "graph": {k: getattr(engine.graph, k) for k in gs.FIELDS},
        "table": {k: getattr(engine.table, k) for k in TABLE_FIELDS},
        "marginals": engine.marginals,
        "prior": {k: getattr(prior, k) for k in fl.MarginalPrior._fields
                  if prior.Hpl.shape[0] or k not in PLANE_PRIOR},
    }
    if engine.plane_nodes is not None:
        state["planes"] = {k: getattr(engine.plane_nodes, k) for k in gp.FIELDS}
    return state


def save_checkpoint_dist(path: str, engine) -> None:
    """The engine's state as a directory: ``device_state/`` through
    ``torch.distributed.checkpoint`` and ``host_state.json``."""
    import os

    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    # the controller holds the whole (replicated) state and writes it alone
    with _single_process():
        dcp.save(_device_state(engine), checkpoint_id=os.path.join(path, "device_state"), no_dist=True)
    with open(os.path.join(path, "host_state.json"), "w") as f:
        json.dump(_engine_host_meta(engine), f)


def load_checkpoint_dist(path: str, engine) -> None:
    """Restore ``save_checkpoint_dist``'s directory in place into a freshly
    constructed engine (same config), at the saved capacities. A prior saved
    without its plane part (a ``host_state.json`` without ``PPl``, the JAX
    package's legacy prior) gets an empty one."""
    import os

    import torch.distributed.checkpoint as dcp

    from semantic_slam_tpu_torch.assoc.association import make_table

    path = os.path.abspath(path)
    with open(os.path.join(path, "host_state.json")) as f:
        meta = json.load(f)
    caps = meta["capacities"]
    dev, dt = engine.device, engine.dtype
    saved = set(dcp.FileSystemReader(os.path.join(path, "device_state")).read_metadata().state_dict_metadata)
    planes = engine.cfg.use_plane_landmarks

    # the template at the saved capacities; the loader fills it in place
    g = gs.make_graph(caps["K"], caps["L"], caps["E1"], caps["E2"], dtype=dt, device=dev)
    t = make_table(caps["L"], dtype=dt, device=dev)
    template = {
        "graph": {k: getattr(g, k) for k in gs.FIELDS},
        "table": {k: getattr(t, k) for k in TABLE_FIELDS},
        "marginals": torch.eye(3, dtype=dt, device=dev).repeat(caps["L"], 1, 1),
    }
    if "planes.planes" in saved:
        pn = gp.make_planes(caps["Pl"], caps["E3"], dtype=dt, device=dev)
        template["planes"] = {k: getattr(pn, k) for k in gp.FIELDS}
    plane_prior = "prior.Hpl" in saved and "PPl" in caps
    if "prior.Hp" in saved:
        full = fl.empty_prior(caps.get("PL", caps["L"]), PB=caps["PB"], Pl=caps["PPl"] if plane_prior else 0,
                              dtype=dt, device=dev)
        template["prior"] = {k: getattr(full, k) for k in (fl.MarginalPrior._fields if plane_prior else LEGACY_PRIOR)}
    with _single_process():
        dcp.load(template, checkpoint_id=os.path.join(path, "device_state"), no_dist=True)

    engine.graph = gs.GraphState(**template["graph"])
    engine.table = LandmarkTable(**template["table"])
    engine.marginals = template["marginals"]
    if "planes" in template:
        engine.plane_nodes = gp.PlaneNodes(**template["planes"])
    if "prior" in template:
        fields = dict(template["prior"])
        if not plane_prior:
            # empty plane blocks at the engine's plane capacity (none in a
            # point session)
            fresh = fl.empty_prior(fields["Hl"].shape[0], PB=fields["p_idx"].shape[0],
                                   Pl=engine.plane_nodes.max_planes if planes else 0, dtype=dt, device=dev)
            fields.update({k: getattr(fresh, k) for k in PLANE_PRIOR})
        engine.prior = fl.MarginalPrior(**fields)
    if engine.cfg.solver.fixed_lag_window > 0:
        engine.prior = fl.grow_prior(engine.prior, engine.graph.max_landmarks)
    engine.archived_poses = [np.asarray(p, np.float64) for p in meta.get("archived_poses", [])]
    engine.robot_pose = np.asarray(meta["robot_pose"], np.float64)
    engine.vio_pose = np.asarray(meta["vio_pose"], np.float64)
    engine.prev_odom = np.asarray(meta["prev_odom"], np.float64)
    engine.map2odom = np.asarray(meta["map2odom"], np.float64)
    engine.robot_traj = [(float(s), np.asarray(p, np.float64)) for s, p in meta["robot_traj"]]
    engine.vio_traj = [(float(s), np.asarray(p, np.float64)) for s, p in meta["vio_traj"]]
    _restore_keyframes_and_gate(engine, meta)
    _restore_count_mirrors(engine)
