"""Multi-session map merging and joint bundle adjustment (port of
``semantic_slam_tpu.runtime.multisession``, on one device).

Sessions are engine checkpoints; merging

  1. concatenates pose nodes and odometry edges with index offsets (each
     session keeps its own gauge chain; session 0's first pose stays the
     global gauge anchor),
  2. cross-associates landmarks between sessions (same class + plane type +
     within the Euclidean merge radius -> unified landmark id), which is
     what ties the sessions into one frame,
  3. re-targets observation edges to the unified landmark ids,
  4. runs joint BA: the dense Schur LM (``solver/lm.py``), as the JAX
     package's single-device merge does.

With plane landmarks (``merge_graphs_planes``) the plane nodes ride the same
landmark unification, and the joint BA is the dense plane LM
(``graph/planes.py``). Given a mesh (``parallel.dist.make_mesh``) the joint
BA runs over its ranks: the points' dense LM with the edges split
(``parallel.sharded.sharded_lm_optimize``), the planes' on the row-range
loop with the pose rows split (``soa_dist.sharded_lm_optimize_soa_planes``;
the JAX package runs its edge-sharded ELL PCG there, the same optimum).
"""

from __future__ import annotations

import numpy as np
import torch

from semantic_slam_tpu_torch.assoc.association import table_to_numpy
from semantic_slam_tpu_torch.graph import planes as gp
from semantic_slam_tpu_torch.graph import state as gs
from semantic_slam_tpu_torch.solver import lm as lm_mod


def merge_graphs(graphs: list[gs.GraphState], tables: list, merge_radius: float = 1.0,
                 dtype=None) -> tuple[gs.GraphState, np.ndarray]:
    """Merge session graphs; returns (merged graph, landmark_owner), where
    landmark_owner[i] is the session that contributed merged landmark i.
    The surgery runs on the host (numpy); the merged graph lives on the first
    graph's device."""
    merged, owner, _, _, _ = _merge_core(graphs, tables, merge_radius, dtype)
    return merged, owner


def _merge_core(graphs: list[gs.GraphState], tables: list, merge_radius: float = 1.0, dtype=None):
    """merge_graphs internals; also returns the per-session landmark remaps,
    the owners' local ids and the pose offsets."""
    dtype = dtype or graphs[0].poses.dtype
    device = graphs[0].poses.device

    sessions = []
    for g, t in zip(graphs, tables):
        a, ta = gs.graph_to_numpy(g), table_to_numpy(t)
        K, L, E1, E2 = (int(a[n]) for n in ("num_poses", "num_landmarks", "num_odom", "num_lme"))
        sessions.append(
            {
                "poses": a["poses"][:K].astype(np.float64),
                "lms": a["landmarks"][:L].astype(np.float64),
                "lm_class": ta["class_id"][:L],
                "lm_ptype": ta["plane_type"][:L],
                "oi": a["odom_i"][:E1],
                "oj": a["odom_j"][:E1],
                "om": a["odom_meas"][:E1].astype(np.float64),
                "oinfo": a["odom_info"][:E1].astype(np.float64),
                "lk": a["lme_k"][:E2],
                "ll": a["lme_l"][:E2],
                "lmeas": a["lme_meas"][:E2].astype(np.float64),
                "linfo": a["lme_info"][:E2].astype(np.float64),
            }
        )

    # cross-session landmark unification: the nearest earlier unified
    # landmark of the same class and plane type within the radius
    uni_pos: list[np.ndarray] = []
    uni_class: list[int] = []
    uni_ptype: list[int] = []
    owner: list[int] = []
    owner_local: list[int] = []  # owner's local landmark id per unified id
    lm_map: list[np.ndarray] = []  # per session: local id -> unified id
    for si, s in enumerate(sessions):
        mapping = np.zeros(len(s["lms"]), np.int64)
        for li in range(len(s["lms"])):
            pos = s["lms"][li]
            cid = int(s["lm_class"][li])
            pt = int(s["lm_ptype"][li])
            best, bestd = -1, merge_radius
            for ui in range(len(uni_pos)):
                if uni_class[ui] == cid and uni_ptype[ui] == pt:
                    d = float(np.linalg.norm(uni_pos[ui] - pos))
                    if d < bestd:
                        best, bestd = ui, d
            if best < 0:
                best = len(uni_pos)
                uni_pos.append(pos.copy())
                uni_class.append(cid)
                uni_ptype.append(pt)
                owner.append(si)
                owner_local.append(li)
            mapping[li] = best
        lm_map.append(mapping)

    pose_off = np.cumsum([0] + [len(s["poses"]) for s in sessions[:-1]])
    cat = {
        "poses": np.concatenate([s["poses"] for s in sessions]),
        "landmarks": np.stack(uni_pos) if uni_pos else np.zeros((0, 3)),
        "odom_i": np.concatenate([s["oi"] + pose_off[i] for i, s in enumerate(sessions)]),
        "odom_j": np.concatenate([s["oj"] + pose_off[i] for i, s in enumerate(sessions)]),
        "odom_meas": np.concatenate([s["om"] for s in sessions]),
        "odom_info": np.concatenate([s["oinfo"] for s in sessions]),
        "lme_k": np.concatenate([s["lk"] + pose_off[i] for i, s in enumerate(sessions)]),
        "lme_l": np.concatenate([lm_map[i][s["ll"]] for i, s in enumerate(sessions)]),
        "lme_meas": np.concatenate([s["lmeas"] for s in sessions]),
        "lme_info": np.concatenate([s["linfo"] for s in sessions]),
    }

    cap, n = gs.pow2_capacity, {k: len(v) for k, v in cat.items()}
    merged = gs.make_graph(cap(n["poses"]), cap(max(n["landmarks"], 1)), cap(max(n["odom_i"], 1)),
                           cap(max(n["lme_k"], 1)), dtype=dtype, device=device)
    out = {}
    for name, vals in cat.items():
        dst = getattr(merged, name).clone()
        dst[: len(vals)] = torch.as_tensor(vals, device=device).to(dst.dtype)
        out[name] = dst
    for name, key in (("num_poses", "poses"), ("num_landmarks", "landmarks"), ("num_odom", "odom_i"),
                      ("num_lme", "lme_k")):
        out[name] = torch.tensor(n[key], dtype=torch.int32, device=device)
    return gs.GraphState(**out), np.asarray(owner, np.int64), lm_map, np.asarray(owner_local, np.int64), pose_off


def merge_graphs_planes(graphs: list[gs.GraphState], tables: list, plane_nodes: list, merge_radius: float = 1.0,
                        dtype=None):
    """The plane-landmark merge: the points as ``merge_graphs``; plane node i
    is landmark i's patch, so the planes ride the same unification (each
    unified landmark takes its owner session's plane), and the SE3-plane
    edges re-target through the pose offsets and landmark maps. Returns
    (merged graph, merged plane nodes, landmark_owner)."""
    dtype = dtype or graphs[0].poses.dtype
    merged, owner, lm_map, owner_local, pose_off = _merge_core(graphs, tables, merge_radius, dtype)
    device = merged.poses.device
    sess = [gp.plane_nodes_to_numpy(pn) for pn in plane_nodes]
    uni = (np.stack([sess[s]["planes"][li].astype(np.float64) for s, li in zip(owner, owner_local)])
           if len(owner) else np.zeros((0, 4)))
    n = [int(b["num_pe"]) for b in sess]
    cat = {
        "pe_k": np.concatenate([b["pe_k"][:m] + pose_off[i] for i, (b, m) in enumerate(zip(sess, n))]),
        "pe_p": np.concatenate([lm_map[i][b["pe_p"][:m]] for i, (b, m) in enumerate(zip(sess, n))]),
        "pe_meas": np.concatenate([b["pe_meas"][:m].astype(np.float64) for b, m in zip(sess, n)]),
        "pe_info": np.concatenate([b["pe_info"][:m].astype(np.float64) for b, m in zip(sess, n)]),
    }
    E3 = len(cat["pe_k"])
    pn = gp.make_planes(merged.landmarks.shape[0], gs.pow2_capacity(max(E3, 1)), dtype=dtype, device=device)
    out = {"planes": uni, **cat}
    fields = {}
    for name, vals in out.items():
        dst = getattr(pn, name).clone()
        dst[: len(vals)] = torch.as_tensor(vals, device=device).to(dst.dtype)
        fields[name] = dst
    count = lambda m: torch.tensor(m, dtype=torch.int32, device=device)  # noqa: E731
    return merged, pn.replace(**fields, num_planes=count(len(uni)), num_pe=count(E3)), owner


def _by_pose(fields: dict, k: torch.Tensor, count) -> tuple[dict, int]:
    """Edge arrays ``fields`` (with pose column ``k``) with their first
    ``count`` rows stably sorted by pose (the row-range layout's contract,
    ``pcg.build_slots``; the order of a sum's terms is all that changes),
    and the largest number of edges of one pose."""
    n = int(count)
    if n == 0:
        return fields, 1
    order = torch.cat([torch.sort(k[:n].long(), stable=True).indices, torch.arange(n, k.shape[0], device=k.device)])
    return {f: v[order] for f, v in fields.items()}, int(torch.bincount(k[:n].long()).max())


def joint_bundle_adjust_planes(merged: gs.GraphState, pn, mesh=None, max_iterations: int = 64):
    """Joint BA over the merged graph and plane nodes: the dense plane LM,
    or over ``mesh`` the row-range loop's plane LM with the pose rows split
    (the merged pose capacity must divide the mesh size; the edges are
    sorted by pose and bounded per pose as the merged graph has them; the
    returned graph and plane nodes hold them in that order). Returns
    (graph, plane nodes, LMStats)."""
    if mesh is None:
        return gp.lm_optimize_with_planes(merged, pn, max_iterations=max_iterations)
    from semantic_slam_tpu_torch.solver import soa_dist

    lme, R = _by_pose({f: getattr(merged, f) for f in ("lme_k", "lme_l", "lme_meas", "lme_info")}, merged.lme_k,
                      merged.num_lme)
    pe, R4 = _by_pose({f: getattr(pn, f) for f in ("pe_k", "pe_p", "pe_meas", "pe_info")}, pn.pe_k, pn.num_pe)
    return soa_dist.sharded_lm_optimize_soa_planes(merged.replace(**lme), pn.replace(**pe), mesh,
                                                   max_iterations=max_iterations, ell_rows=(1, 1, R, R4))


def joint_bundle_adjust(merged: gs.GraphState, mesh=None, max_iterations: int = 64):
    """Joint BA over the merged graph: the dense Schur LM, over ``mesh`` with
    the edges split (``parallel.sharded``). Returns (graph, LMStats)."""
    if mesh is None:
        return lm_mod.lm_optimize(merged, max_iterations=max_iterations)
    from semantic_slam_tpu_torch.parallel.sharded import shard_graph_edges, sharded_lm_optimize

    return sharded_lm_optimize(shard_graph_edges(merged, mesh), mesh, max_iterations=max_iterations)
