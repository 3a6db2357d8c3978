"""Several ranks: the edge-sharded dense LM and the sharded window step (port
of ``semantic_slam_tpu.parallel.sharded`` on the mesh of
``parallel/dist.py``).

* ``make_mesh`` is ``parallel.dist.make_mesh``.
* ``shard_graph_edges`` pads a graph's edge capacities to a multiple of the
  mesh size; ``sharded_lm_optimize`` then gives rank r the r-th of n equal
  slices of every edge array (the masks are taken before the split, so that
  they stay global) with the node state replicated. Each LM linearization
  (``Hpp`` [6K, 6K], W [6K, 3L], Hll, the gradients, chi2) is the sum of the
  ranks' edge shards: one all-reduce of ~(6K)^2 + 18KL elements a
  linearization, which is why only the merge's joint bundle adjustment
  (``runtime.multisession.joint_bundle_adjust(mesh=)``) takes this path and
  no engine tick does (a tick on a mesh runs ``soa_dist``'s row-range loop).
* ``sharded_window_step``: the window's frontend data-parallel over its B
  rows (each rank runs ``segmentation.segment_window``, and so K5, on its
  B/n rows), one all-gather of the [B, D, *] detections, the sequential
  association on the controller, then the sharded solve
  (``soa_dist.sharded_lm_optimize_soa``; the JAX package runs its
  edge-sharded ELL PCG there).
"""

from __future__ import annotations

import numpy as np
import torch

from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.parallel.dist import make_mesh  # noqa: F401 (the JAX module's entry point)
from semantic_slam_tpu_torch.solver import lm as lm_mod

Tensor = torch.Tensor

_EDGE_FIELDS = ("odom_i", "odom_j", "odom_meas", "odom_info", "lme_k", "lme_l", "lme_meas", "lme_info")


def shard_graph_edges(g: GraphState, mesh) -> GraphState:
    """``g`` with its odometry and observation edge capacities padded (with
    empty, masked rows) to a multiple of the mesh size, so that
    ``sharded_lm_optimize`` splits them evenly; node state is unchanged
    (replicated to every rank by the call)."""
    n = mesh.size

    def pad(a: Tensor) -> Tensor:
        extra = -a.shape[0] % n
        return a if extra == 0 else torch.cat([a, a.new_zeros((extra,) + a.shape[1:])])

    return g.replace(**{f: pad(getattr(g, f)) for f in _EDGE_FIELDS})


def _dense_body(mesh, payload: dict, *, max_iterations: int, rel_tol: float):
    """One rank's share of ``sharded_lm_optimize``: its edge slice, every
    linearization all-reduced as one collective, the LM replicated (its
    flags rank 0's)."""
    n, r = mesh.size, mesh.rank

    def shard(a: Tensor) -> Tensor:
        m = a.shape[0] // n
        return a[r * m:(r + 1) * m]

    edges = tuple(shard(payload[k]) for k in ("odom_i", "odom_j", "odom_meas", "odom_info", "odom_mask",
                                              "lme_k", "lme_l", "lme_meas", "lme_info", "lme_mask"))

    def lin_fn(p, l):
        return lm_mod.Linearization(*mesh.allreduce(tuple(lm_mod.linearize_arrays(p, l, *edges))))

    p, l, stats, _ = lm_mod.run_lm_loop(payload["poses"], payload["landmarks"], lin_fn, payload["pose_free"],
                                        payload["lm_free"], max_iterations, rel_tol, agree=mesh.agree)
    return p, l, stats


def sharded_lm_optimize(g: GraphState, mesh, max_iterations: int = 64, min_edges: int = 10,
                        rel_tol: float = 1e-6) -> tuple[GraphState, lm_mod.LMStats]:
    """The dense Schur LM (``lm.lm_optimize``) with the edges split over the
    mesh (their capacities must divide the mesh size: ``shard_graph_edges``;
    else ``ValueError``). Below ``min_edges`` edges no rank runs: the graph
    comes back unchanged with ``iterations == 0``, as from
    ``lm.lm_optimize``."""
    n = mesh.size
    E1, E2 = g.odom_i.shape[0], g.lme_k.shape[0]
    if E1 % n or E2 % n:
        raise ValueError(f"edge capacities E1={E1}, E2={E2} must divide the mesh size {n} (shard_graph_edges)")
    if min_edges > 0 and int(g.num_edges()) < min_edges:  # one count fetch, on the controller
        return lm_mod.lm_optimize(g, max_iterations=max_iterations, min_edges=min_edges, rel_tol=rel_tol)
    pose_free, lm_free = lm_mod._free_masks(g)
    payload = {
        "poses": g.poses, "landmarks": g.landmarks, "pose_free": pose_free, "lm_free": lm_free,
        "odom_i": g.odom_i, "odom_j": g.odom_j, "odom_meas": g.odom_meas, "odom_info": g.odom_info,
        "odom_mask": g.odom_mask(), "lme_k": g.lme_k, "lme_l": g.lme_l, "lme_meas": g.lme_meas,
        "lme_info": g.lme_info, "lme_mask": g.lme_mask(),
    }
    p, l, stats = mesh.run(_dense_body, payload, max_iterations=max_iterations, rel_tol=rel_tol)
    return g.replace(poses=p, landmarks=l), stats


# ---------------------------------------------------------------------------
# the sharded window step
# ---------------------------------------------------------------------------

_DET_WIDTHS = (("valid", 1), ("class_id", 1), ("prob", 1), ("plane_type", 1), ("num_points", 1),
               ("pose_cam", 3), ("normal_cam", 4), ("world_pose", 3))


def _window_frontend_body(mesh, payload: dict, *, seg_params: dict, statics: dict):
    """One rank's rows of a window's frontend (``segment_window`` on rows
    ``[rank B/n, (rank + 1) B/n)``), then one all-gather of every rank's
    detections packed into one [B/n, M, 15] buffer. Returns the window's
    detections [B, M, ...] (every rank holds them; rank 0's are read)."""
    from semantic_slam_tpu_torch.frontend import segmentation as seg_mod

    B = payload["points"].shape[0]
    Bl = B // mesh.size
    rows = slice(mesh.rank * Bl, (mesh.rank + 1) * Bl)
    dets = seg_mod.segment_window(
        payload["points"][rows], payload["cloud_valid"][rows], payload["boxes"][rows], payload["class_ids"][rows],
        payload["probs"][rows], payload["robot_xyzrpy"][rows], payload["cam_angle"], **seg_params, **statics,
    )
    dt = dets.world_pose.dtype
    M = dets.valid.shape[1]
    packed = torch.cat([getattr(dets, f).to(dt).reshape(Bl, M, w) for f, w in _DET_WIDTHS], dim=-1)
    full = torch.cat(mesh.all_gather(packed))  # [B, M, 15]
    out, i = {}, 0
    for f, w in _DET_WIDTHS:
        v = full[..., i:i + w]
        out[f] = (v[..., 0] if w == 1 else v).to(getattr(dets, f).dtype)
        i += w
    return seg_mod.DetectedObjects(**out)


def sharded_window_step(
    graph: GraphState, table, odoms, row_valid, prev_odom7, has_prev: bool, info6, points, cloud_valid, boxes,
    class_ids, probs, robot_xyzrpy, cam_angle, seg_params: dict, assoc_params: dict, lm_info3, mesh, *,
    samp_h: int = 32, samp_w: int = 32, max_planes: int = 1, num_hypotheses: int = 16, smoothing_size: int = 5,
    strict_frames: bool = True, use_rtabmap_offset: bool = False, max_iterations: int = 8, min_edges: int = 1,
    rel_tol: float = 1e-6, max_cg_iters: int = 32, adaptive_normals: bool = False,
):
    """The whole window tick over the mesh (xyz clouds): keyframe ingest,
    the frontend data-parallel over the B rows (``B % n`` is a
    ``ValueError``), the association row by row on the controller, then the
    sharded row-range solve. ``row_valid`` [B] marks the real rows, a
    prefix: the rows past it run the frontend (the ranks' shares stay
    equal) and create nothing. The arguments after ``table`` are
    ``runtime.engine._process_keyframes_window``'s (without depth input);
    the graph's pose capacity must divide the mesh size. Returns (graph,
    table, LMStats)."""
    from semantic_slam_tpu_torch.frontend import segmentation as seg_mod
    from semantic_slam_tpu_torch.runtime import engine as eng
    from semantic_slam_tpu_torch.solver import soa_dist as sd

    n, B = mesh.size, odoms.shape[0]
    if B % n:
        raise ValueError(f"the window's {B} rows must divide the mesh size {n}")
    rv = np.asarray(torch.as_tensor(row_valid).cpu(), bool)
    nv = int(rv.sum())
    if not rv[:nv].all():
        raise ValueError("row_valid must be a prefix of the window's rows")
    base = graph.num_poses
    info_rows = info6[:nv] if info6.dim() == 3 else info6
    graph = eng._ingest_keyframes_batch(graph, odoms[:nv], prev_odom7, has_prev, info_rows)
    payload = dict(points=points, cloud_valid=cloud_valid, boxes=boxes, class_ids=class_ids, probs=probs,
                   robot_xyzrpy=robot_xyzrpy, cam_angle=cam_angle)
    statics = dict(samp_h=samp_h, samp_w=samp_w, max_planes=max_planes, num_hypotheses=num_hypotheses,
                   smoothing_size=smoothing_size, strict_frames=strict_frames, adaptive_normals=adaptive_normals)
    dets = mesh.run(_window_frontend_body, payload, seg_params=dict(seg_params), statics=statics)
    dets = seg_mod.DetectedObjects(*(f[:nv] for f in dets))
    graph, table = eng._window_assoc_scan(graph, table, dets, robot_xyzrpy[:nv], base, cam_angle, assoc_params,
                                          lm_info3, strict_frames=strict_frames,
                                          use_rtabmap_offset=use_rtabmap_offset)
    D = boxes.shape[1]
    graph, stats = sd.sharded_lm_optimize_soa(
        graph, mesh, max_iterations=max_iterations, min_edges=min_edges, rel_tol=rel_tol,
        max_cg_iters=max_cg_iters, ell_rows=(1, 1, D * max_planes),
    )
    return graph, table, stats

