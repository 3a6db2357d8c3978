"""The SLAM engine: keyframe queue, tick loop, graph growth, state sync (port
of ``semantic_slam_tpu.runtime.engine``: the dense Schur LM and the SoA
Schur-PCG solver, point or plane landmarks, on one device or a mesh).

The host drives the same sequential loop as the JAX engine (keyframe gate,
latest-wins sensor pairing, queue bookkeeping, in numpy), and the device
work runs eagerly on ``device``:

  * ``_process_keyframe``  -- node + odometry-edge append, frontend
    (normals, batched plane extraction), association, landmark ingest;
  * ``_ingest_keyframes_batch`` -- a run of detection-less keyframes;
  * ``_process_keyframes_window`` -- a run of detection keyframes that share
    a sensor (window ingest, ``ingest_window > 1``, which pools W keyframes
    a tick): the frontend once over the run (``segmentation.segment_window``,
    one plane extraction over its B*D detections), then association and
    landmark ingest row by row (``_window_assoc_scan``);
  * ``segment_keyframe`` -- the frontend alone (``_segment_only``) re-run
    on a stored keyframe after the session (the viz bag's detections);
  * ``_optimize_tick``     -- the LM (dense Schur, or with
    ``linear_solver="pcg"`` the SoA Schur-PCG solver: up to K=4096 poses the
    resident loop of ``solver/ellk_soa.py`` with kernels K1-K4, above it the
    row-range loop of ``solver/soa_dist.py`` with kernels K6-K10, see
    ``_soa_dispatch``), landmark marginals, table sync, and the packed
    ``info`` vector that the host fetches once;
  * plane landmarks (``use_plane_landmarks``, ``_process_keyframe_planes``
    and ``_optimize_tick_planes``): each landmark is also a planar patch in
    ``self.plane_nodes`` (plane index == landmark id), observed by an
    SE3-plane edge from every keyframe that sees it. The tick solves poses,
    points and planes jointly: the dense plane LM (``graph/planes.py``), or
    with ``linear_solver="pcg"`` the row-range loop's plane half
    (``soa_dist.lm_optimize_soa_planes``, kernels K6-K10) at every K, as the
    JAX engine does on the TPU (it has no resident-loop plane variant). The
    ``info`` vector's slots 5 and 7 then carry the plane and plane-edge
    counts, and the host mirrors read them as the JAX engine's do;
  * ``_maybe_marginalize`` -- fixed-lag smoothing (``fixed_lag_window > 0``,
    ``solver/fixed_lag.py``): once the active window holds window + chunk
    keyframes, the oldest chunk is marginalized into ``self.prior`` and the
    graph compacts; their optimized poses go to ``archived_poses`` and
    ``_kf_base`` counts them, so ``KeyframeMeta.node_idx`` stays the
    keyframe's number in the session. The prior goes to every optimize while
    the window is set, even while it is still empty;
  * autosave -- every ``autosave_every_n_ticks`` ticks the tick ends in
    ``io.checkpoint.save_checkpoint`` to ``cfg.autosave_path``. A restored
    session's keyframes carry no cloud (``cloud=None``). A keyframe's cloud
    is the engine's own copy of the arrays ``set_point_cloud`` was given.

Odometry edges carry the constant information matrix, or with
``use_const_inf_matrix=False`` one fitness-weighted matrix each
(``_edge_info6``, formed on the device). ``pcg_precond="tridiag"`` swaps the
PCG loops' block-Jacobi preconditioner for the odometry chain's block
tridiagonal (``ellk_soa.soa_schur_step_tridiag`` in K4's place on the
resident loop; the row-range loop's ``precond_kind``).

Host traffic per tick: two flags per LM iteration and the ``info`` vector,
and one small fetch per marginalization (with ``--precond tridiag`` also a
flag every 8 CG steps).
The reference's optimize gate (at least ``min_edges`` edges) is decided on
the host from the count mirrors; only while they are below the gate does
the solver fetch the edge count.

Several ranks (``MeshConfig.num_devices = n > 1``, the JAX engine's mesh):
the constructor opens a mesh of n ranks (``parallel/dist.py``: this process
is rank 0, n - 1 workers; NCCL over ``cuda:0..n-1`` on the card, gloo ranks
with ``device="cpu"``, or a mesh the caller passes), forces
``linear_solver="pcg"`` and rounds the pose and edge capacities up to a
multiple of n (doubling keeps them so). Every optimize then takes the
row-range loop over the ranks' pose rows (``soa_dist.sharded_lm_optimize_soa``
and ``_planes``: the per-tick point and plane solves, the window flush, the
fixed-lag solve with the prior replicated) at every K and preconditioner;
the frontend, the association and the marginalization stay on rank 0.
``close()`` stops the workers of a mesh the engine opened (the CLI calls it
when the session ends; an open mesh also stops at interpreter exit). Method
names match the JAX engine, since ``io.replay`` drives either engine by duck
typing.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import numpy as np
import torch

from semantic_slam_tpu_torch.assoc import association as assoc_mod
from semantic_slam_tpu_torch.config import CLASS_TO_ID, PLANE_VERTICAL, SlamConfig
from semantic_slam_tpu_torch.core import np_geometry as npg
from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.core import frames as frames_mod
from semantic_slam_tpu_torch.frontend import depth as depth_mod
from semantic_slam_tpu_torch.frontend import segmentation as seg_mod
from semantic_slam_tpu_torch.graph import planes as planes_mod
from semantic_slam_tpu_torch.graph import state as gs
from semantic_slam_tpu_torch.graph.state import set_rows
from semantic_slam_tpu_torch.runtime.keyframe_gate import KeyframeGate
from semantic_slam_tpu_torch.solver import ellk_soa as soa_mod
from semantic_slam_tpu_torch.solver import fixed_lag as fl
from semantic_slam_tpu_torch.solver import information as info_mod
from semantic_slam_tpu_torch.solver import lm as lm_mod
from semantic_slam_tpu_torch.solver import soa_dist as soa_dist_mod
from semantic_slam_tpu_torch.utils.profiling import log_optimize

Tensor = torch.Tensor


@dataclasses.dataclass
class KeyframeMeta:
    stamp: float
    odom: np.ndarray  # pose7
    robot_pose: np.ndarray  # pose7 snapshot at creation
    accum_distance: float
    cloud: tuple[np.ndarray, np.ndarray | None] | None  # host (points [H,W,3], valid)
    boxes: np.ndarray | None  # [D,4]
    class_ids: np.ndarray | None
    probs: np.ndarray | None
    node_idx: int | None = None
    # depth-image mode: cloud holds ([H,W] u16 depth, None) and these are set
    depth_intr: np.ndarray | None = None  # [4] (fx, fy, cx, cy)
    depth_scale: float = 1e-3


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _soa_dispatch(K: int) -> str:
    """The single-device PCG loop for a graph of capacity K (the JAX
    engine's ``_soa_dispatch`` without its TPU-only cuts): ``"soa"``, the
    resident loop (kernels K1-K4), up to ``soa_dist.TILED_FROM_K`` poses;
    ``"tiled"``, the row-range loop (K6-K10), above."""
    return "soa" if K <= soa_dist_mod.TILED_FROM_K else "tiled"


def _ingest_keyframes_batch(graph: gs.GraphState, odoms: Tensor, prev_odom7: Tensor, has_prev: bool, info6: Tensor):
    """Append a run of B keyframe nodes ``odoms [B,7]`` and the odometry
    chain edges ``prev^-1 * odom`` (semantic_graph_slam.cpp:104-150); row 0
    gets no edge when the graph was empty. ``info6`` is one [6,6] matrix for
    every edge, or one [B,6,6] per row (fitness information)."""
    B = odoms.shape[0]
    dev = odoms.device
    tgt = graph.num_poses + torch.arange(B, device=dev)
    prevs = torch.cat([prev_odom7[None], odoms[:-1]])
    meas = geo.pose_mul(geo.pose_inv(prevs), odoms)
    first = 0 if has_prev else 1
    n_e = B - first
    if info6.dim() == 3:
        info6 = info6[first:]
    e_tgt = graph.num_odom + torch.arange(n_e, device=dev)
    return graph.replace(
        poses=set_rows(graph.poses, tgt, odoms),
        num_poses=graph.num_poses + B,
        odom_i=set_rows(graph.odom_i, e_tgt, (tgt[first:] - 1).to(torch.int32)),
        odom_j=set_rows(graph.odom_j, e_tgt, tgt[first:].to(torch.int32)),
        odom_meas=set_rows(graph.odom_meas, e_tgt, meas[first:]),
        odom_info=set_rows(graph.odom_info, e_tgt, info6),
        num_odom=graph.num_odom + n_e,
    )


def _ingest_landmarks(graph: gs.GraphState, valid, lm_id, is_new, local, world, kf_idx, info3):
    """Masked append of landmark nodes + observation edges. Association
    assigns new ids sequentially from the table count, which equals
    graph.num_landmarks, so node indices match table ids."""
    new = valid & is_new
    node_idx = graph.num_landmarks + torch.cumsum(new.to(torch.int32), dim=0) - 1
    edge_idx = graph.num_lme + torch.cumsum(valid.to(torch.int32), dim=0) - 1
    kf_col = torch.as_tensor(kf_idx, device=valid.device).to(torch.int32)
    return graph.replace(
        landmarks=set_rows(graph.landmarks, node_idx, world, new),
        num_landmarks=graph.num_landmarks + torch.sum(new.to(torch.int32)).to(torch.int32),
        lme_k=set_rows(graph.lme_k, edge_idx, kf_col, valid),
        lme_l=set_rows(graph.lme_l, edge_idx, lm_id.to(torch.int32), valid),
        lme_meas=set_rows(graph.lme_meas, edge_idx, local, valid),
        lme_info=set_rows(graph.lme_info, edge_idx, info3, valid),
        num_lme=graph.num_lme + torch.sum(valid.to(torch.int32)).to(torch.int32),
    )


def _ingest_planes(pn: planes_mod.PlaneNodes, valid, lm_id, is_new, plane_w4, meas4, kf_idx, info3):
    """Masked append of plane nodes and SE3-plane edges (plane index ==
    the table's landmark id, as for the point nodes)."""
    new = valid & is_new
    node_idx = pn.num_planes + torch.cumsum(new.to(torch.int32), dim=0) - 1
    edge_idx = pn.num_pe + torch.cumsum(valid.to(torch.int32), dim=0) - 1
    kf_col = torch.as_tensor(kf_idx, device=valid.device).to(torch.int32)
    return pn.replace(
        planes=set_rows(pn.planes, node_idx, plane_w4, new),
        num_planes=pn.num_planes + torch.sum(new.to(torch.int32)).to(torch.int32),
        pe_k=set_rows(pn.pe_k, edge_idx, kf_col, valid),
        pe_p=set_rows(pn.pe_p, edge_idx, lm_id.to(torch.int32), valid),
        pe_meas=set_rows(pn.pe_meas, edge_idx, meas4, valid),
        pe_info=set_rows(pn.pe_info, edge_idx, info3, valid),
        num_pe=pn.num_pe + torch.sum(valid.to(torch.int32)).to(torch.int32),
    )


def _process_keyframe_planes(pn, dets, res, kf_idx, robot_xyzrpy, cam_angle, lm_info3, *, strict_frames):
    """The plane-landmark part of a keyframe, after ``_process_keyframe``
    gave its detections ``dets``, their association ``res`` and the
    keyframe index: each associated detection's plane as a plane node (new
    landmarks) and an SE3-plane edge. The world plane comes from the
    detection's camera-frame plane through the cam->world chain, its offset
    through the world centroid; the observation is the camera-frame plane
    rotated into the robot (odometry node) frame, whose offset that rotation
    leaves as it is. Returns the plane nodes."""
    n_w = frames_mod.convert_normal_to_world(robot_xyzrpy, cam_angle, dets.normal_cam, strict=strict_frames)[:, :3]
    n_w = n_w / torch.clamp(torch.linalg.vector_norm(n_w, dim=-1, keepdim=True), min=1e-12)
    d_w = -torch.sum(n_w * res.world_pose, dim=-1)
    C = frames_mod.t_cam_robot(cam_angle.to(pn.planes.dtype))[:3, :3]
    n_r = dets.normal_cam[:, :3] @ C.T
    n_r = n_r / torch.clamp(torch.linalg.vector_norm(n_r, dim=-1, keepdim=True), min=1e-12)
    meas4 = torch.cat([n_r, dets.normal_cam[:, 3:4]], dim=-1)
    return _ingest_planes(pn, res.valid, res.lm_id, res.is_new, torch.cat([n_w, d_w[:, None]], dim=-1), meas4,
                          kf_idx, lm_info3)


def _segment_only(
    points, cloud_valid, cam_intr, depth_scale, boxes, class_ids, probs, robot_xyzrpy, cam_angle,
    seg_params: dict, *, samp_h, samp_w, max_planes, num_hypotheses, smoothing_size, strict_frames, depth_input,
    adaptive_normals=False,
):
    """The frontend of one keyframe, or with a leading batch dim on every
    per-keyframe input of a run of keyframes (``segmentation.segment_window``):
    (depth backprojection,) normals and the per-box plane extraction (K5 on
    the card). Returns its detections."""
    if depth_input:
        points, cloud_valid = depth_mod.backproject_depth(points, cam_intr, depth_scale)
    segment = seg_mod.segment_window if boxes.dim() == 3 else seg_mod.segment_all
    return segment(
        points, cloud_valid, boxes, class_ids, probs, robot_xyzrpy, cam_angle,
        **seg_params, samp_h=samp_h, samp_w=samp_w, max_planes=max_planes,
        num_hypotheses=num_hypotheses, smoothing_size=smoothing_size,
        strict_frames=strict_frames, adaptive_normals=adaptive_normals,
    )


def _process_keyframe(
    graph, table, odom7, prev_odom7, has_prev, info6, points, cloud_valid, cam_intr,
    depth_scale, boxes, class_ids, probs, robot_xyzrpy, cam_angle, seg_params: dict,
    assoc_params: dict, lm_info3, *, samp_h, samp_w, max_planes, num_hypotheses,
    smoothing_size, strict_frames, use_rtabmap_offset, depth_input, adaptive_normals=False,
):
    """One detection-bearing keyframe: node+edge append, (depth
    backprojection,) frontend, association, landmark ingest. Returns (graph,
    table, dets, association, keyframe index)."""
    kf_idx = graph.num_poses
    graph = _ingest_keyframes_batch(graph, odom7[None], prev_odom7, has_prev, info6)
    dets = _segment_only(
        points, cloud_valid, cam_intr, depth_scale, boxes, class_ids, probs, robot_xyzrpy, cam_angle, seg_params,
        samp_h=samp_h, samp_w=samp_w, max_planes=max_planes, num_hypotheses=num_hypotheses,
        smoothing_size=smoothing_size, strict_frames=strict_frames, depth_input=depth_input,
        adaptive_normals=adaptive_normals,
    )
    table, res = assoc_mod.associate(
        table, dets, robot_xyzrpy, cam_angle, **assoc_params,
        strict_frames=strict_frames, rtabmap_y_offset=use_rtabmap_offset,
    )
    graph = _ingest_landmarks(
        graph, res.valid, res.lm_id, res.is_new, res.local_pose, res.world_pose, kf_idx, lm_info3
    )
    return graph, table, dets, res, kf_idx


def _process_keyframes_window(
    graph, table, odoms, prev_odom7, has_prev, info6, points, cloud_valid, cam_intr, depth_scale, boxes, class_ids,
    probs, robot_xyzrpy, cam_angle, seg_params: dict, assoc_params: dict, lm_info3, *, samp_h, samp_w, max_planes,
    num_hypotheses, smoothing_size, strict_frames, use_rtabmap_offset, depth_input, adaptive_normals=False,
):
    """A run of B detection-bearing keyframes (window ingest; the JAX
    engine's ``_process_keyframes_window``): the B nodes and chain edges in
    one append (``info6`` [6,6] or [B,6,6]), the frontend once over the
    whole run (``odoms [B,7]`` and every sensor input with a leading B; one
    plane extraction over B*D detections), then association and landmark
    ingest row by row (``_window_assoc_scan``), so that landmarks created by
    row i are matchable by row i+1. B is the run's length: the JAX engine's
    power-of-two padding rows are an XLA compile-bucket device and are not
    ported. Returns (graph, table, the last row's detections)."""
    base = graph.num_poses
    graph = _ingest_keyframes_batch(graph, odoms, prev_odom7, has_prev, info6)
    dets = _segment_only(
        points, cloud_valid, cam_intr, depth_scale, boxes, class_ids, probs, robot_xyzrpy, cam_angle, seg_params,
        samp_h=samp_h, samp_w=samp_w, max_planes=max_planes, num_hypotheses=num_hypotheses,
        smoothing_size=smoothing_size, strict_frames=strict_frames, depth_input=depth_input,
        adaptive_normals=adaptive_normals,
    )
    graph, table = _window_assoc_scan(graph, table, dets, robot_xyzrpy, base, cam_angle, assoc_params, lm_info3,
                                      strict_frames=strict_frames, use_rtabmap_offset=use_rtabmap_offset)
    return graph, table, seg_mod.DetectedObjects(*(f[-1] for f in dets))


def _window_assoc_scan(graph, table, dets, robot_xyzrpy, base, cam_angle, assoc_params: dict, lm_info3, *,
                       strict_frames: bool, use_rtabmap_offset: bool):
    """The sequential tail of a window: association and landmark ingest row
    by row over ``dets`` (fields [B, M, ...]); row b is keyframe ``base +
    b``. Returns (graph, table)."""
    for b in range(dets.valid.shape[0]):
        table, res = assoc_mod.associate(
            table, seg_mod.DetectedObjects(*(f[b] for f in dets)), robot_xyzrpy[b], cam_angle, **assoc_params,
            strict_frames=strict_frames, rtabmap_y_offset=use_rtabmap_offset,
        )
        graph = _ingest_landmarks(graph, res.valid, res.lm_id, res.is_new, res.local_pose, res.world_pose,
                                  base + b, lm_info3)
    return graph, table


def _optimize_tick(
    graph, table, marginals, last_idx: int, *, do_opt: bool, init_lambda: float,
    max_iterations: int, min_edges: int, rel_tol: float, robust_kind: str,
    robust_delta: float, need_marginals: bool, linear_solver: str, pcg_iters: int,
    ell_rows: tuple, prior: fl.MarginalPrior | None = None, pcg_precond: str = "jacobi", mesh=None,
):
    """LM optimize (with the fixed-lag ``prior`` folded in, if any), marginal
    recovery, table sync, packed stats. ``pcg_precond`` picks the PCG
    loops' preconditioner (``"jacobi"`` or ``"tridiag"``); with ``mesh`` the
    solve is the sharded row-range loop. Returns (graph, table, marginals,
    info [8+7] on the device, iterations)."""
    zero = graph.poses.new_zeros(())
    stats = lm_mod.LMStats(0, zero, zero, zero)
    if do_opt:
        kw = dict(
            max_iterations=max_iterations, min_edges=min_edges, rel_tol=rel_tol,
            robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda,
            with_marginals=need_marginals,
        )
        if mesh is not None:
            out = soa_dist_mod.sharded_lm_optimize_soa(graph, mesh, max_cg_iters=pcg_iters, ell_rows=ell_rows,
                                                       prior=prior, precond_kind=pcg_precond, **kw)
        elif linear_solver == "pcg" and _soa_dispatch(graph.poses.shape[0]) == "tiled":
            out = soa_dist_mod.lm_optimize_soa_tiled(graph, max_cg_iters=pcg_iters, ell_rows=ell_rows, prior=prior,
                                                     precond_kind=pcg_precond, **kw)
        elif linear_solver == "pcg":
            out = soa_mod.lm_optimize_soa(graph, max_cg_iters=pcg_iters, ell_rows=ell_rows, prior=prior,
                                          precond_kind=pcg_precond, **kw)
        elif prior is not None:
            out = fl.lm_optimize_prior(graph, prior, **kw)
        else:
            out = lm_mod.lm_optimize(graph, **kw)
        if out[1].iterations > 0:  # the solve ran (enough edges)
            graph, stats = out[0], out[1]
            marg2 = out[2] if need_marginals else None
            # Euclidean-gating profiles never read covariances: the table
            # keeps its own (exported ones come from _export_covariances)
            has_lms = table.count > 0
            t2 = assoc_mod.sync_from_graph(table, graph.landmarks, table.cov if marg2 is None else marg2)
            table = assoc_mod.LandmarkTable(
                **{
                    f: torch.where(has_lms, getattr(t2, f), getattr(table, f))
                    for f in assoc_mod.TABLE_FIELDS
                }
            )
            if marg2 is not None:
                marginals = torch.where(has_lms, marg2, marginals)

    dtype = graph.poses.dtype
    head = torch.stack(
        [
            torch.tensor(float(stats.iterations), dtype=dtype, device=graph.poses.device),
            stats.chi2_initial.to(dtype),
            stats.chi2_final.to(dtype),
            stats.lambda_final.to(dtype),
            graph.num_poses.to(dtype),
            graph.num_landmarks.to(dtype),
            graph.num_odom.to(dtype),
            graph.num_lme.to(dtype),
        ]
    )
    info = torch.cat([head, graph.poses[last_idx]])  # + optimized last-keyframe estimate
    return graph, table, marginals, info, stats.iterations


def _optimize_tick_planes(
    graph, table, pn, last_idx: int, *, do_opt: bool, init_lambda: float, max_iterations: int, min_edges: int,
    rel_tol: float, robust_kind: str, robust_delta: float, need_marginals: bool, linear_solver: str, pcg_iters: int,
    ell_rows: tuple, prior: fl.MarginalPrior | None = None, pcg_precond: str = "jacobi", mesh=None,
):
    """The plane-landmark tick: the joint pose, point and plane LM (the
    dense plane LM, or the row-range loop's plane half with ``pcg``, over
    the ``mesh``'s ranks if given, with the fixed-lag ``prior`` folded in),
    then the point path's table sync
    with the point landmarks' marginals. Returns (graph, table, pn, info
    [8+7] on the device, iterations); info's slots 5 and 7 hold the plane
    and plane-edge counts (the JAX engine's plane tick)."""
    zero = graph.poses.new_zeros(())
    stats = lm_mod.LMStats(0, zero, zero, zero)
    if do_opt:
        kw = dict(max_iterations=max_iterations, min_edges=min_edges, rel_tol=rel_tol, robust_kind=robust_kind,
                  robust_delta=robust_delta, init_lambda=init_lambda, prior=prior)
        marg = None
        if mesh is not None or linear_solver == "pcg":
            solve = (soa_dist_mod.lm_optimize_soa_planes if mesh is None else
                     functools.partial(soa_dist_mod.sharded_lm_optimize_soa_planes, mesh=mesh))
            out = solve(graph, pn, max_cg_iters=pcg_iters, ell_rows=ell_rows, with_marginals=need_marginals,
                        precond_kind=pcg_precond, **kw)
            g2, pn2, st = out[:3]
            if need_marginals:
                marg = out[3]
        else:
            g2, pn2, st = planes_mod.lm_optimize_with_planes(graph, pn, **kw)
            if need_marginals and st.iterations > 0:
                marg = fl.landmark_marginals_prior(g2, prior) if prior is not None else lm_mod.landmark_marginals(g2)
        # below the optimize gate the solvers report the current chi2 (the
        # JAX plane tick's stats; its point tick reports zeros)
        stats = st
        if st.iterations > 0:  # the solve ran (enough edges)
            graph, pn = g2, pn2
            has_lms = table.count > 0
            t2 = assoc_mod.sync_from_graph(table, graph.landmarks, table.cov if marg is None else marg)
            table = assoc_mod.LandmarkTable(
                **{f: torch.where(has_lms, getattr(t2, f), getattr(table, f)) for f in assoc_mod.TABLE_FIELDS}
            )

    dtype = graph.poses.dtype
    head = torch.stack([
        torch.tensor(float(stats.iterations), dtype=dtype, device=graph.poses.device),
        stats.chi2_initial.to(dtype), stats.chi2_final.to(dtype), stats.lambda_final.to(dtype),
        graph.num_poses.to(dtype), pn.num_planes.to(dtype), graph.num_odom.to(dtype), pn.num_pe.to(dtype),
    ])
    return graph, table, pn, torch.cat([head, graph.poses[last_idx]]), stats.iterations


def _is_det(kf: KeyframeMeta) -> bool:
    return kf.boxes is not None and kf.cloud is not None and len(kf.boxes) > 0


def _same_sensor(a: KeyframeMeta, b: KeyframeMeta) -> bool:
    """Two detection keyframes one window may hold: the same cloud or depth
    mode and frame size, and in depth mode the same intrinsics and scale
    (the JAX engine's run break)."""
    if (a.depth_intr is None) != (b.depth_intr is None):
        return False
    if np.shape(a.cloud[0]) != np.shape(b.cloud[0]):
        return False
    if a.depth_intr is not None:
        return np.array_equal(a.depth_intr, b.depth_intr) and a.depth_scale == b.depth_scale
    return True


class SlamEngine:
    """Single-session engine; feed with ``vio_callback``/``set_*`` then ``run()``.

    ``device`` is where the graph, the table and every kernel live. A CUDA
    device that does not exist is an error: nothing falls back to the CPU.
    With ``config.mesh.num_devices = n > 1`` the engine opens a mesh of n
    ranks on ``device``'s kind (``parallel.dist.make_mesh``; fewer GPUs than
    n is a ``ValueError``), or takes ``mesh``, one the caller opened with n
    ranks and keeps (e.g. gloo ranks sharing one card).
    """

    def __init__(self, config: SlamConfig, device: str | torch.device = "cuda", mesh=None):
        if config.solver.linear_solver not in ("dense", "pcg"):
            raise ValueError(f"linear_solver must be 'dense' or 'pcg', got {config.solver.linear_solver!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but torch sees no CUDA device")
        n_mesh = config.mesh.num_devices
        if mesh is not None and mesh.size != n_mesh:
            raise ValueError(f"MeshConfig.num_devices={n_mesh} but the mesh given has {mesh.size} ranks")
        self._mesh, self._owns_mesh = mesh, mesh is None
        if n_mesh > 1:
            if mesh is None:
                from semantic_slam_tpu_torch.parallel import dist as dist_mod

                # raises ValueError, naming both counts, before anything is allocated
                dist_mod.mesh_devices(n_mesh, self.device.type)
            if config.solver.linear_solver != "pcg":
                # the sharded solver is the matrix-free PCG (the JAX engine's rule)
                if config.verbose:
                    print("[mesh] linear_solver forced to 'pcg' for multi-chip")
                config = config.replace(solver=dataclasses.replace(config.solver, linear_solver="pcg"))
        self.cfg = config
        self.dtype = torch.float64 if config.solver.dtype == "float64" else torch.float32
        self._npdt = np.float64 if config.solver.dtype == "float64" else np.float32
        dev, dt = self.device, self.dtype

        cap = config.capacity
        k0 = min(cap.initial_keyframes or cap.max_keyframes, cap.max_keyframes)
        l0 = min(cap.initial_landmarks or cap.max_landmarks, cap.max_landmarks)
        e10 = min(cap.initial_odom_edges or cap.max_odom_edges, cap.max_odom_edges)
        e20 = min(cap.initial_landmark_edges or cap.max_landmark_edges, cap.max_landmark_edges)
        if n_mesh > 1:
            # the ranks split the pose rows (and a merge's edges) evenly;
            # capacity doubling keeps the multiples
            k0, e10, e20 = _round_up(k0, n_mesh), _round_up(e10, n_mesh), _round_up(e20, n_mesh)
        # the JAX engine's point sessions keep plane nodes of these sizes
        # (its checkpoints' host state names them)
        self._plane_caps0 = (l0, e20)
        self.graph = gs.make_graph(k0, l0, e10, e20, dtype=dt, device=dev)
        self.table = assoc_mod.make_table(l0, dtype=dt, device=dev)
        # plane-landmark sessions: plane nodes sized like the landmark table
        # (plane index == landmark id); None in point-landmark sessions
        self.plane_nodes = planes_mod.make_planes(l0, e20, dtype=dt, device=dev) if config.use_plane_landmarks else None
        self.marginals = torch.eye(3, dtype=dt, device=dev).repeat(l0, 1, 1)
        self.gate = KeyframeGate(
            config.keyframe.delta_trans, config.keyframe.delta_angle, config.keyframe.delta_time
        )

        ident = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
        self.robot_pose = ident.copy()
        self.vio_pose = ident.copy()
        self.prev_odom = ident.copy()
        self.map2odom = ident.copy()
        self.first_key_added = False

        self._cloud: tuple[np.ndarray, np.ndarray | None] | None = None
        self._cloud_owned = False  # _cloud is the engine's own copy
        self._cloud_depth_meta: tuple[np.ndarray, float] | None = None
        self._dets: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self._det_available = False

        self.keyframe_queue: list[KeyframeMeta] = []
        self.keyframes: list[KeyframeMeta] = []

        # fixed-lag smoothing state (used when fixed_lag_window > 0)
        self.prior = fl.empty_prior(l0, Pl=l0 if config.use_plane_landmarks else 0, dtype=dt, device=dev)
        self._kf_base = 0  # keyframes marginalized out of the graph so far
        self.archived_poses: list[np.ndarray] = []  # their poses at drop time

        self._export_marg = None
        self._export_marg_tick = -1
        # finalize() sets it to flush a partial ingest window
        self._flush_pending = False
        # window rows a frontend call may hold: K5's grid takes at most 65535
        # detections (frontend/kernels.py)
        self._max_window_rows = max(1, 65535 // config.capacity.max_detections_per_frame)
        # ticks run by this engine; not checkpointed (nor in the JAX package),
        # so optimize_every_n_ticks counts from 0 again after a resume
        self._ticks_done = 0
        self._last_lambda = 0.0

        # host mirrors of device counts, refreshed by the per-tick info fetch
        self._n_poses = 0
        self._n_landmarks = 0
        self._n_odom = 0
        self._n_lme = 0

        self.robot_traj: list[tuple[float, np.ndarray]] = []
        self.vio_traj: list[tuple[float, np.ndarray]] = []
        self.stats_history: list[dict[str, Any]] = []
        self.last_detected_objects = None

        inf = config.information
        self._info6 = torch.diag(
            torch.tensor([1.0 / inf.const_stddev_x] * 3 + [1.0 / inf.const_stddev_q] * 3, dtype=dt, device=dev)
        )
        self._lm_info3 = torch.eye(3, dtype=dt, device=dev) / config.association.land_noise_low
        seg = config.segmentation
        a = config.association
        # scalar parameters stay host floats: compared against dtype tensors
        # they round to the engine dtype, as the JAX engine's staged scalars do
        self._seg_params = {
            "num_point_seg": float(self._npdt(seg.num_point_seg)),
            "norm_point_thres": float(self._npdt(seg.norm_point_thres)),
            "planar_area": float(self._npdt(seg.planar_area)),
            "distance_thres": float(self._npdt(seg.distance_thres)),
            "cos_angular_thres": float(self._npdt(np.cos(np.deg2rad(seg.angular_thres_deg)))),
        }
        self._assoc_params = {
            "use_maha": bool(a.use_maha_dist),
            "maha_thres": float(self._npdt(a.maha_dist_thres)),
            "eq_thres": float(self._npdt(a.eq_dist_thres)),
            "land_noise": float(self._npdt(a.land_noise_low)),
            "use_plane_gate": bool(a.use_plane_gate),
            "plane_cos_thres": float(self._npdt(np.cos(np.deg2rad(a.plane_angle_thres_deg)))),
            "plane_offset_thres": float(self._npdt(a.plane_offset_thres)),
        }
        self._cam_angle = torch.tensor(config.camera_angle_rad, dtype=dt, device=dev)

        if config.add_first_lan:
            self.add_first_pose_and_landmark()
        if n_mesh > 1 and self._mesh is None:
            from semantic_slam_tpu_torch.parallel import dist as dist_mod

            self._mesh = dist_mod.make_mesh(n_mesh, device=self.device.type)

    def close(self) -> None:
        """Stop the workers of the mesh the engine opened (a no-op on one
        device, and for a mesh the caller passed); the engine solves on no
        mesh after it."""
        if self._owns_mesh and self._mesh is not None:
            self._mesh.close()

    def _tensor(self, a, dtype=None) -> Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype or self.dtype)

    # ------------------------------------------------------------------
    # sensor ingestion (latest-wins, semantic_graph_slam.cpp:342-364)
    # ------------------------------------------------------------------

    def set_point_cloud(self, points, valid) -> None:
        self._cloud = (np.asarray(points), np.asarray(valid))
        self._cloud_owned = False
        self._cloud_depth_meta = None

    def set_depth_image(self, depth, intrinsics, depth_scale: float = 1e-3) -> None:
        self._cloud = (np.asarray(depth, np.uint16), None)
        self._cloud_owned = False
        self._cloud_depth_meta = (np.asarray(intrinsics, np.float64), float(depth_scale))

    def set_detections(self, boxes: np.ndarray, class_ids: np.ndarray, probs: np.ndarray) -> None:
        self._dets = (np.asarray(boxes), np.asarray(class_ids), np.asarray(probs))
        self._det_available = True

    def vio_callback(self, stamp: float, odom7: np.ndarray, odom_cov: np.ndarray | None = None) -> None:
        """Gated keyframe creation (semantic_graph_slam.cpp:234-287)."""
        odom7 = np.asarray(odom7, np.float64)
        gate_hit = self.gate.update(odom7, stamp)
        det_trigger = self.cfg.update_key_using_det and self._det_available
        if not gate_hit and not det_trigger:
            if self.first_key_added:
                inc = npg.pose_mul(npg.pose_inv(self.prev_odom), odom7)
                self.robot_pose = npg.pose_mul(self.robot_pose, inc)
            self.vio_pose = odom7
            self.prev_odom = odom7
            self._record_traj(stamp)
            return

        if self._cloud is not None and not self._cloud_owned:
            # a keyframe keeps its cloud past the replay, and the caller's
            # arrays may be views into a reader's mapped file (io.replay
            # replay_slog): copy them once, when a keyframe first takes them
            self._cloud = tuple(None if a is None else np.array(a) for a in self._cloud)
            self._cloud_owned = True
        cloud = self._cloud  # latest-wins; kept even when stale (:264-265)
        if self._det_available and self._dets is not None:
            boxes, cids, probs = self._dets
            self._det_available = False
        else:
            boxes = cids = probs = None

        dm = self._cloud_depth_meta
        self.keyframe_queue.append(
            KeyframeMeta(
                stamp=stamp,
                odom=odom7.copy(),
                robot_pose=self.robot_pose.copy(),
                accum_distance=self.gate.accum_distance,
                cloud=cloud,
                boxes=boxes,
                class_ids=cids,
                probs=probs,
                depth_intr=None if dm is None else dm[0],
                depth_scale=1e-3 if dm is None else dm[1],
            )
        )
        self.vio_pose = odom7
        self.prev_odom = odom7
        self.first_key_added = True
        self._record_traj(stamp)

    def _record_traj(self, stamp: float) -> None:
        self.robot_traj.append((stamp, self.robot_pose.copy()))
        self.vio_traj.append((stamp, self.vio_pose.copy()))

    # ------------------------------------------------------------------
    # the tick (semantic_graph_slam.cpp:58-102)
    # ------------------------------------------------------------------

    def _ell_rows(self, planes: bool = False) -> tuple:
        """Static per-pose edge-count bounds of the ELL layout
        (``solver.pcg.build_slots``): the engine appends edges in keyframe
        order, one odometry edge per side and at most
        ``max_detections_per_frame * max_planes_per_detection`` landmark (and
        plane) edges per keyframe; marginalization keeps both invariants."""
        mpd = self.cfg.capacity.max_detections_per_frame * self.cfg.segmentation.max_planes_per_detection
        return (1, 1, mpd, mpd) if planes else (1, 1, mpd)

    def _opt_statics(self) -> dict:
        s = self.cfg.solver
        # edges only grow, so the mirrors (this tick's odometry edges, last
        # tick's observation edges) bound the count from below: once they
        # reach the gate, lm_optimize need not fetch the count
        gate_passed = self._n_odom + self._n_lme >= s.min_edges_to_optimize
        return dict(
            max_iterations=s.max_iterations,
            min_edges=0 if gate_passed else s.min_edges_to_optimize,
            rel_tol=s.rel_decrease_tol,
            robust_kind=s.robust_kernel,
            robust_delta=s.robust_delta,
            # eq-gating never reads landmark covariances: skip the recovery
            need_marginals=bool(self.cfg.association.use_maha_dist),
            linear_solver=s.linear_solver,
            pcg_iters=s.pcg_iters,
            pcg_precond=s.pcg_precond,
            ell_rows=self._ell_rows(planes=self.cfg.use_plane_landmarks),
            prior=self._prior_arg(),
            mesh=self._mesh,
        )

    def _prior_arg(self) -> fl.MarginalPrior | None:
        """The prior for the optimize calls: None when fixed-lag is off."""
        return self.prior if self.cfg.solver.fixed_lag_window > 0 else None

    def run(self) -> bool:
        if not self.keyframe_queue:
            return False
        w = self.cfg.solver.ingest_window
        if w > 1 and not self._flush_pending and len(self.keyframe_queue) < w:
            # offline-throughput mode: keyframes pool until a whole window is
            # queued, so that its detection keyframes share one frontend call
            # (finalize() flushes a partial window)
            return False
        n = min(len(self.keyframe_queue), max(self.cfg.capacity.max_keyframes_per_update, w))
        batch, self.keyframe_queue = self.keyframe_queue[:n], self.keyframe_queue[n:]

        self._ensure_capacity(batch)

        n_opt = max(1, self.cfg.solver.optimize_every_n_ticks)
        do_opt = self._ticks_done % n_opt == 0
        self._ticks_done += 1
        init_lam = self._last_lambda if self.cfg.solver.warm_start_lambda else 0.0

        t0 = time.perf_counter()
        # plane-landmark sessions take detection keyframes one by one, as the
        # JAX engine does (it has no plane window program)
        max_rows = 1 if self.cfg.use_plane_landmarks else self._max_window_rows
        i = 0
        while i < len(batch):
            kf = batch[i]
            has_prev = len(self.keyframes) > 0
            prev_odom = self.keyframes[-1].odom if has_prev else kf.odom
            if _is_det(kf):
                # contiguous run of detection keyframes that share a sensor ->
                # one window: the frontend once over the whole run
                j = i + 1
                while j < min(len(batch), i + max_rows) and _is_det(batch[j]) and _same_sensor(kf, batch[j]):
                    j += 1
                run = batch[i:j]
                if len(run) == 1:
                    self._process_keyframe_with_detections(kf, prev_odom, has_prev)
                else:
                    self._process_keyframe_window(run, prev_odom, has_prev)
            else:
                # contiguous run of detection-less keyframes -> one batched append
                j = i
                while j < len(batch) and not _is_det(batch[j]):
                    j += 1
                run = batch[i:j]
                self.graph = _ingest_keyframes_batch(
                    self.graph,
                    self._tensor(np.stack([r.odom for r in run])),
                    self._tensor(prev_odom),
                    has_prev,
                    self._run_info6(run),
                )
            for b, r in enumerate(run):
                r.node_idx = self._n_poses + self._kf_base
                self._n_poses += 1
                if has_prev or b > 0:
                    self._n_odom += 1
                self.keyframes.append(r)
            i += len(run)

        info, iters = self._tick_optimize(do_opt, init_lam)
        info = info.cpu().numpy().astype(np.float64)  # the tick's device->host fetch
        solve_s = time.perf_counter() - t0
        self._absorb_info(info, iters)

        if iters > 0:
            # clamp: a stalled tick exits with lambda > 1e12, which would
            # otherwise poison subsequent warm-started solves
            self._last_lambda = min(float(info[3]), 1e6)

        class _S:
            iterations = iters
            chi2_initial = info[1]
            chi2_final = info[2]

        log_optimize(
            self.cfg.verbose, _S, solve_s,
            self._n_poses + self._n_landmarks, self._n_odom + self._n_lme,
        )
        self._record_stats(iters, info, solve_s)
        self.first_key_added = True
        self._maybe_marginalize()
        n_auto = self.cfg.autosave_every_n_ticks
        if n_auto > 0 and self._ticks_done % n_auto == 0:
            from semantic_slam_tpu_torch.io.checkpoint import save_checkpoint

            save_checkpoint(self.cfg.autosave_path, self)
        return True

    def _tick_optimize(self, do_opt: bool, init_lam: float):
        """The tick's optimize program, point or plane landmarks: (info on
        the device, iterations)."""
        last_idx = self.keyframes[-1].node_idx - self._kf_base
        if self.cfg.use_plane_landmarks:
            self.graph, self.table, self.plane_nodes, info, iters = _optimize_tick_planes(
                self.graph, self.table, self.plane_nodes, last_idx, do_opt=do_opt, init_lambda=init_lam,
                **self._opt_statics(),
            )
        else:
            self.graph, self.table, self.marginals, info, iters = _optimize_tick(
                self.graph, self.table, self.marginals, last_idx, do_opt=do_opt, init_lambda=init_lam,
                **self._opt_statics(),
            )
        return info, iters

    def _absorb_info(self, info: np.ndarray, iters: int) -> None:
        self._n_poses = int(info[4])
        self._n_landmarks = int(info[5])
        self._n_odom = int(info[6])
        self._n_lme = int(info[7])
        if iters > 0:
            est = info[8:15]
            self.robot_pose = est.copy()
            self.map2odom = npg.pose_mul(est, npg.pose_inv(self.keyframes[-1].odom))

    def _record_stats(self, iters: int, info: np.ndarray, seconds: float) -> None:
        self.stats_history.append(
            {
                "iterations": iters,
                "chi2_initial": float(info[1]),
                "chi2_final": float(info[2]),
                "solve_seconds": seconds,
                "num_poses": self._n_poses,
                "num_landmarks": self._n_landmarks,
                "num_edges": self._n_odom + self._n_lme,
            }
        )

    def finalize(self) -> bool:
        """Drain the queue (a partial ingest window too), then force one
        optimize pass over the current graph (for ``optimize_every_n_ticks >
        1`` or ``ingest_window > 1`` sessions; a no-op on an empty graph)."""
        if self.keyframe_queue:
            self._flush_pending = True
            try:
                while self.keyframe_queue:
                    self.run()
            finally:
                self._flush_pending = False
        if not self.keyframes:
            return False
        t0 = time.perf_counter()
        info, iters = self._tick_optimize(True, 0.0)
        info = info.cpu().numpy().astype(np.float64)
        self._absorb_info(info, iters)
        self._record_stats(iters, info, time.perf_counter() - t0)
        return iters > 0

    # ------------------------------------------------------------------

    def _frontend_host(self, kf: KeyframeMeta) -> dict:
        """One detection keyframe's per-keyframe frontend inputs on the host,
        padded to the profile's D detections, in the engine's dtypes."""
        D = self.cfg.capacity.max_detections_per_frame
        boxes = np.zeros((D, 4), np.float64)
        cids = np.full((D,), -1, np.int32)
        probs = np.zeros((D,), np.float64)
        nd = min(len(kf.boxes), D)
        boxes[:nd] = kf.boxes[:nd]
        cids[:nd] = kf.class_ids[:nd]
        probs[:nd] = kf.probs[:nd]
        points, valid = kf.cloud
        depth = kf.depth_intr is not None
        return dict(
            points=np.asarray(points) if depth else np.asarray(points, self._npdt),  # u16 depth: widened on the device
            cloud_valid=None if depth else np.asarray(valid, bool),
            boxes=boxes.astype(self._npdt),
            class_ids=cids,
            probs=probs.astype(self._npdt),
            robot_xyzrpy=npg.pose_to_xyzrpy(kf.robot_pose).astype(self._npdt),
        )

    def _frontend_args(self, kfs: KeyframeMeta | list[KeyframeMeta]) -> tuple[dict, dict]:
        """The frontend's inputs for one detection keyframe, or stacked for a
        run of them that share a sensor (a window), from their stored clouds,
        boxes and ``robot_pose`` snapshots: (tensors, statics), the keyword
        arguments of ``_segment_only``. A run's arrays are stacked on the host
        and go to the device once."""
        one = isinstance(kfs, KeyframeMeta)
        run = [kfs] if one else kfs
        hosts = [self._frontend_host(k) for k in run]
        kf = run[0]
        seg = self.cfg.segmentation
        depth_input = kf.depth_intr is not None

        def put(key, dtype=None):
            if hosts[0][key] is None:
                return None
            return self._tensor(hosts[0][key] if one else np.stack([h[key] for h in hosts]), dtype)

        tensors = dict(
            points=put("points", torch.int32 if depth_input else None),
            cloud_valid=put("cloud_valid", torch.bool),
            cam_intr=self._tensor(kf.depth_intr.astype(self._npdt)) if depth_input else None,
            depth_scale=self._tensor(self._npdt(kf.depth_scale)) if depth_input else None,
            boxes=put("boxes"),
            class_ids=put("class_ids", torch.int32),
            probs=put("probs"),
            robot_xyzrpy=put("robot_xyzrpy"),
            cam_angle=self._cam_angle, seg_params=self._seg_params,
        )
        statics = dict(
            samp_h=seg.crop_height,
            samp_w=seg.crop_width,
            max_planes=seg.max_planes_per_detection,
            num_hypotheses=seg.num_hypotheses,
            smoothing_size=seg.normal_smoothing_size,
            strict_frames=self.cfg.strict_reference_frames,
            depth_input=depth_input,
            adaptive_normals=seg.adaptive_normals,
        )
        return tensors, statics

    def _edge_info6(self, kf: KeyframeMeta, prev: KeyframeMeta | None) -> Tensor:
        """The odometry information of the edge ``prev`` -> ``kf``: the
        constant matrix (the reference's default), or with
        ``use_const_inf_matrix=False`` the fitness-weighted matrix from the
        two keyframes' clouds (``solver/information.py``; the constant when
        either keyframe lacks an xyz cloud, depth-image mode included). The
        JAX engine fetches the score to form the matrix on the host; here it
        is formed on the device, so the tick keeps its one fetch."""
        inf = self.cfg.information
        if (
            inf.use_const_inf_matrix or prev is None or prev.cloud is None or kf.cloud is None
            or kf.depth_intr is not None or prev.depth_intr is not None
        ):
            return self._info6
        S = inf.fitness_samples

        def sub(cloud):
            # the strided subsample on the host: S points go to the device
            pts, valid = (np.asarray(a) for a in cloud)
            idx = info_mod.subsample_index(valid.size, S, self._npdt)
            return (self._tensor(pts.reshape(-1, 3)[idx].astype(self._npdt)),
                    self._tensor(valid.reshape(-1)[idx].astype(self._npdt)))

        rel = npg.pose_mul(npg.pose_inv(prev.odom), kf.odom)
        score = info_mod.fitness_score_sub(*sub(prev.cloud), *sub(kf.cloud), self._tensor(rel.astype(self._npdt)),
                                           max_range=inf.fitness_max_range)
        return info_mod.fitness_info6(score, inf.var_gain_a, inf.min_stddev_x, inf.max_stddev_x,
                                        inf.min_stddev_q, inf.max_stddev_q, inf.fitness_score_thresh, self.dtype)

    def _run_info6(self, run: list[KeyframeMeta]) -> Tensor:
        """The odometry information of a run's edges: the constant [6,6], or
        with fitness information one [B,6,6] matrix a row, row b's edge
        pairing row b-1 (row 0 the last keyframe ingested)."""
        if self.cfg.information.use_const_inf_matrix:
            return self._info6
        prevs = [self.keyframes[-1] if self.keyframes else None] + run[:-1]
        return torch.stack([self._edge_info6(r, p) for r, p in zip(run, prevs)])

    def _process_keyframe_with_detections(self, kf: KeyframeMeta, prev_odom, has_prev: bool) -> None:
        cfg = self.cfg
        fa, statics = self._frontend_args(kf)
        self.graph, self.table, dets, res, kf_idx = _process_keyframe(
            self.graph, self.table,
            odom7=self._tensor(kf.odom.astype(self._npdt)),
            prev_odom7=self._tensor(np.asarray(prev_odom, self._npdt)),
            has_prev=has_prev, info6=self._edge_info6(kf, self.keyframes[-1] if self.keyframes else None),
            assoc_params=self._assoc_params, lm_info3=self._lm_info3,
            use_rtabmap_offset=cfg.association.use_rtab_map_odom, **fa, **statics,
        )
        if cfg.use_plane_landmarks:
            self.plane_nodes = _process_keyframe_planes(
                self.plane_nodes, dets, res, kf_idx, fa["robot_xyzrpy"], self._cam_angle, self._lm_info3,
                strict_frames=cfg.strict_reference_frames)
        self.last_detected_objects = dets  # observability (seg_obj_vec_)

    def _process_keyframe_window(self, run: list[KeyframeMeta], prev_odom, has_prev: bool) -> None:
        """A run of detection keyframes that share a sensor, as one window
        (``_process_keyframes_window``)."""
        fa, statics = self._frontend_args(run)
        self.graph, self.table, dets = _process_keyframes_window(
            self.graph, self.table,
            odoms=self._tensor(np.stack([k.odom for k in run]).astype(self._npdt)),
            prev_odom7=self._tensor(np.asarray(prev_odom, self._npdt)),
            has_prev=has_prev, info6=self._run_info6(run), assoc_params=self._assoc_params,
            lm_info3=self._lm_info3, use_rtabmap_offset=self.cfg.association.use_rtab_map_odom, **fa, **statics,
        )
        self.last_detected_objects = dets  # observability (seg_obj_vec_)

    def segment_keyframe(self, kf: KeyframeMeta) -> dict | None:
        """Re-run the frontend for one stored keyframe (post-hoc viz/debug).

        Reproduces the detections as they were computed at processing time
        (the ``robot_pose`` snapshot is stored on the keyframe), without any
        hot-path cost: the reference's per-frame ``publishDetectedLandmarks``
        stream (``semantic_graph_slam_ros.cpp:305-347``) is regenerated from
        the kept clouds instead of being fetched per tick. Returns None for
        detection-less keyframes, else host arrays (one fetch).
        """
        if kf.boxes is None or kf.cloud is None or len(kf.boxes) == 0:
            return None
        fa, statics = self._frontend_args(kf)
        dets = _segment_only(**fa, **statics)
        M = dets.valid.shape[0]
        packed = torch.cat([dets.valid[:, None].to(dets.world_pose.dtype),
                            dets.class_id[:, None].to(dets.world_pose.dtype),
                            dets.plane_type[:, None].to(dets.world_pose.dtype), dets.world_pose], dim=1)
        host = packed.cpu().numpy().reshape(M, 6)
        return {
            "valid": host[:, 0] > 0,
            "class_id": host[:, 1].astype(np.int32),
            "plane_type": host[:, 2].astype(np.int32),
            "world_pose": host[:, 3:].copy(),
        }

    def add_first_pose_and_landmark(self) -> None:
        """Synthetic seed (semantic_graph_slam.cpp:289-332): identity keyframe
        + fixed 'bucket'/vertical landmark with 0.1 covariance."""
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        pose = np.array([cfg.first_lan_x, cfg.first_lan_y, cfg.first_lan_z])
        t = self.table
        one = torch.zeros((), dtype=torch.int64, device=dev)
        self.table = t.replace(
            world=set_rows(t.world, one, self._tensor(pose.astype(self._npdt))),
            cov=set_rows(t.cov, one, torch.eye(3, dtype=dt, device=dev) * 0.1),
            class_id=set_rows(t.class_id, one, torch.tensor(CLASS_TO_ID["bucket"], dtype=torch.int32, device=dev)),
            plane_type=set_rows(t.plane_type, one, torch.tensor(PLANE_VERTICAL, dtype=torch.int32, device=dev)),
            normal=set_rows(t.normal, one, self._tensor(np.array([-0.4, 0.86, 0.0, 0.0], self._npdt))),
            count=torch.ones((), dtype=torch.int32, device=dev),
        )
        ident = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
        ident_t = self._tensor(ident.astype(self._npdt))
        self.graph = _ingest_keyframes_batch(self.graph, ident_t[None], ident_t, False, self._info6)
        self.keyframes.append(
            KeyframeMeta(
                stamp=0.0, odom=ident, robot_pose=ident, accum_distance=0.0,
                cloud=None, boxes=None, class_ids=None, probs=None, node_idx=0,
            )
        )
        pose_t = self._tensor(pose[None, :].astype(self._npdt))
        true1 = torch.ones((1,), dtype=torch.bool, device=dev)
        self.graph = _ingest_landmarks(
            self.graph, true1, torch.zeros((1,), dtype=torch.int32, device=dev), true1,
            pose_t, pose_t, 0, torch.eye(3, dtype=dt, device=dev) / 0.1,
        )
        self._n_poses = 1
        self._n_landmarks = 1
        self._n_lme = 1

    def _maybe_marginalize(self) -> None:
        """Fixed-lag trigger: once the active window holds window + chunk
        keyframes, marginalize the oldest ``chunk`` into the prior and compact
        the graph (``solver/fixed_lag.py``). The dropped keyframes' optimized
        poses are archived first, so exported trajectories stay complete. One
        host fetch per marginalization: the dropped poses and the new counts."""
        W = self.cfg.solver.fixed_lag_window
        if W <= 0:
            return
        C = self.cfg.solver.fixed_lag_chunk or max(8, W // 4)
        while self._n_poses >= W + C:
            dropped = self.graph.poses[:C]
            if self.cfg.use_plane_landmarks:
                self.graph, self.plane_nodes, self.prior, num_b = fl.marginalize_planes(
                    self.graph, self.plane_nodes, self.prior, C)
            else:
                self.graph, self.prior, num_b = fl.marginalize(self.graph, self.prior, C)
            g = self.graph
            counts = torch.stack([g.num_odom, g.num_lme, num_b]).to(torch.float64)
            host = torch.cat([dropped.reshape(-1).to(torch.float64), counts]).cpu().numpy()
            self.archived_poses.extend(host[: 7 * C].reshape(C, 7))
            n_odom, n_lme, n_b = (int(x) for x in host[7 * C:])
            if n_b > self.prior.max_poses:
                print(f"[fixed_lag] WARNING: boundary poses {n_b} exceed prior capacity "
                      f"{self.prior.max_poses}; information truncated")
            self._kf_base += C
            self._n_poses -= C
            # the graph's counts, in plane-landmark sessions too (as the JAX
            # engine; the next tick's info fetch brings the plane-edge count)
            self._n_odom, self._n_lme = n_odom, n_lme

    def _ensure_capacity(self, batch: list[KeyframeMeta]) -> None:
        """Double capacities, from the host count mirrors, when the incoming
        batch could overflow them (plane nodes and plane edges too, in
        plane-landmark sessions)."""
        mpd = self.cfg.capacity.max_detections_per_frame * self.cfg.segmentation.max_planes_per_detection
        pn = self.plane_nodes if self.cfg.use_plane_landmarks else None
        need_poses = self._n_poses + len(batch)
        need_lms = self._n_landmarks + mpd * len(batch)
        need_oe = self._n_odom + len(batch)
        need_le = self._n_lme + mpd * len(batch)
        while (
            need_poses > self.graph.max_poses
            or need_oe > self.graph.odom_i.shape[0]
            or need_le > self.graph.lme_k.shape[0]
            or need_lms > self.graph.max_landmarks
            or (pn is not None and (need_lms > pn.max_planes or need_le > pn.max_edges))
        ):
            self.graph = gs.grow_graph(self.graph)
            self.table = assoc_mod.grow_table(self.table)
            if pn is not None:
                pn = self.plane_nodes = planes_mod.grow_planes(pn)
            self.marginals = torch.eye(3, dtype=self.dtype, device=self.device).repeat(
                self.graph.max_landmarks, 1, 1
            )
            if self.cfg.solver.fixed_lag_window > 0:
                self.prior = fl.grow_prior(self.prior, self.graph.max_landmarks)

    # ------------------------------------------------------------------
    # getters mirroring the reference API (semantic_graph_slam.h:27-113)
    # ------------------------------------------------------------------

    def get_robot_pose(self) -> np.ndarray:
        return self.robot_pose.copy()

    def get_map2odom(self) -> np.ndarray:
        return self.map2odom.copy()

    def get_vio_pose(self) -> np.ndarray:
        return self.vio_pose.copy()

    def get_keyframe_poses(self) -> np.ndarray:
        """Optimized keyframe trajectory [N,7]: marginalized keyframes
        (fixed-lag) from the archive at their last optimized estimate,
        active ones from the graph."""
        active = self.graph.poses[: self._n_poses].cpu().numpy().astype(np.float64)
        if not self.archived_poses:
            return active
        return np.concatenate([np.asarray(self.archived_poses), active], axis=0)

    def get_keyframe_pose(self, kf: KeyframeMeta) -> np.ndarray | None:
        """Optimized pose7 of one keyframe (archive-aware); None if unknown."""
        if kf.node_idx is None:
            return None
        gi = kf.node_idx - self._kf_base
        if gi >= 0:
            return self.graph.poses[gi].cpu().numpy().astype(np.float64)
        if kf.node_idx < len(self.archived_poses):
            return np.asarray(self.archived_poses[kf.node_idx], np.float64)
        return None

    def get_mapped_landmarks(self):
        n = int(self.table.count)
        t = self.table
        return {
            "pose": t.world[:n].cpu().numpy().astype(np.float64),
            "covariance": self._export_covariances()[:n].cpu().numpy().astype(np.float64),
            "class_id": t.class_id[:n].cpu().numpy(),
            "plane_type": t.plane_type[:n].cpu().numpy(),
            "normal": t.normal[:n].cpu().numpy().astype(np.float64),
        }

    def _export_covariances(self) -> Tensor:
        """Landmark covariances for export: Mahalanobis profiles refresh
        table.cov every optimizing tick; Euclidean ones recover marginals on
        demand here, at most once per tick."""
        if self.cfg.association.use_maha_dist:
            return self.table.cov
        if int(self.table.count) == 0 or self._n_lme == 0:
            return self.table.cov
        if self._export_marg_tick != self._ticks_done:
            prior = self._prior_arg()
            if self.cfg.solver.linear_solver == "pcg":
                self._export_marg = soa_mod.landmark_marginals_graph(self.graph, self._ell_rows(), prior)
            elif prior is not None:
                self._export_marg = fl.landmark_marginals_prior(self.graph, prior)
            else:
                self._export_marg = lm_mod.landmark_marginals(self.graph)
            self._export_marg_tick = self._ticks_done
        return self._export_marg
