"""Frontend orchestrator: organized cloud + 2-D detections -> plane objects
(port of ``semantic_slam_tpu.frontend.segmentation``).

Normals are computed once on the full image; each bounding box is resampled
onto a fixed crop grid (count gates corrected by the sampling ratio); plane
extraction runs for all detections in one batch; the outputs are packed into
flat ``DetectedObjects`` of D*P rows. Reference behaviors kept: the class
whitelist (id < 0), the far-edge-only spurious-box test
(plane_segmentation.cpp:34-38), the ``norm_point_thres`` gate on the box
AREA, and the world pose that adds the robot translation after rotating.
Points at invalid pixels are zeroed on entry (the JAX package lets a NaN
there reach the plane fit's masked sums). ``segment_window`` runs the same
frontend over a run of B keyframes at once (window ingest, the JAX engine's
``vmap`` over rows): one plane extraction over all B*D detections.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_tpu_torch.core import frames
from semantic_slam_tpu_torch.frontend import normals as nrm_mod
from semantic_slam_tpu_torch.frontend import planes as planes_mod

Tensor = torch.Tensor


class DetectedObjects(NamedTuple):
    """Flat [D*P] plane-landmark observations for one keyframe."""

    valid: Tensor  # [M] bool
    class_id: Tensor  # [M] i32
    prob: Tensor  # [M]
    plane_type: Tensor  # [M] i32: 0 horizontal / 1 vertical
    num_points: Tensor  # [M]
    pose_cam: Tensor  # [M, 3] plane centroid, camera frame
    normal_cam: Tensor  # [M, 4] oriented plane coeffs, camera frame
    world_pose: Tensor  # [M, 3] centroid in world (reference recipe)


def _bbox_sample(points, valid, normal, normal_valid, boxes, samp_h: int, samp_w: int):
    """Strided gather of every box of every cloud onto a fixed
    [samp_h*samp_w] grid, one indexed load with a row index: clouds
    ``[B, H, W, *]``, boxes ``[B, D, 4]`` -> (pts [B*D,N,3], normals
    [B*D,N,3], ok [B*D,N])."""
    B, H, W = points.shape[:3]
    D = boxes.shape[1]
    dev, dtype = points.device, boxes.dtype
    tlx, tly, bw, bh = boxes.unbind(-1)
    jj = (torch.arange(samp_w, dtype=dtype, device=dev) + 0.5) * bw[..., None] / samp_w + tlx[..., None]
    ii = (torch.arange(samp_h, dtype=dtype, device=dev) + 0.5) * bh[..., None] / samp_h + tly[..., None]
    u = torch.clamp(jj.to(torch.int64), 0, W - 1)  # truncation toward zero, as astype(int32)
    v = torch.clamp(ii.to(torch.int64), 0, H - 1)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    vi, ui = v[:, :, :, None], u[:, :, None, :]
    pts = points[bi, vi, ui].reshape(B * D, -1, 3)
    nr = normal[bi, vi, ui].reshape(B * D, -1, 3)
    ok = (valid & normal_valid)[bi, vi, ui].reshape(B * D, -1)
    return pts, nr, ok


def segment_all(
    points: Tensor,  # [H, W, 3] organized cloud, cam frame
    cloud_valid: Tensor,  # [H, W] bool
    boxes: Tensor,  # [D, 4] (tl_x, tl_y, w, h)
    class_ids: Tensor,  # [D] i32, -1 = not whitelisted / absent
    probs: Tensor,  # [D]
    robot_xyzrpy: Tensor,  # [6]
    cam_angle: Tensor,  # 0-d (radians)
    num_point_seg: float,
    norm_point_thres: float,
    planar_area: float,
    distance_thres: float,
    cos_angular_thres: float,
    samp_h: int = 128,
    samp_w: int = 128,
    max_planes: int = 4,
    num_hypotheses: int = 128,
    smoothing_size: int = 20,
    strict_frames: bool = True,
    adaptive_normals: bool = False,
) -> DetectedObjects:
    """The frontend of one keyframe: ``segment_window`` over a run of one."""
    dets = segment_window(
        points[None], cloud_valid[None], boxes[None], class_ids[None], probs[None], robot_xyzrpy[None], cam_angle,
        num_point_seg, norm_point_thres, planar_area, distance_thres, cos_angular_thres, samp_h=samp_h,
        samp_w=samp_w, max_planes=max_planes, num_hypotheses=num_hypotheses, smoothing_size=smoothing_size,
        strict_frames=strict_frames, adaptive_normals=adaptive_normals,
    )
    return DetectedObjects(*(f[0] for f in dets))


def segment_window(
    points: Tensor,  # [B, H, W, 3] organized clouds, cam frame
    cloud_valid: Tensor,  # [B, H, W] bool
    boxes: Tensor,  # [B, D, 4] (tl_x, tl_y, w, h)
    class_ids: Tensor,  # [B, D] i32, -1 = not whitelisted / absent
    probs: Tensor,  # [B, D]
    robot_xyzrpy: Tensor,  # [B, 6] each keyframe's pose snapshot
    cam_angle: Tensor,  # 0-d (radians)
    num_point_seg: float,
    norm_point_thres: float,
    planar_area: float,
    distance_thres: float,
    cos_angular_thres: float,
    samp_h: int = 128,
    samp_w: int = 128,
    max_planes: int = 4,
    num_hypotheses: int = 128,
    smoothing_size: int = 20,
    strict_frames: bool = True,
    adaptive_normals: bool = False,
) -> DetectedObjects:
    """The frontend of B keyframes at once, whose fields come back
    ``[B, D*P, ...]``: normals over ``[B, H, W]``, one box gather, and one
    ``extract_planes`` call over the B*D detections (K5 scores them in one
    launch a round); the gravity normal and the sampling correction are
    per detection."""
    B, H, W = points.shape[:3]
    D = boxes.shape[1]
    dtype = points.dtype
    N = samp_h * samp_w

    # invalid pixels may hold NaN (a PointCloud2's, the .bag reader's): zero
    # them once, so that masked sums (0 * NaN) stay finite; finite points
    # there already carry weight 0. The adaptive windows' depth-edge map
    # reads the z given, as the JAX package's does (see compute_normals_adaptive)
    raw = points
    points = torch.where(cloud_valid[..., None], points, 0.0)
    if adaptive_normals:
        normal, normal_valid = nrm_mod.compute_normals_adaptive(raw, cloud_valid, smoothing_size=smoothing_size)
    else:
        normal, normal_valid = nrm_mod.compute_normals(points, cloud_valid, smoothing_size=smoothing_size)
    h_cam = frames.horizontal_plane_normal_in_cam(robot_xyzrpy, cam_angle, strict=strict_frames)[..., :3]
    T_cw = frames.t_cam_world(robot_xyzrpy, cam_angle, strict=strict_frames)  # [B, 4, 4]

    pts, nr, ok = _bbox_sample(points, cloud_valid, normal, normal_valid, boxes, samp_h, samp_w)
    tlx, tly, bw, bh = boxes.unbind(-1)
    # spurious bbox rejection -- exactly the reference's test
    spurious = (bh < 0) | (bw < 0) | (tlx + bw > W) | (tly + bh > H)
    # norm_point_thres gates on the CROP SIZE w*h (reference quirk)
    det_ok = (~spurious & (class_ids >= 0) & (bw * bh >= norm_point_thres)).reshape(B * D)
    count_scale = (torch.clamp(bw * bh, min=0.0) / N).reshape(B * D)

    ps = planes_mod.extract_planes(
        pts, nr, ok & det_ok[:, None], h_cam.repeat_interleave(D, dim=0), count_scale.to(dtype),
        num_point_seg, planar_area, distance_thres, cos_angular_thres,
        max_planes=max_planes, num_hypotheses=num_hypotheses,
    )

    M = D * max_planes
    centroid = ps.centroid.reshape(B, M, 3)
    ch = torch.cat([centroid, torch.ones((B, M, 1), dtype=dtype, device=points.device)], dim=-1)
    world = torch.einsum("bij,bmj->bmi", T_cw, ch)[..., :3] + robot_xyzrpy[:, None, :3]

    return DetectedObjects(
        valid=(ps.valid & det_ok[:, None]).reshape(B, M),
        class_id=class_ids.repeat_interleave(max_planes, dim=1),
        prob=probs.repeat_interleave(max_planes, dim=1),
        plane_type=ps.hv_flag.reshape(B, M),
        num_points=ps.num_points.reshape(B, M),
        pose_cam=centroid,
        normal_cam=ps.coeffs.reshape(B, M, 4),
        world_pose=world,
    )
