"""Integral-image surface normals for organized clouds (port of
``semantic_slam_tpu.frontend.normals``: ``compute_normals`` and the
adaptive-window ``compute_normals_adaptive``).

Per-pixel covariance of the points in a (2r+1)^2 box window from 2-D prefix
sums, then the smallest eigenvector by the closed-form 3x3 analysis. The
window clip is the JAX module's edge-padded integral image read by four
static slices (identical values to clipped corner reads). Both functions
take a cloud ``[H, W, 3]`` or a batch of clouds ``[B, H, W, 3]`` (window
ingest runs the frontend over a run of keyframes at once).

The f32 prefix sums of x^2, z^2 over a 640x480 image cancel heavily; the
port keeps the JAX arithmetic, and its tests compare the two in f64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_slam_tpu_torch.core import linalg3

Tensor = torch.Tensor


def _box_sum(ii: Tensor, r: int) -> Tensor:
    """Box sums [..., H, W, C] from a zero-padded inclusive integral image
    ii [..., H+1, W+1, C], over the window clipped to the image."""
    H = ii.shape[-3] - 1
    W = ii.shape[-2] - 1
    lead = ii.shape[:-3]
    # J[i + r + d] == ii[clip(i + d, 0, H)] for d in [-r, r+1]
    x = ii.reshape(-1, *ii.shape[-3:]).permute(0, 3, 1, 2)
    J = F.pad(x, (r, r + 1, r, r + 1), mode="replicate").permute(0, 2, 3, 1)
    J = J.reshape(*lead, *J.shape[1:])
    s = 2 * r + 1
    a = J[..., s : s + H, s : s + W, :]
    b = J[..., 0:H, s : s + W, :]
    c = J[..., s : s + H, 0:W, :]
    d = J[..., 0:H, 0:W, :]
    return a - b - c + d


def _integral(feats: Tensor) -> Tensor:
    """Inclusive 2-D prefix sums of [..., H, W, C], zero-padded on top/left."""
    ii = torch.cumsum(torch.cumsum(feats, dim=-3), dim=-2)
    return F.pad(ii, (0, 0, 1, 0, 1, 0))


def _moment_integral(points: Tensor, valid: Tensor) -> Tensor:
    """The integral image of (p, x^2, xy, xz, y^2, yz, z^2, 1) over the
    valid pixels."""
    v = valid.to(points.dtype)[..., None]
    p = torch.where(valid[..., None], points, 0.0)
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    feats = torch.cat([p, x * x, x * y, x * z, y * y, y * z, z * z, v], dim=-1)  # [..., H, W, 10]
    return _integral(feats * v)


def _normals_from_sums(s: Tensor, points: Tensor):
    """Window sums [..., 10] -> (camera-facing normal, point count, c22)."""
    n = s[..., 9:10]
    n_safe = torch.clamp(n, min=1.0)
    mean = s[..., 0:3] / n_safe
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    sxx, sxy, sxz = s[..., 3], s[..., 4], s[..., 5]
    syy, syz, szz = s[..., 6], s[..., 7], s[..., 8]
    nn = n_safe[..., 0]
    c00 = sxx / nn - mx * mx
    c01 = sxy / nn - mx * my
    c02 = sxz / nn - mx * mz
    c11 = syy / nn - my * my
    c12 = syz / nn - my * mz
    c22 = szz / nn - mz * mz
    C = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c01, c11, c12], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    normal, _ = linalg3.sym33_smallest_eig(C)
    # orient toward the viewpoint at the origin (PCL flipNormalTowardsViewpoint)
    flip = torch.sum(normal * points, dim=-1, keepdim=True) > 0
    return torch.where(flip, -normal, normal), n[..., 0], c22


def compute_normals(
    points: Tensor, valid: Tensor, smoothing_size: int = 20, min_points: int = 4
) -> tuple[Tensor, Tensor]:
    """Per-pixel unit normals (oriented toward the camera) + validity mask.

    points: [..., H, W, 3] camera-frame points; valid: [..., H, W] bool.
    Returns (normals [..., H, W, 3], normal_valid [..., H, W]).
    """
    s = _box_sum(_moment_integral(points, valid), smoothing_size // 2)
    normal, n, c22 = _normals_from_sums(s, points)

    # depth-discontinuity rejection: window z-variance vs allowed change
    max_dz = 0.03 * torch.abs(points[..., 2]) + 0.02
    depth_ok = torch.sqrt(torch.clamp(c22, min=0.0)) < max_dz * 3.0

    normal_valid = valid & (n >= min_points) & depth_ok
    return normal, normal_valid


def compute_normals_adaptive(
    points: Tensor, valid: Tensor, smoothing_size: int = 20, min_points: int = 4, num_scales: int = 3,
    max_depth_change_factor: float = 0.03,
) -> tuple[Tensor, Tensor]:
    """PCL-faithful adaptive-window variant of ``compute_normals``
    (``IntegralImageNormalEstimation`` shrinks its window near depth
    discontinuities): the same integral image read at ``num_scales`` radii
    (full, half, quarter, ...), the depth-edge pixels in each window counted
    through a second integral image, and per pixel the largest window free
    of edges taken (the smallest when none is).

    The depth-edge map reads ``points``' z as given: a neighbour's |dz|
    above ``max_depth_change_factor * |z| + 0.02``, or a validity change
    (both with the border replicated). A NaN z at an invalid pixel marks no
    |dz| edge, as a zero there would not: the validity change marks it.
    """
    ii = _moment_integral(points, valid)

    zz = points[..., 2]
    thr = max_depth_change_factor * torch.abs(zz) + 0.02
    dz_x = torch.abs(torch.diff(zz, dim=-1, prepend=zz[..., :, :1]))
    dz_y = torch.abs(torch.diff(zz, dim=-2, prepend=zz[..., :1, :]))
    vdiff_x = valid != torch.cat([valid[..., :, :1], valid[..., :, :-1]], dim=-1)
    vdiff_y = valid != torch.cat([valid[..., :1, :], valid[..., :-1, :]], dim=-2)
    edge = (dz_x > thr) | (dz_y > thr) | vdiff_x | vdiff_y
    ii_e = _integral(edge.to(points.dtype)[..., None])

    radii = [max(1, (smoothing_size // 2) >> k) for k in range(num_scales)]
    clean = torch.stack([_box_sum(ii_e, r)[..., 0] <= 0.5 for r in radii])  # [R, ..., H, W]
    # the first (largest) clean scale, else the smallest: argmax over a
    # 0/1 stack picks the first maximum, as jnp.argmax does
    any_clean = torch.any(clean, dim=0)
    sel = torch.where(any_clean, torch.argmax(clean.to(torch.uint8), dim=0), len(radii) - 1)
    s = _box_sum(ii, radii[-1])
    for k in range(len(radii) - 2, -1, -1):
        s = torch.where((sel == k)[..., None], _box_sum(ii, radii[k]), s)
    normal, n, c22 = _normals_from_sums(s, points)

    # windows that shrank to the smallest radius and still hold an edge keep
    # the fixed-window variance rejection as a safety net
    max_dz = max_depth_change_factor * torch.abs(zz) + 0.02
    depth_ok = any_clean | (torch.sqrt(torch.clamp(c22, min=0.0)) < max_dz * 3.0)
    normal_valid = valid & (n >= min_points) & depth_ok
    return normal, normal_valid
