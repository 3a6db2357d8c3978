"""Integral-image surface normals for organized clouds (port of
``semantic_slam_tpu.frontend.normals.compute_normals``; the adaptive-window
variant is not ported yet).

Per-pixel covariance of the points in a (2r+1)^2 box window from 2-D prefix
sums, then the smallest eigenvector by the closed-form 3x3 analysis. The
window clip is the JAX module's edge-padded integral image read by four
static slices (identical values to clipped corner reads).

The f32 prefix sums of x^2, z^2 over a 640x480 image cancel heavily; the
port keeps the JAX arithmetic, and its tests compare the two in f64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semantic_slam_tpu_torch.core import linalg3

Tensor = torch.Tensor


def _box_sum(ii: Tensor, r: int) -> Tensor:
    """Box sums [H, W, C] from a zero-padded inclusive integral image
    ii [H+1, W+1, C], over the window clipped to the image."""
    H = ii.shape[0] - 1
    W = ii.shape[1] - 1
    # J[i + r + d] == ii[clip(i + d, 0, H)] for d in [-r, r+1]
    J = F.pad(ii.permute(2, 0, 1)[None], (r, r + 1, r, r + 1), mode="replicate")[0]
    J = J.permute(1, 2, 0)
    s = 2 * r + 1
    a = J[s : s + H, s : s + W]
    b = J[0:H, s : s + W]
    c = J[s : s + H, 0:W]
    d = J[0:H, 0:W]
    return a - b - c + d


def compute_normals(
    points: Tensor, valid: Tensor, smoothing_size: int = 20, min_points: int = 4
) -> tuple[Tensor, Tensor]:
    """Per-pixel unit normals (oriented toward the camera) + validity mask.

    points: [H, W, 3] camera-frame points; valid: [H, W] bool.
    Returns (normals [H, W, 3], normal_valid [H, W]).
    """
    v = valid.to(points.dtype)[..., None]
    p = torch.where(valid[..., None], points, 0.0)

    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    feats = torch.cat([p, x * x, x * y, x * z, y * y, y * z, z * z, v], dim=-1)  # [H, W, 10]
    feats = feats * v

    ii = torch.cumsum(torch.cumsum(feats, dim=0), dim=1)
    ii = F.pad(ii, (0, 0, 1, 0, 1, 0))

    r = smoothing_size // 2
    s = _box_sum(ii, r)
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
    normal = torch.where(flip, -normal, normal)

    # depth-discontinuity rejection: window z-variance vs allowed change
    max_dz = 0.03 * torch.abs(points[..., 2]) + 0.02
    depth_ok = torch.sqrt(torch.clamp(c22, min=0.0)) < max_dz * 3.0

    normal_valid = valid & (n[..., 0] >= min_points) & depth_ok
    return normal, normal_valid
