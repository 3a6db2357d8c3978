"""The in-plane basis of a plane normal and planar polygon-area estimators
(port of ``semantic_slam_tpu.frontend.hull``).

The plane landmarks' tangent parameterization (``solver/plane_ba.py``
``plane_retract``) and the fixed-lag prior's plane coordinates
(``solver/fixed_lag.py`` ``plane_local``) both read the basis. The area
estimators are the reference's ``compute2DConvexHull`` +
``calculatePolygonArea`` gate (``plane_segmentation.cpp:189-195,631-665``)
in batched form, off the engine's path as in the JAX package: ``pca_area``
(moment matching ``12 sqrt(l1 l2)``, exact for uniform rectangles) and
``polygon_area`` (the shoelace area of the farthest inlier per angular bin
about the centroid: the hull area for convex regions, an under-estimate for
concave ones). Plain PyTorch.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def plane_basis(n: Tensor) -> tuple[Tensor, Tensor]:
    """Orthonormal in-plane basis (u, v) of unit normals ``n [..., 3]``:
    u = n x ref / |n x ref| with ref = z, or x where |n_z| >= 0.9; v = n x u."""
    ez = n.new_tensor([0.0, 0.0, 1.0])
    ex = n.new_tensor([1.0, 0.0, 0.0])
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    u = torch.linalg.cross(n, ref.expand_as(n), dim=-1)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-12)
    v = torch.linalg.cross(n, u, dim=-1)
    return u, v


def pca_area(evals: Tensor) -> Tensor:
    """Area from the in-plane covariance eigenvalues (ascending [3])."""
    return 12.0 * torch.sqrt(torch.clamp(evals[1] * evals[2], min=0.0))


def polygon_area(pts: Tensor, mask: Tensor, normal: Tensor, bins: int = 64) -> Tensor:
    """Shoelace area of the angular-binned boundary polygon of the inliers
    ``pts [N, 3]`` where ``mask``, in the plane of unit ``normal [3]``."""
    dtype = pts.dtype
    m = mask.to(dtype)
    c = torch.sum(pts * m[:, None], dim=0) / torch.clamp(torch.sum(m), min=1.0)
    u, v = plane_basis(normal)
    rel = pts - c
    x, y = rel @ u, rel @ v
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)  # [-pi, pi)
    b = torch.clamp(((theta + torch.pi) / (2 * torch.pi) * bins).to(torch.int32), 0, bins - 1).long()
    # the farthest inlier radius per bin (a masked scatter-max)
    rmax = torch.full((bins,), -1.0, dtype=dtype, device=pts.device).scatter_reduce(
        0, b, torch.where(mask, r, -1.0), "amax")
    # empty bins carry radius 0 and add nothing to the shoelace sum
    ang = (torch.arange(bins, device=pts.device, dtype=dtype) + 0.5) / bins * 2 * torch.pi - torch.pi
    rr = torch.where(rmax > 0, rmax, 0.0)
    px, py = rr * torch.cos(ang), rr * torch.sin(ang)
    return 0.5 * torch.abs(torch.sum(px * torch.roll(py, -1) - py * torch.roll(px, -1)))
