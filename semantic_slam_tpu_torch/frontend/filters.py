"""Point-cloud filters (port of ``semantic_slam_tpu.frontend.filters``): the
reference's PCL filter set, batched.

Equivalents of ``plane_segmentation``'s filters
(``plane_segmentation.cpp``): voxel-grid downsample (0.1 m leaf,
:564-582), statistical outlier removal (meanK 50 / stddev 1.0, :584-606)
and the 0.3-3 m range filter (:608-629). Off the reference's main path (its
preprocess is commented out there) and off the engine's, but part of the
library surface. Static shapes and masks, as in the JAX module; plain
PyTorch (no kernel is behind them).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def voxel_downsample(pts: Tensor, valid: Tensor, leaf: float = 0.1, grid_dim: int = 64) -> tuple[Tensor, Tensor]:
    """Voxel-grid downsample: per-occupied-voxel centroid.

    Returns (centroids [N,3], keep_mask [N]) where entry i holds the
    centroid of point i's voxel, and the mask keeps the voxel's first
    member (a stable representative, static shape)."""
    N = pts.shape[0]
    dev = pts.device
    leaf = torch.as_tensor(leaf, dtype=pts.dtype, device=dev)
    origin = torch.min(torch.where(valid[:, None], pts, torch.inf), dim=0).values
    idx3 = torch.clamp(torch.floor((pts - origin) / leaf), 0, grid_dim - 1).to(torch.int64)
    key = (idx3[:, 0] * grid_dim + idx3[:, 1]) * grid_dim + idx3[:, 2]
    key = torch.where(valid, key, grid_dim ** 3)  # invalid -> dump bucket

    nb = grid_dim ** 3 + 1
    sums = torch.zeros((nb, 3), dtype=pts.dtype, device=dev).index_add_(0, key, torch.where(valid[:, None], pts, 0))
    cnts = torch.zeros((nb,), dtype=pts.dtype, device=dev).index_add_(0, key, valid.to(pts.dtype))
    centroids = sums / torch.clamp(cnts[:, None], min=1.0)
    # a voxel's representative is its smallest member index
    ar = torch.arange(N, device=dev)
    first = torch.full((nb,), N, dtype=torch.int64, device=dev).scatter_reduce(0, key, ar, "amin")
    return centroids[key], valid & (first[key] == ar)


def statistical_outlier_removal(pts: Tensor, valid: Tensor, mean_k: int = 50, stddev_mul: float = 1.0) -> Tensor:
    """PCL StatisticalOutlierRemoval: the mean distance to the k nearest
    neighbours against the global mean + ``stddev_mul`` std. O(N^2)
    distances, for the already cropped or downsampled clouds it is used on.
    Returns the keep mask."""
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    big = torch.finfo(pts.dtype).max
    d2 = torch.where(valid[None, :], d2, big)
    d2 = d2 + torch.eye(pts.shape[0], dtype=pts.dtype, device=pts.device) * big  # exclude self
    knn = -torch.topk(-d2, mean_k, dim=1).values  # [N, k] smallest distances
    mean_d = torch.mean(torch.sqrt(torch.clamp(knn, min=0.0)), dim=1)
    m = valid
    n = torch.clamp(torch.sum(m), min=1)
    mu = torch.sum(torch.where(m, mean_d, 0)) / n
    var = torch.sum(torch.where(m, (mean_d - mu) ** 2, 0)) / n
    return valid & (mean_d <= mu + stddev_mul * torch.sqrt(var))


def range_filter(pts: Tensor, valid: Tensor, d_min: float = 0.3, d_max: float = 3.0) -> Tensor:
    """Distance filter 0.3-3 m (plane_segmentation.cpp:608-629)."""
    d = torch.linalg.vector_norm(pts, dim=-1)
    return valid & (d > d_min) & (d < d_max)
