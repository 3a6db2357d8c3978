"""Batched k-means and the reference's legacy clustering plane pipeline (port
of ``semantic_slam_tpu.frontend.kmeans``).

The reference carries a second (pre-OrganizedMultiPlaneSegmentation) plane
path built on OpenCV k-means: normal-space clustering, gravity filtering of
the centroids, then distance-space clustering within each normal cluster
(``plane_segmentation.cpp:261-535``). It is dead on the main path (and off
the engine's) but part of the component surface. As in the JAX module: a
fixed iteration count, masked points, and a deterministic start (evenly
strided picks, in place of ``cv::KMEANS_RANDOM_CENTERS``), so the two
packages agree on shared inputs with no random generator. Plain PyTorch.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def kmeans(x: Tensor, valid: Tensor, k: int = 3, iters: int = 10) -> tuple[Tensor, Tensor, Tensor]:
    """Masked Lloyd iterations over ``x`` [N, D]; returns (centroids [k, D],
    labels [N], compactness). The seeds are the points at ``(i N) // k + N
    // (2k)``, whatever their mask (the JAX function's start)."""
    N = x.shape[0]
    ar = torch.arange(k, device=x.device)
    c = x[(ar * N) // k + N // (2 * k)]
    w = valid.to(x.dtype)
    for _ in range(iters):
        d2 = torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)  # [N, k]
        lab = torch.argmin(d2, dim=1)
        one_hot = (lab[:, None] == ar[None, :]).to(x.dtype) * w[:, None]
        sums = one_hot.T @ x  # [k, D]
        cnts = torch.sum(one_hot, dim=0)  # [k]
        c = torch.where(cnts[:, None] > 0, sums / torch.clamp(cnts[:, None], min=1.0), c)
    d2 = torch.sum((x[:, None, :] - c[None, :, :]) ** 2, dim=-1)
    return c, torch.argmin(d2, dim=1), torch.sum(torch.min(d2, dim=1).values * w)


def legacy_cluster_planes(pts: Tensor, nrm: Tensor, valid: Tensor, horiz_normal_cam: Tensor, k_normals: int = 3,
                          k_dist: int = 3, min_points: int = 500) -> tuple[Tensor, Tensor, Tensor]:
    """The legacy pipeline (clusterAndSegmentAllPlanes, cpp:261-294):

      1. k-means over the normals; keep the centroids within +-0.3 of the
         gravity normal in the camera frame on every axis (filterCentroids,
         :504-523);
      2. in each kept normal cluster, k-means over the plane offsets
         d = -(n . p) (distanceBasedSegmentation, :369-430);
      3. (normal, d) planes with more than ``min_points`` points.

    ``pts``/``nrm`` [N, 3] in the camera frame. Returns (planes
    [k_normals k_dist, 4], counts, valid mask)."""
    nc, nlab, _ = kmeans(nrm, valid, k=k_normals)
    ok_c = torch.all(torch.abs(nc - horiz_normal_cam[None, :]) < 0.3, dim=1)  # [k_normals]
    planes, counts, pvalid = [], [], []
    for ci in range(k_normals):
        members = valid & (nlab == ci)
        d = -(pts @ nc[ci])  # distance along the cluster normal (:383-390)
        dc, dlab, _ = kmeans(d[:, None], members, k=k_dist)
        for di in range(k_dist):
            cnt = torch.sum((members & (dlab == di)).to(pts.dtype))
            planes.append(torch.cat([nc[ci], dc[di]]))
            counts.append(cnt)
            pvalid.append(ok_c[ci] & (cnt > min_points))
    return torch.stack(planes), torch.stack(counts), torch.stack(pvalid)
