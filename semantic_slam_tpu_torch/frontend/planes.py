"""Batched multi-plane extraction inside detection boxes (port of
``semantic_slam_tpu.frontend.planes``).

Hypothesis-scored RANSAC over the pixel-normal field, for all D detections
at once (the JAX module's ``vmap`` over detections is the leading dim here):

  for each of P rounds (a Python loop):
    1. S plane hypotheses are seeded from evenly spread pixels (point + normal),
    2. every point scores every hypothesis -- one batched ``score_hypotheses``
       launch per round for all detections,
    3. the best hypothesis is refined by PCA over its inliers, re-scored, and
       its inliers leave the pool.

Outputs match the JAX ``PlaneSet``: centroid, oriented coefficients, the
reference's h/v classification and sign rules, scaled inlier count, PCA
area estimate, validity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_tpu_torch.core import linalg3
from semantic_slam_tpu_torch.frontend.kernels import score_hypotheses

Tensor = torch.Tensor


class PlaneSet(NamedTuple):
    centroid: Tensor  # [D, P, 3] cam frame
    coeffs: Tensor  # [D, P, 4] oriented [nx, ny, nz, d]
    hv_flag: Tensor  # [D, P] i32: 0 horizontal, 1 vertical
    num_points: Tensor  # [D, P] estimated true inlier count (scaled)
    area: Tensor  # [D, P] m^2 (PCA estimate)
    valid: Tensor  # [D, P] bool


def classify_and_canonicalize(m: Tensor, d: Tensor, h: Tensor):
    """Reference h/v classification + normal-sign canonicalization
    (plane_segmentation.cpp:195-253), batched: m [B,3], d [B], h [3] or [B,3].
    The per-component test is one-sided (``|m_i| - |h_i| < 0.3``); vertical
    also needs ``h.m < 0.5``; horizontal planes flip when m[1] > 0, vertical
    when m[0] > 0, the whole 4-vector flipping.
    Returns (coeffs [B,4], hv [B] i32, is_h_or_v [B])."""
    is_horizontal = torch.all(torch.abs(m) - torch.abs(h) < 0.3, dim=-1)
    dot_hm = torch.sum(h * m, dim=-1)
    is_vertical = ~is_horizontal & (dot_hm < 0.5)
    hv = torch.where(is_horizontal, 0, 1).to(torch.int32)

    coeffs = torch.cat([m, d[..., None]], dim=-1)
    flip = (is_horizontal & (m[..., 1] > 0)) | (is_vertical & (m[..., 0] > 0))
    coeffs = torch.where(flip[..., None], -coeffs, coeffs)
    return coeffs, hv, is_horizontal | is_vertical


def _masked_pca(pts: Tensor, w: Tensor):
    """Weighted centroid [D,3] + covariance [D,3,3] over pts [D,N,3], w [D,N]."""
    n = torch.clamp(torch.sum(w, dim=-1), min=1e-6)
    c = torch.sum(pts * w[..., None], dim=1) / n[:, None]
    diff = pts - c[:, None, :]
    C = torch.einsum("dni,dnj->dij", diff * w[..., None], diff) / n[:, None, None]
    return c, C, n


def _orient_to_camera(n: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """Flip normals to face the camera (PCL convention); offset d = -n.c."""
    n = torch.where((torch.sum(n * c, dim=-1) > 0)[:, None], -n, n)
    return n, -torch.sum(n * c, dim=-1)


def extract_planes(
    pts: Tensor,  # [D, N, 3]
    nrm: Tensor,  # [D, N, 3]
    cand0: Tensor,  # [D, N] bool: valid point AND valid normal AND in-bbox
    horiz_normal_cam: Tensor,  # [3] or [D, 3] gravity normal in cam frame
    count_scale: Tensor,  # [D]: bbox_pixels / N (sampling correction)
    min_inliers: float,
    min_area: float,
    distance_thres: float,
    cos_angular_thres: float,
    max_planes: int = 4,
    num_hypotheses: int = 128,
) -> PlaneSet:
    D, N, _ = pts.shape
    dtype = pts.dtype
    S = num_hypotheses
    dev = pts.device
    hyp_idx = (torch.arange(S, device=dev) * N) // S + N // (2 * S)
    rows = torch.arange(D, device=dev)

    assigned = torch.zeros((D, N), dtype=torch.bool, device=dev)
    outs = []
    for _ in range(max_planes):
        cand = cand0 & ~assigned

        h_pts = pts[:, hyp_idx]  # [D, S, 3]
        h_nrm = nrm[:, hyp_idx]
        h_ok = cand[:, hyp_idx]
        h_d = -torch.sum(h_nrm * h_pts, dim=-1)  # [D, S]

        counts = score_hypotheses(pts, nrm, cand, h_nrm, h_d, distance_thres, cos_angular_thres)
        counts = torch.where(h_ok, counts, -1.0)  # invalid hypotheses lose
        best = torch.argmax(counts, dim=-1)  # [D], first maximum

        # inlier mask of the winning hypothesis only
        nb, db = h_nrm[rows, best], h_d[rows, best]
        inl_best = (
            (torch.abs(torch.einsum("dni,di->dn", pts, nb) + db[:, None]) < distance_thres)
            & (torch.einsum("dni,di->dn", nrm, nb) > cos_angular_thres)
            & cand
            & h_ok[rows, best][:, None]
        )

        # refine the best hypothesis by PCA over its inliers
        c, C, _ = _masked_pca(pts, inl_best.to(dtype))
        n_ref, _ = linalg3.sym33_smallest_eig(C)
        n_ref, d_ref = _orient_to_camera(n_ref, c)

        # re-score with the refined plane
        dist2 = torch.abs(torch.einsum("dni,di->dn", pts, n_ref) + d_ref[:, None])
        align2 = torch.einsum("dni,di->dn", nrm, n_ref)
        inl2 = (dist2 < distance_thres) & (torch.abs(align2) > cos_angular_thres) & cand
        c2, C2, n2 = _masked_pca(pts, inl2.to(dtype))
        n_fin, evals2 = linalg3.sym33_smallest_eig(C2)
        n_fin, d_fin = _orient_to_camera(n_fin, c2)

        true_count = n2 * count_scale
        # in-plane second moments -> area (exact for uniform rectangles)
        area = 12.0 * torch.sqrt(torch.clamp(evals2[:, 1] * evals2[:, 2], min=0.0))

        coeffs, hv, is_h_or_v = classify_and_canonicalize(n_fin, d_fin, horiz_normal_cam)
        valid = (
            (true_count >= min_inliers)
            & (area >= min_area)
            & is_h_or_v
            & (counts[rows, best] > 0)
        )
        outs.append((c2, coeffs, hv, true_count, area, valid))
        assigned = assigned | inl2

    c2, coeffs, hv, tc, area, valid = (torch.stack(x, dim=1) for x in zip(*outs))
    return PlaneSet(centroid=c2, coeffs=coeffs, hv_flag=hv, num_points=tc, area=area, valid=valid)
