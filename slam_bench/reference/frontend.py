"""The plain frontend: organized cloud (or depth image) and detector boxes of
one keyframe -> plane observations, in float64 (or, for the control, with
every stage's operands and results rounded to bfloat16).

Semantics of the system's frontend, written plainly: per-pixel normals as
the smallest eigenvector (``torch.linalg.eigh``) of the covariance of the
valid points in a (2r+1)^2 window clipped to the image, turned to face the
camera, rejected at depth edges; each box resampled onto a crop grid; per
detection P rounds of hypothesis-scored RANSAC (hypotheses at evenly spread
crop pixels, every point counted against every hypothesis: the work of the
system's K5 kernel), a PCA refit over the winner's inliers, a re-score and
a second PCA; the reference system's horizontal/vertical classification
and sign rules; centroids to the world by its frame chain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_bench import np_geometry as npg

Tensor = torch.Tensor


def rounder(low: bool):
    """Identity, or a round trip through bfloat16 (the control)."""
    if not low:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float64)


def backproject(depth: np.ndarray, intr: np.ndarray, scale: float, device) -> tuple[Tensor, Tensor]:
    d = torch.as_tensor(depth.astype(np.int32), device=device)
    H, W = d.shape
    z = d.to(torch.float64) * scale
    u = torch.arange(W, dtype=torch.float64, device=device)[None, :]
    v = torch.arange(H, dtype=torch.float64, device=device)[:, None]
    pts = torch.stack([(u - intr[2]) * z / intr[0], (v - intr[3]) * z / intr[1], z], dim=-1)
    valid = d > 0
    return torch.where(valid[..., None], pts, 0.0), valid


def _smallest_eigvec(C: Tensor) -> tuple[Tensor, Tensor]:
    """(eigenvector of the smallest eigenvalue, eigenvalues ascending), in
    batches that the device's batched solver takes."""
    flat = C.reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(flat[i:i + 16384]) for i in range(0, flat.shape[0], 16384)]
    evals = torch.cat([p[0] for p in parts]).reshape(C.shape[:-1])
    evecs = torch.cat([p[1] for p in parts]).reshape(C.shape)
    return evecs[..., :, 0], evals


def normals(pts: Tensor, valid: Tensor, smoothing_size: int, q) -> tuple[Tensor, Tensor]:
    """Unit normals [H,W,3] facing the camera and their validity [H,W]."""
    H, W = valid.shape
    r = smoothing_size // 2
    v = valid.to(pts.dtype)[..., None]
    p = q(pts * v)
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    feats = torch.cat([p, x * x, x * y, x * z, y * y, y * z, z * z, torch.ones_like(x)], dim=-1) * v
    ii = torch.zeros((H + 1, W + 1, 10), dtype=pts.dtype, device=pts.device)
    ii[1:, 1:] = feats.cumsum(0).cumsum(1)
    i = torch.arange(H, device=pts.device)
    j = torch.arange(W, device=pts.device)
    i0, i1 = (i - r).clamp(0, H), (i + r + 1).clamp(0, H)
    j0, j1 = (j - r).clamp(0, W), (j + r + 1).clamp(0, W)
    S = ii[i1][:, j1] - ii[i0][:, j1] - ii[i1][:, j0] + ii[i0][:, j0]
    n = S[..., 9]
    nn = n.clamp(min=1.0)[..., None]
    mean = S[..., 0:3] / nn
    sxx, sxy, sxz, syy, syz, szz = (S[..., k:k + 1] / nn for k in range(3, 9))
    mx, my, mz = mean[..., 0:1], mean[..., 1:2], mean[..., 2:3]
    C = torch.cat([sxx - mx * mx, sxy - mx * my, sxz - mx * mz, sxy - mx * my, syy - my * my, syz - my * mz,
                   sxz - mx * mz, syz - my * mz, szz - mz * mz], dim=-1).reshape(H, W, 3, 3)
    nrm, _ = _smallest_eigvec(q(C))
    nrm = torch.where(((nrm * pts).sum(-1) > 0)[..., None], -nrm, nrm)
    c22 = C[..., 2, 2]
    depth_ok = torch.sqrt(c22.clamp(min=0.0)) < 3.0 * (0.03 * pts[..., 2].abs() + 0.02)
    return q(nrm), valid & (n >= 4) & depth_ok


def _pca(pts: Tensor, w: Tensor, q):
    """Weighted centroid, the smallest eigenvector (e_z where no point
    weighs), eigenvalues ascending and the clamped weight."""
    n = w.sum().clamp(min=1e-6)
    c = q((pts * w[:, None]).sum(0) / n)
    d = pts - c
    C = q(torch.einsum("ni,nj->ij", d * w[:, None], d) / n)
    vec, evals = _smallest_eigvec(C)
    if float(w.sum()) == 0.0:
        vec = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    return c, vec, evals, n


def _orient(n: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    if float((n * c).sum()) > 0:
        n = -n
    return n, -(n * c).sum()


def _classify(m: Tensor, d: Tensor, h: Tensor):
    """The reference system's h/v test and sign rules: (coeffs [4], type, ok)."""
    is_h = bool(torch.all(m.abs() - h.abs() < 0.3))
    is_v = (not is_h) and float((h * m).sum()) < 0.5
    coeffs = torch.cat([m, d[None]])
    if (is_h and float(m[1]) > 0) or (is_v and float(m[0]) > 0):
        coeffs = -coeffs
    return coeffs, 0 if is_h else 1, is_h or is_v


def planes(pts: Tensor, nrm: Tensor, cand0: Tensor, h: Tensor, count_scale: float, seg: dict, q) -> list[dict]:
    """P rounds of plane extraction over one detection's crop samples."""
    N = pts.shape[0]
    S = seg["num_hypotheses"]
    hyp = (torch.arange(S, device=pts.device) * N) // S + N // (2 * S)
    dt, ct = seg["distance_thres"], seg["cos_angular_thres"]
    assigned = torch.zeros(N, dtype=torch.bool, device=pts.device)
    out = []
    for _ in range(seg["max_planes"]):
        cand = cand0 & ~assigned
        hp, hn, hok = pts[hyp], nrm[hyp], cand[hyp]
        hd = -(hn * hp).sum(-1)
        dist = q((pts @ hn.T + hd[None, :]).abs())
        inl = (dist < dt) & (q(nrm @ hn.T) > ct) & cand[:, None]
        counts = torch.where(hok, inl.sum(0).to(pts.dtype), torch.full_like(hd, -1.0))
        best = int(torch.argmax(counts))
        inl_best = inl[:, best] & hok[best]
        c, n_ref, _, _ = _pca(pts, inl_best.to(pts.dtype), q)
        n_ref, d_ref = _orient(n_ref, c)
        inl2 = ((pts @ n_ref + d_ref).abs() < dt) & ((nrm @ n_ref).abs() > ct) & cand
        c2, n_fin, ev, n2 = _pca(pts, inl2.to(pts.dtype), q)
        n_fin, d_fin = _orient(n_fin, c2)
        area = 12.0 * math.sqrt(max(float(ev[1] * ev[2]), 0.0))
        coeffs, hv, hv_ok = _classify(n_fin, d_fin, h)
        count = float(n2) * count_scale
        gated = hv_ok and float(counts[best]) > 0
        area_margin = area / seg["planar_area"] if seg["planar_area"] > 0 else math.inf
        margin = min(count / seg["num_point_seg"], area_margin) if gated else 0.0
        out.append({"valid": gated and margin >= 1.0, "type": hv, "centroid": c2, "coeffs": coeffs, "margin": margin})
        assigned = assigned | inl2
    return out


def keyframe(cloud: tuple[Tensor, Tensor], boxes: np.ndarray, class_ids: np.ndarray, xyzrpy: np.ndarray,
             cam_angle: float, seg: dict, strict: bool, low: bool = False) -> dict[str, Tensor]:
    """Observations of one keyframe, D*P rows as the system packs them:
    ``valid`` [M], ``type`` [M], ``pose_cam`` [M,3], ``normal_cam`` [M,4],
    ``world`` [M,3], and ``margin`` [M]: the smaller of the plane's inlier
    count and area over their gates (valid at 1 and above; 0 where the plane
    fails the type or hypothesis test). ``boxes`` [D,4] and ``class_ids`` [D] are padded as the
    engine pads them (class -1 for an absent detection)."""
    q = rounder(low)
    pts, valid = cloud
    H, W = valid.shape
    pts = torch.where(valid[..., None], pts, 0.0)
    nrm, nvalid = normals(pts, valid, seg["smoothing_size"], q)
    ok_pix = valid & nvalid
    T = torch.as_tensor(npg.t_cam_world(xyzrpy, cam_angle, strict), device=pts.device)
    h = T[:3, :3].T @ torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=pts.device)
    sh, sw = seg["crop_height"], seg["crop_width"]
    P = seg["max_planes"]
    D = len(boxes)
    M = D * P
    res = {"valid": torch.zeros(M, dtype=torch.bool), "type": torch.zeros(M, dtype=torch.int64),
           "margin": torch.zeros(M, dtype=torch.float64),
           "pose_cam": torch.zeros(M, 3, dtype=torch.float64), "normal_cam": torch.zeros(M, 4, dtype=torch.float64)}
    for d in range(D):
        tlx, tly, bw, bh = (float(x) for x in boxes[d])
        spurious = bh < 0 or bw < 0 or tlx + bw > W or tly + bh > H
        if spurious or class_ids[d] < 0 or bw * bh < seg["norm_point_thres"]:
            continue
        jj = (torch.arange(sw, dtype=torch.float64, device=pts.device) + 0.5) * bw / sw + tlx
        ii = (torch.arange(sh, dtype=torch.float64, device=pts.device) + 0.5) * bh / sh + tly
        u = jj.to(torch.int64).clamp(0, W - 1)
        v = ii.to(torch.int64).clamp(0, H - 1)
        sp = pts[v[:, None], u[None, :]].reshape(-1, 3)
        sn = nrm[v[:, None], u[None, :]].reshape(-1, 3)
        sok = ok_pix[v[:, None], u[None, :]].reshape(-1)
        for p, pl in enumerate(planes(q(sp), sn, sok, h, max(bw * bh, 0.0) / (sh * sw), seg, q)):
            m = d * P + p
            res["valid"][m] = pl["valid"]
            res["margin"][m] = pl["margin"]
            res["type"][m] = pl["type"]
            res["pose_cam"][m] = pl["centroid"].cpu()
            res["normal_cam"][m] = pl["coeffs"].cpu()
    ch = torch.cat([res["pose_cam"], torch.ones(M, 1, dtype=torch.float64)], dim=-1)
    res["world"] = (ch @ T.cpu().T)[:, :3] + torch.as_tensor(xyzrpy[:3])
    return res
