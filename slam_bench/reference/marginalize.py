"""The plain marginalization of the oldest keyframes into the fixed-lag
prior, dense, in float64 (or bfloat16-rounded for the control).

Semantics of the system's fixed-lag step: the odometry edges touching a
dropped pose, the pose side of the dropped poses' landmark observations
(their pose-landmark cross term is dropped) and the old prior's pose part,
linearized at the current estimates, form a Gaussian over the active
poses; pose 0 is the gauge; the dropped poses are Schur-eliminated,
leaving information over the boundary poses. Each dropped observation
also leaves a landmark block ``J_l^T O J_l``, added to the old prior's
landmark blocks. Compared: the boundary information and the landmark
blocks."""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import lm as ref_lm
from slam_bench.reference.frontend import rounder


def marginalize(g: dict, prior: dict, drop: int, device, low: bool = False) -> dict:
    """``{"p_idx": boundary pose indices (before compaction), "Hp": [6B, 6B],
    "Hl": [L, 3, 3]}`` of the prior that marginalizing poses [0, drop)
    leaves."""
    q = rounder(low)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    K, L = int(g["num_poses"]), int(g["num_landmarks"])
    E1, E2 = int(g["num_odom"]), int(g["num_lme"])
    poses, lms = t(g["poses"][:K]), t(g["landmarks"][:L])
    oi, oj = t(g["odom_i"][:E1]).long(), t(g["odom_j"][:E1]).long()
    lk, ll = t(g["lme_k"][:E2]).long(), t(g["lme_l"][:E2]).long()
    H = poses.new_zeros((6 * K, 6 * K))

    def add(cols, J, info):
        JtO = q(torch.einsum("eai,eab->eib", J, info))
        Hb = q(torch.einsum("eia,eaj->eij", JtO, J))
        H.index_put_((cols[:, :, None], cols[:, None, :]), Hb, accumulate=True)

    six = torch.arange(6, device=device)
    d_o = (oi < drop) | (oj < drop)
    if d_o.any():
        a, b = poses[oi[d_o]], poses[oj[d_o]]
        Ji, Jj = (q(j) for j in ref_lm._jac(ref_lm.odom_residual, [a, b, t(g["odom_meas"][:E1])[d_o]], [6, 6],
                                                ["pose", "pose"]))
        add(torch.cat([6 * oi[d_o, None] + six, 6 * oj[d_o, None] + six], dim=1), torch.cat([Ji, Jj], dim=-1),
            t(g["odom_info"][:E1])[d_o])
    d_e = lk < drop
    Hl = t(prior["Hl"][:L]).clone()
    if d_e.any():
        Jp, Jl = (q(j) for j in ref_lm._jac(ref_lm.point_residual, [poses[lk[d_e]], lms[ll[d_e]],
                                                                     t(g["lme_meas"][:E2])[d_e]], [6, 3],
                                            ["pose", "point"]))
        info = t(g["lme_info"][:E2])[d_e]
        add(6 * lk[d_e, None] + six, Jp, info)
        Hl.index_add_(0, ll[d_e], q(torch.einsum("eai,eab,ebj->eij", Jl, info, Jl)))
    n_p = int(prior["num_p"])
    p_idx = t(prior["p_idx"][:n_p]).long()
    if n_p:
        r6 = (6 * p_idx[:, None] + six).reshape(-1)
        H.index_put_((r6[:, None], r6[None, :]), t(prior["Hp"][:6 * n_p, :6 * n_p]), accumulate=True)
    H[:6], H[:, :6] = 0.0, 0.0  # pose 0: the gauge
    M = torch.arange(6, 6 * drop, device=device)
    kept = torch.arange(6 * drop, 6 * K, device=device)
    coupled = (H[M][:, kept].abs().sum(0).reshape(-1, 6).sum(-1) > 0)
    touched = torch.zeros(K - drop, dtype=torch.bool, device=device)
    touched |= coupled
    old = p_idx[p_idx >= drop] - drop
    touched[old] = True
    B = (torch.nonzero(touched)[:, 0] + drop)
    cols = (6 * B[:, None] + six).reshape(-1)
    H_MM, H_MB, H_BB = H[M][:, M], H[M][:, cols], H[cols][:, cols]
    H_MM = H_MM + torch.diag((H_MM.diagonal().reshape(-1, 6).abs().sum(-1) < 1e-8).to(H.dtype).repeat_interleave(6))
    Hp = H_BB - H_MB.T @ torch.linalg.solve(H_MM.to(torch.float32) if low else H_MM,
                                           H_MB.to(torch.float32) if low else H_MB).to(H.dtype)
    return {"p_idx": B.cpu().numpy(), "Hp": Hp, "Hl": Hl, "drop_n": drop}


def prior_gap(prog: dict, ref: dict) -> float:
    """The larger relative Frobenius gap of the boundary information and of
    the landmark blocks; 1 where the boundary poses differ. ``prog`` is the
    program's prior after compaction (or another ``marginalize`` result)."""
    if "num_p" in prog:
        n_p = int(prog["num_p"])
        idx = np.asarray(prog["p_idx"][:n_p])
        Hp = torch.as_tensor(np.asarray(prog["Hp"][:6 * n_p, :6 * n_p]), device=ref["Hp"].device)
        Hl = torch.as_tensor(np.asarray(prog["Hl"][: ref["Hl"].shape[0]]), device=ref["Hl"].device)
        if len(idx) != len(ref["p_idx"]) or np.any(idx + ref["drop_n"] != ref["p_idx"]):
            return 1.0
    else:
        if len(prog["p_idx"]) != len(ref["p_idx"]) or np.any(prog["p_idx"] != ref["p_idx"]):
            return 1.0
        Hp, Hl = prog["Hp"], prog["Hl"]

    def rel(a, b):
        nb = float(torch.linalg.norm(b))
        return float(torch.linalg.norm(a - b)) / nb if nb > 0 else float(torch.linalg.norm(a))

    return max(rel(Hp, ref["Hp"]), rel(Hl, ref["Hl"]))
