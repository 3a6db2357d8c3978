"""The plain solve of one tick: Levenberg-Marquardt over the active graph
(and the fixed-lag prior), dense, in float64 (or with bfloat16-rounded
residuals, Jacobians and normal equations, for the control).

The objective is the system's: odometry edges ``log(Z^-1 X_i^-1 X_j)``,
landmark edges ``R_k^T (l - t_k) - z`` under the robust kernel (IRLS
weights, Huber or DCS in its Geman-McClure form), the prior's quadratic
``c0 + 2 g0.e + e^T H e`` in ``e_p = log(ref^-1 x)`` (translation
``R_ref^T (t_x - t_ref)``) and ``e_l = l - l_ref``. Jacobians are central
differences of those residuals (right perturbations of poses); the normal
equations are solved whole. The loop is the system's LM: the tau*diag or
given initial damping, Nielsen's gain-ratio schedule, stop on a relative
decrease under ``rel_tol``, a damping over 1e12, or ``max_iterations``.
Pose 0 is held fixed, as are slots past the counts."""

from __future__ import annotations

import dataclasses

import torch

from slam_bench.reference import geometry as geo
from slam_bench.reference.frontend import rounder

Tensor = torch.Tensor
STEP = 1e-6  # central-difference step; the Jacobian is exact to ~1e-10 in float64


@dataclasses.dataclass
class Problem:
    poses: Tensor  # [K, 7] active poses
    landmarks: Tensor  # [L, 3] active landmarks
    oi: Tensor
    oj: Tensor
    o_meas: Tensor
    o_info: Tensor
    lk: Tensor
    ll: Tensor
    l_meas: Tensor
    l_info: Tensor
    robust: str
    delta: float
    prior: dict | None  # p_idx, p_ref, Hp, gp0, Hl, l_ref, gl0, c0 (landmark rows of the active ones)


def _robust(chi: Tensor, kind: str, delta: float) -> tuple[Tensor, Tensor]:
    """(rho, weight) of per-edge chi2 values."""
    if kind == "none":
        return chi, torch.ones_like(chi)
    if kind == "huber":
        d2 = delta * delta
        e = torch.sqrt(chi.clamp(min=1e-30))
        return torch.where(chi <= d2, chi, 2 * delta * e - d2), (delta / e).clamp(max=1.0)
    if kind == "dcs":
        phi = delta * delta
        return 2 * phi * chi / (phi + chi.clamp(min=1e-30)), ((2 * phi / (phi + chi.clamp(min=0.0))) ** 2).clamp(max=1.0)
    raise ValueError(kind)


def odom_residual(pi: Tensor, pj: Tensor, meas: Tensor) -> Tensor:
    return geo.se3_log(geo.pose_mul(geo.pose_inv(meas), geo.pose_mul(geo.pose_inv(pi), pj)))


def point_residual(pk: Tensor, l: Tensor, meas: Tensor) -> Tensor:
    return torch.einsum("...ji,...j->...i", geo.rotmat(pk[..., 3:]), l - pk[..., :3]) - meas


def pose_local(x: Tensor, ref: Tensor) -> Tensor:
    qi = geo.quat_conj(ref[..., 3:])
    q = geo.quat_mul(qi, x[..., 3:])
    t = geo.rotate(qi, x[..., :3] - ref[..., :3])
    return geo.se3_log(torch.cat([t, q / q.norm(dim=-1, keepdim=True)], dim=-1))


def objective(pr: Problem, poses: Tensor, lms: Tensor) -> Tensor:
    r_o = odom_residual(poses[pr.oi], poses[pr.oj], pr.o_meas)
    chi = torch.einsum("ea,eab,eb->", r_o, pr.o_info, r_o)
    r_l = point_residual(poses[pr.lk], lms[pr.ll], pr.l_meas)
    rho, _ = _robust(torch.einsum("ea,eab,eb->e", r_l, pr.l_info, r_l), pr.robust, pr.delta)
    return chi + rho.sum() + prior_value(pr, poses, lms)


def prior_value(pr: Problem, poses: Tensor, lms: Tensor) -> Tensor:
    p = pr.prior
    if p is None:
        return poses.new_zeros(())
    ep = pose_local(poses[p["p_idx"]], p["p_ref"]).reshape(-1)
    el = lms - p["l_ref"]
    return (p["c0"] + 2 * p["gp0"] @ ep + ep @ p["Hp"] @ ep
            + 2 * (p["gl0"] * el).sum() + torch.einsum("li,lij,lj->", el, p["Hl"], el))


def _jac(fn, args: list[Tensor], dims: list[int], which: list[str]) -> list[Tensor]:
    """Central-difference Jacobians [E, R, d] of ``fn(*args)`` [E, R] in each
    argument: a pose argument is perturbed on the right, a point additively."""
    out = []
    for a, (x, d, kind) in enumerate(zip(args, dims, which)):
        cols = []
        for c in range(d):
            e = torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device)
            e[..., c] = STEP
            plus, minus = list(args), list(args)
            plus[a] = geo.retract(x, e) if kind == "pose" else x + e
            minus[a] = geo.retract(x, -e) if kind == "pose" else x - e
            cols.append((fn(*plus) - fn(*minus)) / (2 * STEP))
        out.append(torch.stack(cols, dim=-1))
    return out


def linearize(pr: Problem, poses: Tensor, lms: Tensor, q) -> tuple[Tensor, Tensor, Tensor]:
    """(H [n,n], g [n], objective) over [6K poses | 3L landmarks]."""
    K, L = poses.shape[0], lms.shape[0]
    n = 6 * K + 3 * L
    H = poses.new_zeros((n, n))
    g = poses.new_zeros(n)

    def scatter(idx_blocks, J, info, r):
        """Add J^T info J and J^T info r for one edge type; ``idx_blocks``
        lists each Jacobian block's first column per edge."""
        JtO = q(torch.einsum("eai,eab->eib", J, info))
        Hb = q(torch.einsum("eia,eaj->eij", JtO, J))
        gb = q(torch.einsum("eia,ea->ei", JtO, r))
        cols = torch.cat([s[:, None] + torch.arange(w, device=s.device)[None] for s, w in idx_blocks], dim=1)
        H.index_put_((cols[:, :, None], cols[:, None, :]), Hb, accumulate=True)
        g.index_put_((cols,), gb, accumulate=True)

    r_o = q(odom_residual(poses[pr.oi], poses[pr.oj], pr.o_meas))
    Ji, Jj = (q(j) for j in _jac(odom_residual, [poses[pr.oi], poses[pr.oj], pr.o_meas], [6, 6], ["pose", "pose"]))
    scatter([(6 * pr.oi, 6), (6 * pr.oj, 6)], torch.cat([Ji, Jj], dim=-1), pr.o_info, r_o)
    chi_o = torch.einsum("ea,eab,eb->", r_o, pr.o_info, r_o)

    r_l = q(point_residual(poses[pr.lk], lms[pr.ll], pr.l_meas))
    Jp, Jl = (q(j) for j in _jac(point_residual, [poses[pr.lk], lms[pr.ll], pr.l_meas], [6, 3], ["pose", "point"]))
    rho, w = _robust(torch.einsum("ea,eab,eb->e", r_l, pr.l_info, r_l), pr.robust, pr.delta)
    scatter([(6 * pr.lk, 6), (6 * K + 3 * pr.ll, 3)], torch.cat([Jp, Jl], dim=-1), pr.l_info * w[:, None, None], r_l)
    f = chi_o + rho.sum()

    p = pr.prior
    if p is not None:
        ep = pose_local(poses[p["p_idx"]], p["p_ref"]).reshape(-1)
        el = lms - p["l_ref"]
        r6 = (6 * p["p_idx"][:, None] + torch.arange(6, device=poses.device)).reshape(-1)
        H.index_put_((r6[:, None], r6[None, :]), p["Hp"], accumulate=True)
        g.index_put_((r6,), p["gp0"] + p["Hp"] @ ep, accumulate=True)
        r3 = (6 * K + 3 * torch.arange(L, device=poses.device)[:, None] + torch.arange(3, device=poses.device))
        H.index_put_((r3[:, :, None], r3[:, None, :]), p["Hl"], accumulate=True)
        g.index_put_((r3,), p["gl0"] + torch.einsum("lij,lj->li", p["Hl"], el), accumulate=True)
        f = f + prior_value(pr, poses, lms)
    return H, g, f


def solve(pr: Problem, max_iterations: int, rel_tol: float, init_lambda: float, low: bool = False):
    """The LM loop; returns (poses, landmarks, iterations, objective before, after)."""
    q = rounder(low)
    poses, lms = pr.poses, pr.landmarks
    K, L = poses.shape[0], lms.shape[0]
    free = torch.ones(6 * K + 3 * L, dtype=torch.bool, device=poses.device)
    free[:6] = False  # pose 0: the gauge
    H, g, f = linearize(pr, poses, lms, q)
    f0 = f
    if init_lambda > 0:
        lam = init_lambda
    else:
        lam = 1e-5 * max(float(H.diagonal().abs().max()) if H.numel() else 0.0, 1.0)
    nu, it = 2.0, 0
    fi = free.nonzero()[:, 0]
    while it < max_iterations:
        A = H[fi][:, fi] + lam * torch.eye(len(fi), dtype=H.dtype, device=H.device)
        delta = torch.zeros_like(g)
        delta[fi] = q(torch.linalg.solve(A.to(torch.float32) if low else A, -g[fi].to(A.dtype if not low else torch.float32)).to(H.dtype))
        p_new = geo.retract(poses, delta[:6 * K].reshape(K, 6))
        l_new = lms + delta[6 * K:].reshape(L, 3)
        H_new, g_new, f_new = linearize(pr, p_new, l_new, q)
        pred = lam * float(delta @ delta) - float(delta @ g)
        rho = float(f - f_new) / max(pred, 1e-12)
        accept = rho > 0 and bool(torch.isfinite(f_new)) and bool(torch.all(torch.isfinite(delta)))
        converged = accept and float(f - f_new) <= rel_tol * max(float(f), 1e-12)
        lam = lam * max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0) if accept else lam * nu
        if accept:
            poses, lms, H, g, f, nu = p_new, l_new, H_new, g_new, f_new, 2.0
        else:
            nu *= 2.0
        it += 1
        if converged or lam > 1e12:
            break
    return poses, lms, it, float(f0), float(f)
