"""Levenberg-Marquardt with Schur-complement landmark elimination (port of
``semantic_slam_tpu.solver.lm``, the dense path every profile runs).

Each iteration linearizes all edges at once, accumulates the block Hessian
(dense pose block ``Hpp [6K,6K]``, coupling ``W [6K,3L]``, block-diagonal
``Hll [L,3,3]``) with ``index_add_``, eliminates the landmarks with batched
closed-form 3x3 inverses, and solves the reduced pose system with a dense
Cholesky factor. Damping follows the same Nielsen gain-ratio schedule.

The JAX loop exits on the data inside a ``lax.while_loop``. Here the host
decides: each iteration fetches two flags (accepted, done) in one transfer.
The ``min_edges`` gate fetches the edge count unless ``min_edges`` is 0 (the
engine passes 0 once its host counts show the gate is passed). A failed Cholesky
(``cholesky_ex`` info != 0) turns the factor into NaN, as JAX's
``cho_factor`` does, so the step is rejected instead of raising.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.graph import residuals as res
from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.solver.robust import robust_rho, robust_weight

Tensor = torch.Tensor


class Linearization(NamedTuple):
    Hpp: Tensor  # [6K, 6K]
    W: Tensor  # [6K, 3L]
    Hll: Tensor  # [L, 3, 3]
    gp: Tensor  # [6K]
    gl: Tensor  # [3L]
    chi2: Tensor  # 0-d


class LMStats(NamedTuple):
    iterations: int  # host int: the loop runs on the host
    chi2_initial: Tensor
    chi2_final: Tensor
    lambda_final: Tensor


def inv33(A: Tensor) -> Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g_, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g_ - d * i
    A22 = a * i - c * g_
    A23 = c * d - a * f
    A31 = d * h - e * g_
    A32 = b * g_ - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def inv66(M: Tensor) -> Tensor:
    """Batched closed-form 6x6 inverse via the 2x2 block Schur complement of
    two 3x3 inverses (needs the leading 3x3 block and its complement invertible)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv33(A)
    CAi = C @ Ai
    S = D - CAi @ B
    Si = inv33(S)
    AiB = Ai @ B
    TL = Ai + AiB @ Si @ CAi
    TR = -(AiB @ Si)
    BL = -(Si @ CAi)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _block_flat_index(rows: Tensor, cols: Tensor, br: int, bc: int, n_cols: int) -> Tensor:
    """Flat indices into a row-major [*, n_cols] matrix of the [br, bc] blocks
    at block coordinates (rows[e], cols[e]); shape [E * br * bc]."""
    a = torch.arange(br, device=rows.device)
    b = torch.arange(bc, device=rows.device)
    r = rows.long()[:, None, None] * br + a[None, :, None]
    c = cols.long()[:, None, None] * bc + b[None, None, :]
    return (r * n_cols + c).reshape(-1)


def linearize_arrays(
    poses: Tensor,  # [K, 7]
    landmarks: Tensor,  # [L, 3]
    odom_i: Tensor,
    odom_j: Tensor,
    odom_meas: Tensor,
    odom_info: Tensor,
    odom_mask: Tensor,  # [E1] bool
    lme_k: Tensor,
    lme_l: Tensor,
    lme_meas: Tensor,
    lme_info: Tensor,
    lme_mask: Tensor,  # [E2] bool
    robust_kind: str = "none",
    robust_delta: float = 1.0,
) -> Linearization:
    """Edge-parallel linearization + scatter accumulation of the blocks.
    Masked-out edges contribute exactly zero."""
    K = poses.shape[0]
    L = landmarks.shape[0]
    dtype = poses.dtype
    oi, oj, lk, ll = odom_i.long(), odom_j.long(), lme_k.long(), lme_l.long()

    # --- SE3-SE3 odometry edges ------------------------------------------
    om = odom_mask.to(dtype)
    o_info = odom_info * om[:, None, None]
    r_o, Ji, Jj = res.se3_edge_residual_jac(poses[oi], poses[oj], odom_meas)
    JiT_O = torch.einsum("eai,eab->eib", Ji, o_info)  # Ji^T Omega
    JjT_O = torch.einsum("eai,eab->eib", Jj, o_info)
    H_ii = torch.einsum("eia,eaj->eij", JiT_O, Ji)
    H_ij = torch.einsum("eia,eaj->eij", JiT_O, Jj)
    H_jj = torch.einsum("eia,eaj->eij", JjT_O, Jj)
    g_i = torch.einsum("eia,ea->ei", JiT_O, r_o)
    g_j = torch.einsum("eia,ea->ei", JjT_O, r_o)
    chi_o = torch.einsum("ea,eab,eb->", r_o, o_info, r_o)

    # --- SE3-point landmark edges ----------------------------------------
    lmm = lme_mask.to(dtype)
    l_info = lme_info * lmm[:, None, None]
    r_l, Jp, Jl = res.se3_point_residual_jac(poses[lk], landmarks[ll], lme_meas)
    chi_e = torch.einsum("ea,eab,eb->e", r_l, l_info, r_l)
    # the reported objective is the robustified one (as chi2_arrays); the
    # gradient and Hessian use the IRLS-reweighted information
    chi_l = torch.sum(robust_rho(chi_e, robust_kind, robust_delta))
    if robust_kind != "none":
        w = robust_weight(chi_e, robust_kind, robust_delta).to(dtype)
        l_info = l_info * w[:, None, None]
    JpT_O = torch.einsum("eai,eab->eib", Jp, l_info)  # [E,6,3]
    JlT_O = torch.einsum("eai,eab->eib", Jl, l_info)  # [E,3,3]
    H_kk = torch.einsum("eia,eaj->eij", JpT_O, Jp)
    W_kl = torch.einsum("eia,eaj->eij", JpT_O, Jl)
    H_ll = torch.einsum("eia,eaj->eij", JlT_O, Jl)
    g_k = torch.einsum("eia,ea->ei", JpT_O, r_l)
    g_l = torch.einsum("eia,ea->ei", JlT_O, r_l)

    # --- scatter assembly -------------------------------------------------
    K6 = 6 * K
    hpp_idx = torch.cat(
        [
            _block_flat_index(oi, oi, 6, 6, K6),
            _block_flat_index(oi, oj, 6, 6, K6),
            _block_flat_index(oj, oi, 6, 6, K6),
            _block_flat_index(oj, oj, 6, 6, K6),
            _block_flat_index(lk, lk, 6, 6, K6),
        ]
    )
    hpp_val = torch.cat(
        [H_ii, H_ij, H_ij.transpose(-1, -2), H_jj, H_kk]
    ).reshape(-1)
    Hpp = torch.zeros(K6 * K6, dtype=dtype, device=poses.device)
    Hpp.index_add_(0, hpp_idx, hpp_val)
    W = torch.zeros(K6 * 3 * L, dtype=dtype, device=poses.device)
    W.index_add_(0, _block_flat_index(lk, ll, 6, 3, 3 * L), W_kl.reshape(-1))
    Hll = torch.zeros((L, 3, 3), dtype=dtype, device=poses.device)
    Hll.index_add_(0, ll, H_ll)
    gp = torch.zeros((K, 6), dtype=dtype, device=poses.device)
    gp.index_add_(0, torch.cat([oi, oj, lk]), torch.cat([g_i, g_j, g_k]))
    gl = torch.zeros((L, 3), dtype=dtype, device=poses.device)
    gl.index_add_(0, ll, g_l)
    return Linearization(
        Hpp.view(K6, K6), W.view(K6, 3 * L), Hll, gp.reshape(-1), gl.reshape(-1), chi_o + chi_l
    )


def chi2_arrays(
    poses, landmarks, odom_i, odom_j, odom_meas, odom_info, odom_mask,
    lme_k, lme_l, lme_meas, lme_info, lme_mask,
    robust_kind: str = "none", robust_delta: float = 1.0,
) -> Tensor:
    r_o = res.se3_edge_residual(poses[odom_i.long()], poses[odom_j.long()], odom_meas)
    chi_o = torch.einsum("ei,eij,ej->e", r_o, odom_info, r_o)
    r_l = res.se3_point_residual(poses[lme_k.long()], landmarks[lme_l.long()], lme_meas)
    chi_l = torch.einsum("ei,eij,ej->e", r_l, lme_info, r_l)
    chi_l = robust_rho(chi_l, robust_kind, robust_delta)
    return torch.sum(chi_o * odom_mask.to(poses.dtype)) + torch.sum(chi_l * lme_mask.to(poses.dtype))


def _edge_args(g: GraphState):
    return (
        g.odom_i, g.odom_j, g.odom_meas, g.odom_info, g.odom_mask(),
        g.lme_k, g.lme_l, g.lme_meas, g.lme_info, g.lme_mask(),
    )


def linearize(g: GraphState) -> Linearization:
    return linearize_arrays(g.poses, g.landmarks, *_edge_args(g))


def _free_masks(g: GraphState) -> tuple[Tensor, Tensor]:
    """Pose 0 is gauge-fixed (graph_slam.cpp:108); inactive slots frozen."""
    pidx = torch.arange(g.poses.shape[0], device=g.poses.device)
    pose_free = (pidx < g.num_poses) & (pidx > 0)
    return pose_free, g.landmark_mask()


def _cholesky_or_nan(H: Tensor) -> Tensor:
    """Lower Cholesky factor; all-NaN where the matrix is not positive
    definite (JAX's ``cho_factor`` semantics), without a host sync."""
    Lc, info = torch.linalg.cholesky_ex(H)
    return Lc.masked_fill(info.ne(0), float("nan"))


def _masked_coupling(lin: Linearization, pm: Tensor, lmm: Tensor) -> Tensor:
    K6 = lin.Hpp.shape[0]
    L = lin.Hll.shape[0]
    W = lin.W * pm[:, None]
    return (W.reshape(K6, L, 3) * lmm[None, :, None]).reshape(K6, 3 * L)


def _pin_inactive(Hred: Tensor, pm: Tensor) -> Tensor:
    """Hred * (pm pm^T) + diag(1 - pm), in place (pm is 0/1)."""
    Hred.mul_(pm[:, None]).mul_(pm[None, :])
    Hred.diagonal().add_(1.0 - pm)
    return Hred


def schur_solve(
    lin: Linearization, pose_free: Tensor, lm_free: Tensor, lam: Tensor
) -> tuple[Tensor, Tensor]:
    """Solve the damped normal equations by landmark Schur elimination.

    Returns (delta_pose [K,6], delta_lm [L,3]) for
      [Hpp+lam*I   W    ] [dp]   [-gp]
      [W^T    Hll+lam*I ] [dl] = [-gl]
    with fixed/inactive parameters pinned to zero update.
    """
    K6 = lin.Hpp.shape[0]
    L = lin.Hll.shape[0]
    dtype = lin.Hpp.dtype

    pm = pose_free.to(dtype).repeat_interleave(6)  # [6K]
    lmm = lm_free.to(dtype)  # [L]

    eye3 = torch.eye(3, dtype=dtype, device=lin.Hpp.device)
    A = lin.Hll + lam * eye3[None]
    A = A * lmm[:, None, None] + eye3[None] * (1.0 - lmm)[:, None, None]
    Ainv = inv33(A)
    gl = (lin.gl.reshape(L, 3) * lmm[:, None]).reshape(-1)

    W = _masked_coupling(lin, pm, lmm)
    WA = torch.einsum("kld,lde->kle", W.reshape(K6, L, 3), Ainv).reshape(K6, 3 * L)
    Hred = lin.Hpp.clone()
    Hred.diagonal().add_(lam)
    Hred = _pin_inactive(Hred - WA @ W.T, pm)
    gp = lin.gp * pm
    b_red = -(gp - WA @ gl)

    dp = torch.cholesky_solve(b_red[:, None], _cholesky_or_nan(Hred))[:, 0]

    rhs_l = (-gl - W.T @ dp).reshape(L, 3)
    dl = torch.einsum("lde,le->ld", Ainv, rhs_l) * lmm[:, None]
    return dp.reshape(-1, 6), dl


def retract(poses: Tensor, landmarks: Tensor, dp: Tensor, dl: Tensor):
    return geo.pose_retract(poses, dp.to(poses.dtype)), landmarks + dl.to(landmarks.dtype)


def run_lm_loop(
    poses: Tensor,
    landmarks: Tensor,
    linearize_fn: Callable[[Tensor, Tensor], Linearization],
    pose_free: Tensor,
    lm_free: Tensor,
    max_iterations: int,
    rel_tol: float,
    init_lambda_tau: float = 1e-5,
    init_lambda: float = 0.0,
    retract_fn: Callable = retract,
    agree: Callable = lambda t: t,
):
    """The damped LM iteration over node variables (edges fixed inside
    ``linearize_fn``). Each step relinearizes at the trial point, so the new
    linearization's chi2 is the trial objective and an accepted step costs
    one linearize; a rejected step retries the carried system with a larger
    lambda. ``init_lambda > 0`` overrides the tau*diag heuristic.
    ``retract_fn(poses, landmarks, dp, dl)`` applies a step; the plane LM
    passes its own, with ``landmarks`` a (points, planes) pair. ``agree``
    maps the iteration's flags to the ones every rank takes (on a mesh rank
    0's, broadcast; the identity on one device).

    Returns (poses, landmarks, LMStats, final linearization); the final
    linearization always matches the returned estimate.
    """
    lin = linearize_fn(poses, landmarks)
    chi2_0 = lin.chi2
    dtype = poses.dtype

    if init_lambda > 0:
        lam = torch.tensor(init_lambda, dtype=dtype, device=poses.device)
    else:
        diag_max = torch.maximum(
            lin.Hpp.diagonal().abs().max(),
            lin.Hll.diagonal(dim1=-2, dim2=-1).abs().max(),
        )
        lam = (init_lambda_tau * torch.clamp(diag_max, min=1.0)).to(dtype)

    p, l, nu, it = poses, landmarks, 2.0, 0
    while it < max_iterations:
        dp, dl = schur_solve(lin, pose_free, lm_free, lam)
        p_new, l_new = retract_fn(p, l, dp, dl)
        lin_new = linearize_fn(p_new, l_new)
        chi2_new = lin_new.chi2

        delta = torch.cat([dp.reshape(-1), dl.reshape(-1)])
        gvec = torch.cat([lin.gp, lin.gl])
        pred = lam * torch.dot(delta, delta) - torch.dot(delta, gvec)
        rho = (lin.chi2 - chi2_new) / torch.clamp(pred, min=1e-12)
        finite = torch.isfinite(chi2_new) & torch.all(torch.isfinite(delta))
        accept = (rho > 0) & finite

        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_acc, lam * nu)
        converged = accept & ((lin.chi2 - chi2_new) <= rel_tol * torch.clamp(lin.chi2, min=1e-12))
        done = converged | (lam > 1e12)
        # the one host fetch of the iteration: it decides the carry and the exit
        accepted, stop = agree(torch.stack([accept, done])).tolist()
        if accepted:
            p, l, lin, nu = p_new, l_new, lin_new, 2.0
        else:
            nu *= 2.0
        it += 1
        if stop:
            break
    return p, l, LMStats(it, chi2_0, lin.chi2, lam), lin


def lm_optimize(
    g: GraphState,
    max_iterations: int = 64,
    min_edges: int = 10,
    rel_tol: float = 1e-6,
    robust_kind: str = "none",
    robust_delta: float = 1.0,
    init_lambda: float = 0.0,
    with_marginals: bool = False,
):
    """Full-batch LM over the active graph (g2o GraphSLAM::optimize analog).

    Skips when fewer than ``min_edges`` edges exist (graph_slam.cpp:184-186):
    the graph comes back unchanged with ``iterations == 0``, the current
    chi2 as both chi2 values, and no marginals (None). The JAX version runs
    its loop there and discards the result, so only its ``lambda_final``
    and marginals differ on a skipped solve, and no caller reads them.
    ``with_marginals=True`` also returns the landmark marginal 3x3 blocks
    from the loop's final linearization.
    """
    pose_free, lm_free = _free_masks(g)
    edges = _edge_args(g)

    def lin_fn(p, l):
        return linearize_arrays(p, l, *edges, robust_kind=robust_kind, robust_delta=robust_delta)

    if min_edges > 0 and int(g.num_edges()) < min_edges:  # fetches the count
        chi2 = chi2_arrays(g.poses, g.landmarks, *edges, robust_kind=robust_kind, robust_delta=robust_delta)
        stats = LMStats(0, chi2, chi2, torch.zeros_like(chi2))
        return (g, stats, None) if with_marginals else (g, stats)

    poses, landmarks, stats, lin_f = run_lm_loop(
        g.poses, g.landmarks, lin_fn, pose_free, lm_free,
        max_iterations, rel_tol, init_lambda=init_lambda,
    )
    g = g.replace(poses=poses, landmarks=landmarks)
    if with_marginals:
        return g, stats, marginals_from_lin(lin_f, pose_free, lm_free)
    return g, stats


def marginals_from_lin(lin: Linearization, pose_free: Tensor, lm_free: Tensor) -> Tensor:
    """Landmark marginal 3x3 blocks from an existing linearization:
    Sigma_ll = Hll^-1 + Hll^-1 W^T Hred^-1 W Hll^-1 (diagonal blocks only).
    Inactive slots get identity."""
    K6 = lin.Hpp.shape[0]
    L = lin.Hll.shape[0]
    dtype = lin.Hpp.dtype

    pm = pose_free.to(dtype).repeat_interleave(6)
    lmm = lm_free.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=lin.Hpp.device)

    A = lin.Hll * lmm[:, None, None] + eye3[None] * (1.0 - lmm)[:, None, None]
    Ainv = inv33(A + 1e-8 * eye3[None])

    W = _masked_coupling(lin, pm, lmm)
    WA = torch.einsum("kld,lde->kle", W.reshape(K6, L, 3), Ainv).reshape(K6, 3 * L)
    Hred = _pin_inactive(lin.Hpp - WA @ W.T, pm)

    Y = torch.cholesky_solve(WA, _cholesky_or_nan(Hred))
    corr = torch.einsum("kld,kle->lde", WA.reshape(K6, L, 3), Y.reshape(K6, L, 3))
    sigma = Ainv + corr
    return sigma * lmm[:, None, None] + eye3[None] * (1.0 - lmm)[:, None, None]


def landmark_marginals(g: GraphState) -> Tensor:
    """Marginal covariances at the current estimate (fresh linearization)."""
    pose_free, lm_free = _free_masks(g)
    return marginals_from_lin(linearize(g), pose_free, lm_free)
