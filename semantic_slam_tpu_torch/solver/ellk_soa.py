"""Structure-of-arrays Schur-PCG LM (port of ``semantic_slam_tpu.solver.ellk_soa``
for one device, block-Jacobi or block-tridiagonal preconditioner).

Landmark slots live in channel tensors ``[C, R, K]`` (slot (r, k) is the r-th
observation of pose k; r-major, so slot e = r*K + k), the odometry chain in
``[6, 6, K]``. The observation Hessian blocks are never materialized: with
``Jp = [-I | hat(v)]``, ``Jl = Rt``, ``O' = w*O`` every product the solver
needs factors through ``(v, O', Rt)``.

The three per-iteration steps have a plain PyTorch version here and a CUDA
kernel in ``solver/kernels.py`` (the loop calls the kernels' wrappers, which
run these plain versions on CPU tensors):

  * ``soa_linearize``  -- K1 + K2, observation (``soa_obs_linearize``) and
    chain (``soa_chain_linearize``) linearization;
  * ``soa_chi2``       -- K3, the trial-point objective;
  * ``soa_schur_step`` -- K4, the damped Schur-reduced PCG solve and the
    landmark back-substitution.

With ``precond_kind="tridiag"`` the solve is ``soa_schur_step_tridiag``
instead, the JAX package's XLA branch (neither K4 nor the TPU kernel has a
tridiagonal preconditioner), in plain PyTorch; K1-K3 still run.

The TPU path's one-hot landmark factors and digit vectors are not ported:
landmark gathers are indexed loads, and landmark sums are ``index_add_``
here and a landmark CSR (``SoAEdges.lm_slots``/``lm_start``) in the
kernels. The CG runs ``n_steps`` fixed steps under the kernel's ``active``
mask (an inactive step leaves x, r, p and rz unchanged), which gives the
JAX early-exit loop's result with no host sync.

A fixed-lag prior (``solver/fixed_lag.py``) folds into every linearization
(``pcg.apply_prior_blocks``: gradient, diagonal blocks, landmark part, chi2),
its chi2 joins the trial objective outside K3, and its dense boundary block
``Hp`` is applied inside the matvec: in K4's kernel on the card, in
``_soa_matvec_inner`` here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.solver import chain_soa as chs
from semantic_slam_tpu_torch.solver import fixed_lag as fl
from semantic_slam_tpu_torch.solver import tridiag as td
from semantic_slam_tpu_torch.solver.lm import LMStats, _free_masks, inv33, inv66
from semantic_slam_tpu_torch.solver.pcg import (
    EllBlocks,
    EllEdges,
    _edge_args,
    apply_prior_blocks,
    build_ell_edges,
    build_slots,
    landmark_marginals_mf_ellk,
)
from semantic_slam_tpu_torch.solver.robust import robust_rho, robust_weight

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# channelwise small-matrix helpers
# ---------------------------------------------------------------------------

# the JAX module unrolls these over the channel dims to fill TPU lanes; here
# each is one batched op (the same math up to summation order)


def _m33_mul(A, B):
    return torch.einsum("ik...,kj...->ij...", A, B)


def _m33T_mul(A, B):
    return torch.einsum("ki...,kj...->ij...", A, B)


def _m33_vec(A, x):
    return torch.einsum("ij...,j...->i...", A, x)


def _m33T_vec(A, x):
    return torch.einsum("ji...,j...->i...", A, x)


_m66_vec = _m33_vec
_m66T_vec = _m33T_vec


def _cross(v, x):
    return torch.linalg.cross(v, x, dim=0)


def _rotmat_conj_channels(qw, qx, qy, qz):
    """Rt = R(q)^T channels [3,3,...]."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)
    r10, r11, r12 = 2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)
    r20, r21, r22 = 2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)
    return torch.stack(
        [torch.stack([r00, r10, r20]), torch.stack([r01, r11, r21]), torch.stack([r02, r12, r22])]
    )


def _roll_up_soa(x):
    """[.., K]: position k <- x[k+1] (last = 0): the chain successor."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _shift_down_soa(x):
    """[.., K]: position k <- x[k-1] (first = 0)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _ob_product(O, v):
    """O @ hat(v)."""
    c0 = torch.stack([O[i][1] * v[2] - O[i][2] * v[1] for i in range(3)])
    c1 = torch.stack([-O[i][0] * v[2] + O[i][2] * v[0] for i in range(3)])
    c2 = torch.stack([O[i][0] * v[1] - O[i][1] * v[0] for i in range(3)])
    return torch.stack([c0, c1, c2], dim=1)


def _assemble_h66(TL, TR, BR):
    """[[TL, TR],[TR^T, BR]] from [3,3,...] quadrants -> [6,6,...]."""
    rows = [torch.stack([*(TL[i][j] for j in range(3)), *(TR[i][j] for j in range(3))]) for i in range(3)]
    rows += [torch.stack([*(TR[j][i] for j in range(3)), *(BR[i][j] for j in range(3))]) for i in range(3)]
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# SoA edge store + linearization
# ---------------------------------------------------------------------------


class SoAEdges(NamedTuple):
    """Per-solve static edge data, big axes last."""

    ll: Tensor  # [K, R] landmark index per slot (0 where empty), int64
    ll_rk: Tensor  # [R, K] int32, the same index r-major (the kernels' gather)
    meas: Tensor  # [3, R, K]
    info: Tensor  # [3, 3, R, K], zeroed on empty slots
    o_meas_ch: Tensor  # [7, K] chain measurement of edge k -> k+1
    o_info_ch: Tensor  # [6, 6, K] chain information, zeroed on rows without an edge
    # landmark CSR over the E = R*K slots: landmark l owns the real slots
    # lm_slots[lm_start[l]:lm_start[l+1]] (slot ids r*K+k, ascending); the
    # kernels sum each landmark's slots in this fixed order. Empty slots sort
    # last, past lm_start[L].
    lm_slots: Tensor  # [E] int32
    lm_start: Tensor  # [L+1] int32


class SoALin(NamedTuple):
    """One linearization: factored observation primitives, chain blocks and
    the assembled per-pose (channel form) and per-landmark reductions."""

    v: Tensor  # [3, R, K]  v = Rt (l - t)
    Ow: Tensor  # [3, 3, R, K]  robust-weighted, mask-zeroed O'
    Rt: Tensor  # [3, 3, K]  R(q)^T per pose
    Hii: Tensor  # [6, 6, K] chain blocks
    Hij: Tensor
    Hjj: Tensor
    Hll: Tensor  # [L, 3, 3]
    gp: Tensor  # [6, K]
    gl: Tensor  # [L, 3]
    diag: Tensor  # [6, 6, K]
    chi2: Tensor  # 0-d


def build_soa_edges(edge_args: tuple, K: int, R: int, L: int) -> SoAEdges:
    """Graph edge arrays -> SoA layout plus the landmark CSR, once per solve
    (indices do not change inside the LM loop). No host sync."""
    valid = build_slots(edge_args[5], edge_args[9], K, R) >= 0  # [K, R]
    return soa_edges_from_ell(build_ell_edges(edge_args, K, R), valid, L)


def soa_edges_from_ell(ee: EllEdges, valid: Tensor, L: int) -> SoAEdges:
    """Per-pose edge rows ``ee`` ([Kr, R], any run of pose rows) and their
    real-slot mask ``valid`` [Kr, R] -> SoA layout with a landmark CSR over
    these rows' slots only (slot ids r*Kr + k)."""
    dev = ee.meas.device
    ll_rk = ee.ll.T.contiguous()  # [R, Kr]
    key = torch.where(valid.T, ll_rk, L).reshape(-1)  # empty slots sort last
    key_sorted, order = torch.sort(key, stable=True)
    lm_start = torch.searchsorted(key_sorted, torch.arange(L + 1, device=dev))
    return SoAEdges(
        ll=ee.ll,
        ll_rk=ll_rk.to(torch.int32),
        meas=ee.meas.permute(2, 1, 0).contiguous(),
        info=ee.info.permute(2, 3, 1, 0).contiguous(),
        o_meas_ch=ee.o_meas.T.contiguous(),
        o_info_ch=ee.o_info.permute(1, 2, 0).contiguous(),
        lm_slots=order.to(torch.int32),
        lm_start=lm_start.to(torch.int32),
    )


def _seg_sum(ll: Tensor, vals_ch: Tensor, L: int) -> Tensor:
    """Landmark segment sum of [D, R, K] slot channels -> [L, D]."""
    D = vals_ch.shape[0]
    flat = vals_ch.permute(2, 1, 0).reshape(-1, D)  # [K*R, D], ll's order
    return torch.zeros((L, D), dtype=vals_ch.dtype, device=vals_ch.device).index_add_(0, ll.reshape(-1), flat)


def _gather(ll: Tensor, table: Tensor) -> Tensor:
    """[L, D] landmark table -> [D, R, K] slot channels."""
    return table[ll].permute(2, 1, 0)


def _chain_inputs(poses: Tensor, se: SoAEdges):
    t_i = poses[:, :3].T
    q_i = poses[:, 3:7].T
    return (t_i, q_i, chs.roll_up_pose_ch(t_i), chs.roll_up_pose_ch(q_i), se.o_meas_ch[:3], se.o_meas_ch[3:7],
            se.o_info_ch)


def _obs_residual(poses: Tensor, landmarks: Tensor, se: SoAEdges):
    """(Rt [3,3,K], v [3,R,K], r [3,R,K], O r, chi_e [R,K]) of every slot."""
    Rt = _rotmat_conj_channels(poses[:, 3], poses[:, 4], poses[:, 5], poses[:, 6])
    v = _m33_vec(Rt[:, :, None, :], _gather(se.ll, landmarks) - poses[:, :3].T[:, None, :])
    r = v - se.meas
    Or = _m33_vec(se.info, r)
    chi_e = sum(r[i] * Or[i] for i in range(3))
    return Rt, v, r, Or, chi_e


class ChainLin(NamedTuple):
    """The odometry chain's linearization: blocks of edge k -> k+1."""

    Hii: Tensor  # [6, 6, K]
    Hij: Tensor
    Hjj: Tensor
    gi: Tensor  # [6, K]
    gj: Tensor
    chi2: Tensor  # 0-d


def soa_chain_linearize(poses: Tensor, se: SoAEdges) -> ChainLin:
    """Plain version of the K2 kernel: the chain linearization."""
    Hii, Hij, Hjj, gi, gj, chi_k = chs.chain_linearize_ch(*_chain_inputs(poses, se))
    return ChainLin(Hii, Hij, Hjj, gi, gj, torch.sum(chi_k))


def soa_obs_linearize(poses: Tensor, landmarks: Tensor, se: SoAEdges, chain: ChainLin, robust_kind: str = "none",
                      robust_delta: float = 1.0) -> SoALin:
    """Plain version of the K1 kernel: the observation linearization, folded
    with the chain's blocks into the per-pose gradient and diagonal."""
    v, Ow, Rt, gp_obs, diag_obs, gl, Hll, chi_l = obs_parts(poses, landmarks, se, robust_kind, robust_delta)
    return SoALin(
        v=v, Ow=Ow, Rt=Rt, Hii=chain.Hii, Hij=chain.Hij, Hjj=chain.Hjj, Hll=Hll,
        gp=gp_obs + chain.gi + _shift_down_soa(chain.gj), gl=gl,
        diag=diag_obs + chain.Hii + _shift_down_soa(chain.Hjj),
        chi2=chain.chi2 + chi_l,
    )


def obs_parts(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none", robust_delta: float = 1.0):
    """The observation half of the linearization over the poses of ``se``:
    (v, O', Rt, gp_obs [6,K], diag_obs [6,6,K], gl [L,3], Hll [L,3,3],
    robust chi2), the landmark sums over these poses' slots only."""
    L = landmarks.shape[0]
    Rt, v, r, Or, chi_e = _obs_residual(poses, landmarks, se)
    chi_l = torch.sum(robust_rho(chi_e, robust_kind, robust_delta))
    if robust_kind != "none":
        w = robust_weight(chi_e, robust_kind, robust_delta).to(poses.dtype)
        Ow = se.info * w[None, None]
        Or = Or * w[None]
    else:
        Ow = se.info
    # gradients: g_k = [-(O'r); -v x (O'r)],  g_l = Rt^T (O'r)
    gp_obs = torch.cat([torch.sum(-Or, dim=1), torch.sum(-_cross(v, Or), dim=1)])  # [6, K]
    Rt4 = Rt[:, :, None, :]
    gl = _seg_sum(se.ll, _m33T_vec(Rt4, Or), L)
    Hll_e = _m33T_mul(Rt4, _m33_mul(Ow, Rt4))  # Rt^T O' Rt per slot
    Hll = _seg_sum(se.ll, Hll_e.reshape(9, *Hll_e.shape[2:]), L).reshape(L, 3, 3)
    # pose diagonal: [[O', -O'B],[(-O'B)^T, -hat(v) O'B]], B = hat(v)
    OB = _ob_product(Ow, v)
    diag_obs = torch.sum(_assemble_h66(Ow, -OB, -chs.hat_mul(v, OB)), dim=2)
    return v, Ow, Rt, gp_obs, diag_obs, gl, Hll, chi_l


def soa_linearize(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none",
                  robust_delta: float = 1.0) -> SoALin:
    """Plain version of the K1 + K2 kernels: observation and chain
    linearization, channelwise."""
    return soa_obs_linearize(poses, landmarks, se, soa_chain_linearize(poses, se), robust_kind, robust_delta)


def soa_chi2(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none",
             robust_delta: float = 1.0) -> Tensor:
    """Plain version of the K3 kernel: the objective alone (the LM trial
    point), the same math as ``soa_linearize(...).chi2``."""
    chi_o = torch.sum(chs.chain_chi2_ch(*_chain_inputs(poses, se)))
    chi_e = _obs_residual(poses, landmarks, se)[4]
    return chi_o + torch.sum(robust_rho(chi_e, robust_kind, robust_delta))


# ---------------------------------------------------------------------------
# matvec / Schur step
# ---------------------------------------------------------------------------


def _obs_apply_jp(v, x):
    """Jp x for every slot: a = -x[:3] + v x x[3:]  ([3, R, K]); x [6, K]."""
    xr = x[3:, None, :].expand_as(v)
    return -x[:3, None, :] + _cross(v, xr)


def _obs_apply_jpT(v, y):
    """Jp^T y for every slot, summed over R: [6, K]."""
    return torch.cat([-torch.sum(y, dim=1), -torch.sum(_cross(v, y), dim=1)])


def soa_mv_fwd(v: Tensor, Ow: Tensor, Rt: Tensor, ll: Tensor, x: Tensor, L: int) -> tuple[Tensor, Tensor]:
    """First half of the Schur matvec (the K8 kernel's math): per slot
    Oa = O' (Jp x) [3, R, K], and per landmark T = sum Rt^T Oa [L, 3] over
    the slots of ``ll`` [K, R]. ``x`` [6, K] is already masked."""
    Oa = _m33_vec(Ow, _obs_apply_jp(v, x))
    return Oa, _seg_sum(ll, _m33T_vec(Rt[:, :, None, :], Oa), L)


def soa_mv_bwd(v: Tensor, Ow: Tensor, Rt: Tensor, ll: Tensor, Oa: Tensor, z: Tensor, x: Tensor, xj: Tensor,
               Hii: Tensor, Hij: Tensor, Hjj: Tensor) -> tuple[Tensor, Tensor]:
    """Second half (the K9 kernel's math), given z = A^-1 T [L, 3]:
    u = Jp^T (Oa - O' Rt z) + Hii x + Hij xj and the chain's j-column
    vj = Hij^T x + Hjj xj, unshifted (row k belongs to pose k+1)."""
    m = Oa - _m33_vec(Ow, _m33_vec(Rt[:, :, None, :], _gather(ll, z)))
    u = _obs_apply_jpT(v, m) + (_m66_vec(Hii, x) + _m66_vec(Hij, xj))
    return u, _m66T_vec(Hij, x) + _m66_vec(Hjj, xj)


def prior_matvec(u: Tensor, x: Tensor, prior_Hp: Tensor, prior_idx: Tensor) -> Tensor:
    """u [6, K] plus the dense boundary prior's product: the rows ``prior_idx``
    gain ``Hp x[:, prior_idx]`` for the masked x [6, K]. Padded slots repeat
    index 0 with all-zero rows, so repeated indices add."""
    idx = prior_idx.long()
    add = (prior_Hp.to(x.dtype) @ x[:, idx].T.reshape(-1)).reshape(-1, 6)
    return u.index_add(1, idx, add.T)


def _soa_matvec_inner(lin: SoALin, ll: Tensor, Ainv: Tensor, lam, pf_soa: Tensor, x: Tensor,
                      prior_Hp: Tensor | None = None, prior_idx: Tensor | None = None) -> Tensor:
    """The damped reduced operator (Hpp - W A^-1 W^T [+ the prior's Hp] +
    lam I) x on [6, K]."""
    x = x * pf_soa
    Oa, t = soa_mv_fwd(lin.v, lin.Ow, lin.Rt, ll, x, Ainv.shape[0])
    z = torch.einsum("lij,lj->li", Ainv, t)
    u, vj = soa_mv_bwd(lin.v, lin.Ow, lin.Rt, ll, Oa, z, x, _roll_up_soa(x), lin.Hii, lin.Hij, lin.Hjj)
    u = u + _shift_down_soa(vj)
    if prior_Hp is not None:
        u = prior_matvec(u, x, prior_Hp, prior_idx)
    return (u + lam * x) * pf_soa


def _masked_eye(M: Tensor, lam, free: Tensor, n: int) -> Tensor:
    """(M + lam I) * free + I * (1 - free) for [N, n, n] blocks."""
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    return (M + lam * eye) * free[:, None, None] + eye * (1.0 - free)[:, None, None]


# the tridiagonal solves fetch their CG's convergence flag once every this many
# steps and stop when it is down (the block-Jacobi steps never fetch)
TRIDIAG_CHECK_EVERY = 8


def _schur_pcg(lin: SoALin, se: SoAEdges, lam, pf: Tensor, lmf: Tensor, precond: Callable, max_cg_iters: int,
               cg_tol: float, prior_Hp: Tensor | None, prior_idx: Tensor | None,
               check_every: int = 0) -> tuple[Tensor, Tensor]:
    """The damped Schur-reduced PCG under the preconditioner ``precond``
    ([6, K] -> [6, K]) over ``max_cg_iters`` masked steps, then the landmark
    back-substitution: (dp [K,6], db [L,3]). With ``check_every`` the loop
    fetches the convergence flag before every ``check_every``-th step and
    stops once it is down; the masked steps it skips would leave the state
    as it is, so the result is the same."""
    pf_soa = pf[None, :]
    Rt4 = lin.Rt[:, :, None, :]

    Ainv = inv33(_masked_eye(lin.Hll, lam, lmf, 3))
    gl = lin.gl * lmf[:, None]
    y = torch.einsum("lij,lj->li", Ainv, gl)
    c = _obs_apply_jpT(lin.v, _m33_vec(lin.Ow, _m33_vec(Rt4, _gather(se.ll, y))))  # sum_r W y
    b = -(lin.gp - c) * pf_soa

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b2 = torch.clamp(torch.sum(b * b), min=1e-30)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for step in range(max_cg_iters):
        active = torch.sum(r * r) > cg_tol * b2
        if check_every and step % check_every == 0 and not bool(active):  # a host fetch
            break
        Ap = _soa_matvec_inner(lin, se.ll, Ainv, lam, pf_soa, p, prior_Hp, prior_idx)
        alpha = torch.where(active, rz / torch.clamp(torch.sum(p * Ap), min=1e-30), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), zero)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)

    dpk = x * pf_soa
    wd = _m33T_vec(Rt4, _m33_vec(lin.Ow, _obs_apply_jp(lin.v, dpk)))  # W^T dp per slot
    t = _seg_sum(se.ll, wd, lin.gl.shape[0])
    db = torch.einsum("lij,lj->li", Ainv, -gl - t) * lmf[:, None]
    return dpk.T, db


def soa_schur_step(lin: SoALin, se: SoAEdges, lam, pose_free: Tensor, block_free: Tensor,
                   max_cg_iters: int, cg_tol: float = 1e-8, prior_Hp: Tensor | None = None,
                   prior_idx: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Plain version of the K4 kernel: damped Schur-reduced PCG (jacobi)
    over ``max_cg_iters`` fixed steps, then the landmark back-substitution.
    With a fixed-lag prior (``prior_Hp [6PB,6PB]``, ``prior_idx [PB]``) the
    matvec adds the dense boundary block; ``lin`` already carries the
    prior's gradient, diagonal and landmark part. Returns (dp [K,6],
    db [L,3])."""
    pf = pose_free.to(lin.gp.dtype)
    Minv = inv66(_masked_eye(lin.diag.permute(2, 0, 1), lam, pf, 6)).permute(1, 2, 0)

    def precond(r):
        return _m66_vec(Minv, r) * pf[None, :]

    return _schur_pcg(lin, se, lam, pf, block_free.to(pf.dtype), precond, max_cg_iters, cg_tol, prior_Hp, prior_idx)


def chain_tridiag_factor(diag: Tensor, Hij: Tensor, lam, pf: Tensor) -> td.PCRFactor:
    """The damped odometry-chain block tridiagonal, factored by parallel
    cyclic reduction (``solver/tridiag.py``): the diagonal blocks ``diag``
    [K,6,6] plus lam I (identity at fixed poses), the chain's couplings
    ``Hij`` [K,6,6] (row k joins poses k and k+1) zeroed where either pose
    is fixed (the JAX package's ``ellk_soa.py:661-672``)."""
    D = _masked_eye(diag, lam, pf, 6)
    pf_next = torch.cat([pf[1:], torch.zeros_like(pf[:1])])
    return td.pcr_factor(D, Hij * (pf * pf_next)[:, None, None])


def soa_schur_step_tridiag(lin: SoALin, se: SoAEdges, lam, pose_free: Tensor, block_free: Tensor,
                           max_cg_iters: int, cg_tol: float = 1e-8, prior_Hp: Tensor | None = None,
                           prior_idx: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The resident loop's solve with the block-tridiagonal preconditioner
    (``pcg_precond="tridiag"``): the JAX package's XLA branch of
    ``soa_schur_step`` (K4, like the TPU kernel, has no such
    preconditioner), in plain PyTorch on any device. The CG is ``_schur_pcg``
    with ``chain_tridiag_factor``'s solve in place of the block-Jacobi one,
    stopping at its tolerance (checked every ``TRIDIAG_CHECK_EVERY`` steps:
    the JAX loop's early exit); the signature is ``soa_schur_step``'s."""
    pf = pose_free.to(lin.gp.dtype)
    fac = chain_tridiag_factor(lin.diag.permute(2, 0, 1), lin.Hij.permute(2, 0, 1), lam, pf)

    def precond(r):
        return td.pcr_solve(fac, r.T).T * pf[None, :]

    return _schur_pcg(lin, se, lam, pf, block_free.to(pf.dtype), precond, max_cg_iters, cg_tol, prior_Hp, prior_idx,
                      check_every=TRIDIAG_CHECK_EVERY)


# ---------------------------------------------------------------------------
# LM loop
# ---------------------------------------------------------------------------


class SoAOps(NamedTuple):
    """The three steps of an LM iteration: (linearize, solve, chi2), with the
    signatures of ``soa_linearize``, ``soa_schur_step`` and ``soa_chi2``
    (K3's objective has no prior term: the loop adds it)."""

    linearize: Callable
    solve: Callable
    chi2: Callable


PLAIN_OPS = SoAOps(soa_linearize, soa_schur_step, soa_chi2)


def kernel_ops(precond_kind: str = "jacobi") -> SoAOps:
    """The kernels' wrappers (``solver/kernels.py``): the plain versions on
    CPU tensors, the CUDA kernels on CUDA tensors. With ``precond_kind=
    "tridiag"`` the solve is ``soa_schur_step_tridiag`` (K1-K3 still
    linearize and score; K4 does not launch)."""
    from semantic_slam_tpu_torch.solver import kernels

    solve = {"jacobi": kernels.resident_solve, "tridiag": soa_schur_step_tridiag}[precond_kind]
    return SoAOps(kernels.resident_linearize, solve, kernels.resident_chi2)


def run_lm_loop_soa(
    poses: Tensor, landmarks: Tensor, se: SoAEdges, pose_free: Tensor, lm_free: Tensor,
    max_iterations: int, rel_tol: float, max_cg_iters: int = 128, init_lambda_tau: float = 1e-5,
    robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0, cg_tol: float = 1e-8,
    ops: SoAOps | None = None, prior: fl.MarginalPrior | None = None,
):
    """The Nielsen LM on the SoA layout. Each iteration linearizes at the
    accepted state (K1+K2), solves (K4) and evaluates the trial point (K3);
    the loop also linearizes once before it (the lambda seed) and once after
    it (the final blocks, for the marginals). So K1+K2 run iterations + 2
    times, K3 and K4 iterations times. The one host fetch per iteration is
    the (accepted, done) pair. ``ops`` defaults to the kernels' wrappers;
    ``PLAIN_OPS`` runs the plain versions on any device (the yardstick the
    kernels are held against on the card). A fixed-lag ``prior`` folds into
    every linearization, joins each trial objective and goes to K4 as
    ``(Hp, p_idx)``; K1-K4 launch as often as without it.

    Returns (poses, landmarks, LMStats, final linearization)."""
    ops = ops or kernel_ops()
    prior_args = () if prior is None else (prior.Hp, prior.p_idx)

    def build(p, l):
        lin = ops.linearize(p, l, se, robust_kind, robust_delta)
        return lin if prior is None else apply_prior_blocks(lin, prior, p, l)

    def chi2_at(p, l):
        chi = ops.chi2(p, l, se, robust_kind, robust_delta)
        return chi if prior is None else chi + fl.prior_chi2(prior, p, l).to(chi.dtype)

    dtype = poses.dtype
    lin0 = build(poses, landmarks)
    chi2_0 = lin0.chi2
    if init_lambda > 0:
        lam = torch.tensor(init_lambda, dtype=dtype, device=poses.device)
    else:
        diag_max = torch.maximum(
            lin0.diag.diagonal(dim1=0, dim2=1).abs().max(), lin0.Hll.diagonal(dim1=-2, dim2=-1).abs().max()
        )
        lam = (init_lambda_tau * torch.clamp(diag_max, min=1.0)).to(dtype)

    p, l, chi2_cur, nu, it = poses, landmarks, chi2_0, 2.0, 0
    while it < max_iterations:
        lin = build(p, l)
        dp, dl = ops.solve(lin, se, lam, pose_free, lm_free, max_cg_iters, cg_tol, *prior_args)
        p_new = geo.pose_retract(p, dp.to(dtype))
        l_new = l + dl.to(dtype)
        chi2_new = chi2_at(p_new, l_new)

        delta = torch.cat([dp.reshape(-1), dl.reshape(-1)])
        gvec = torch.cat([lin.gp.T.reshape(-1), lin.gl.reshape(-1)])
        pred = lam * torch.dot(delta, delta) - torch.dot(delta, gvec)
        rho = (chi2_cur - chi2_new) / torch.clamp(pred, min=1e-12)
        finite = torch.isfinite(chi2_new) & torch.all(torch.isfinite(delta))
        accept = (rho > 0) & finite
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_acc, lam * nu)
        converged = accept & ((chi2_cur - chi2_new) <= rel_tol * torch.clamp(chi2_cur, min=1e-12))
        done = converged | (lam > 1e12)
        accepted, stop = torch.stack([accept, done]).tolist()  # the iteration's one host fetch
        if accepted:
            p, l, chi2_cur, nu = p_new, l_new, chi2_new, 2.0
        else:
            nu *= 2.0
        it += 1
        if stop:
            break
    return p, l, LMStats(it, chi2_0, chi2_cur, lam), build(p, l)


def soa_to_ell_blocks(lin: SoALin, se: SoAEdges) -> EllBlocks:
    """The per-pose blocks the marginal recovery reads:
    W_kl = [[-O'Rt], [-hat(v) O'Rt]] per slot, H_ij and the diagonal."""
    ORt = _m33_mul(lin.Ow, lin.Rt[:, :, None, :])
    Wk = torch.cat([-ORt, -chs.hat_mul(lin.v, ORt)], dim=0)  # [6,3,R,K]
    return EllBlocks(
        ll=se.ll,
        H_ij=lin.Hij.permute(2, 0, 1),
        W_kl=Wk.permute(3, 2, 0, 1),
        Hll=lin.Hll,
        diag=lin.diag.permute(2, 0, 1),
    )


def lm_optimize_soa(
    g: GraphState, max_iterations: int = 64, min_edges: int = 10, rel_tol: float = 1e-6,
    max_cg_iters: int = 128, robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0,
    with_marginals: bool = False, ell_rows: tuple = (1, 1, 8), cg_tol: float = 1e-8,
    prior: fl.MarginalPrior | None = None, precond_kind: str = "jacobi",
):
    """Single-device matrix-free LM (drop-in for ``lm.lm_optimize``), with an
    optional fixed-lag ``prior`` and the CG's preconditioner ``precond_kind``
    (``"jacobi"``, in K4, or ``"tridiag"``, ``soa_schur_step_tridiag``).

    Below ``min_edges`` edges the graph comes back unchanged with
    ``iterations == 0`` (the count is fetched unless ``min_edges`` is 0, as
    in ``lm.lm_optimize``). ``with_marginals=True`` also returns the landmark
    marginals, recovered matrix-free from the loop's final linearization."""
    pose_free, lm_free = _free_masks(g)
    se = build_soa_edges(_edge_args(g), g.poses.shape[0], ell_rows[2], g.landmarks.shape[0])
    if min_edges > 0 and int(g.num_edges()) < min_edges:  # fetches the count
        chi2 = kernel_ops().chi2(g.poses, g.landmarks, se, robust_kind, robust_delta)
        if prior is not None:
            chi2 = chi2 + fl.prior_chi2(prior, g.poses, g.landmarks).to(chi2.dtype)
        stats = LMStats(0, chi2, chi2, torch.zeros_like(chi2))
        return (g, stats, None) if with_marginals else (g, stats)

    poses, landmarks, stats, lin_f = run_lm_loop_soa(
        g.poses, g.landmarks, se, pose_free, lm_free, max_iterations, rel_tol, max_cg_iters,
        robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda, cg_tol=cg_tol, prior=prior,
        ops=kernel_ops(precond_kind),
    )
    g = g.replace(poses=poses, landmarks=landmarks)
    if with_marginals:
        return g, stats, landmark_marginals_mf_ellk(soa_to_ell_blocks(lin_f, se), pose_free, lm_free, prior)
    return g, stats


def landmark_marginals_graph(g: GraphState, ell_rows: tuple, prior: fl.MarginalPrior | None = None) -> Tensor:
    """Matrix-free marginals at the current estimate (one fresh
    linearization, through the K1+K2 wrapper, with the prior folded in):
    on-demand export of covariances on profiles whose ticks skip the
    recovery."""
    pose_free, lm_free = _free_masks(g)
    se = build_soa_edges(_edge_args(g), g.poses.shape[0], ell_rows[2], g.landmarks.shape[0])
    lin = kernel_ops().linearize(g.poses, g.landmarks, se, "none", 1.0)
    if prior is not None:
        lin = apply_prior_blocks(lin, prior, g.poses, g.landmarks)
    return landmark_marginals_mf_ellk(soa_to_ell_blocks(lin, se), pose_free, lm_free, prior)
