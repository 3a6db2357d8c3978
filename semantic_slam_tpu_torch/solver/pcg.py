"""Per-pose (ELL) edge layout and matrix-free landmark marginals (port of the
subset of ``semantic_slam_tpu.solver.pcg`` that the SoA Schur-PCG path uses).

Landmark observations are stored in a dense per-pose grid ``[K, R]`` (R =
the static per-keyframe bound, empty slots info-masked) and odometry as the
chain it is (row k holds the edge k -> k+1). Conversion from the graph's
``[E]`` edge arrays happens once per solve: indices do not change inside the
LM loop. Contract (``build_slots``): the real prefix of ``lme_k`` is sorted
with at most R entries per pose, and odometry edge e joins poses (i, i+1); a
non-chain odometry edge is dropped from the system, exactly. The engine
builds no other kind.

The marginal recovery eliminates the poses, not the landmarks: the pose
block of a chain graph is exactly block tridiagonal, so parallel cyclic
reduction (``solver/tridiag.py``) applies its inverse, and only the
landmark-reduced information ``S = Hll - W^T Hpp^-1 W`` ([3L, 3L], bounded by
the landmark table) is factored densely. Nothing dense grows with the
trajectory. A fixed-lag prior's off-diagonal boundary coupling joins by a
Woodbury fold (``prior_woodbury``). Over a mesh the pose rows are split:
``soa_dist.range_marginal_parts`` sums each rank's W columns and chain
couplings (the JAX package's ``landmark_marginals_mf_ellk`` with
``allreduce``/``shard``) and ``_sigma_from_chain_parts`` finishes on the
controller.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.solver import fixed_lag as fl
from semantic_slam_tpu_torch.solver import tridiag as td
from semantic_slam_tpu_torch.solver.lm import _cholesky_or_nan

Tensor = torch.Tensor


def build_slots(idx: Tensor, mask: Tensor, n: int, r: int) -> Tensor:
    """[n, r] slot table for a sorted, bounded segment index vector (port of
    ``assembly.build_slots``): slot positions into the edge axis, -1 where
    empty. ``mask`` marks the real edges (a prefix); the masked prefix of
    ``idx`` must be nondecreasing with at most ``r`` entries per value."""
    key = torch.where(mask, idx.long(), n)
    counts = torch.bincount(key, minlength=n + 1)[:n]
    hi = torch.cumsum(counts, 0)
    lo = hi - counts
    slots = lo[:, None] + torch.arange(r, device=idx.device)[None, :]
    return torch.where(slots < hi[:, None], slots, -1)


class EllEdges(NamedTuple):
    """Static per-solve edge data in per-pose layout."""

    ll: Tensor  # [K, R] landmark index per slot (0 where empty), int64
    meas: Tensor  # [K, R, 3]
    info: Tensor  # [K, R, 3, 3], zeroed on empty slots
    o_meas: Tensor  # [K, 7] odometry measurement of edge k -> k+1
    o_info: Tensor  # [K, 6, 6], zeroed where no chain edge leaves k
    o_w: Tensor  # [K] chain-edge mask (float)


class EllBlocks(NamedTuple):
    """Per-pose-layout Hessian blocks, trimmed to what the marginal recovery
    reads (the JAX type also carries H_ii/H_jj/H_kk for its matvec)."""

    ll: Tensor  # [K, R]
    H_ij: Tensor  # [K, 6, 6] chain edge k -> k+1
    W_kl: Tensor  # [K, R, 6, 3]
    Hll: Tensor  # [L, 3, 3]
    diag: Tensor  # [K, 6, 6]


def _gat(a: Tensor, e: Tensor) -> Tensor:
    """a[e] with -1 reading a zero pad row."""
    ap = torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=a.device)])
    return ap[torch.where(e >= 0, e, a.shape[0])]


def build_ell_edges(edge_args: tuple, K: int, R: int) -> EllEdges:
    """[E]-layout edge arrays -> per-pose layout, once per solve."""
    (oi, oj, o_meas, o_info, o_mask, lk, ll, l_meas, l_info, l_mask) = edge_args
    dtype = l_meas.dtype
    dev = l_meas.device
    slots = build_slots(lk, l_mask, K, R)  # [K, R]
    valid = (slots >= 0).to(dtype)
    ll_e = _gat(ll.long(), slots)  # pad rows read index 0; their info is zeroed
    meas_e = _gat(l_meas, slots)
    info_e = _gat(l_info, slots) * valid[:, :, None, None]

    so = build_slots(oi, o_mask, K, 1)[:, 0]  # [K]
    oj_e = _gat(oj.long(), so)
    # a slot whose edge does not go k -> k+1 is dropped (never mis-attributed)
    o_w = ((so >= 0) & (oj_e == torch.arange(K, device=dev) + 1)).to(dtype)
    # empty/dropped rows carry the identity measurement: a zero quaternion
    # would NaN the (masked) Jacobian rows, and NaN * 0 stays NaN
    ident = torch.zeros(7, dtype=dtype, device=dev)
    ident[3] = 1.0
    o_meas_e = torch.where(o_w[:, None] > 0, _gat(o_meas, so), ident[None, :])
    o_info_e = _gat(o_info, so) * o_w[:, None, None]
    return EllEdges(ll=ll_e, meas=meas_e, info=info_e, o_meas=o_meas_e, o_info=o_info_e, o_w=o_w)


class EllEdgesPlanes(NamedTuple):
    """SE3-plane edges in per-pose layout ([K, R4] slots; the point slots are
    the loop's own edge store)."""

    pl: Tensor  # [K, R4] plane index per slot (0 where empty), int64
    pmeas: Tensor  # [K, R4, 4], the unit plane on empty slots
    pinfo: Tensor  # [K, R4, 3, 3], zeroed on empty slots
    valid: Tensor  # [K, R4] bool, the real slots


# Pad rows past a plane table that the empty plane slots' zeros are summed
# into, spread over all of them: index_add_ on the card adds with atomics,
# and one row for every empty slot (most of the [K, R4] grid) serializes them.
PLANE_SPREAD = 256


def plane_sum_index(eep: EllEdgesPlanes, Pl: int) -> Tensor:
    """[Kr R4]: the row of each slot's term in a plane-table sum
    (``plane_table_sum``): its plane id, or for an empty slot one of the
    ``PLANE_SPREAD`` pad rows past the table."""
    n = eep.pl.numel()
    pad = Pl + torch.arange(n, device=eep.pl.device) % PLANE_SPREAD
    return torch.where(eep.valid.reshape(-1), eep.pl.reshape(-1), pad)


def plane_table_sum(idx: Tensor, vals: Tensor, Pl: int) -> Tensor:
    """The plane table [Pl, ...] of the per-slot terms ``vals`` [Kr R4, ...]
    summed at the rows ``idx`` of ``plane_sum_index``."""
    out = vals.new_zeros((Pl + PLANE_SPREAD,) + vals.shape[1:])
    return out.index_add_(0, idx, vals)[:Pl]


def unit_plane_rows(planes: Tensor) -> Tensor:
    """``planes [..., 4]`` with all-zero rows (an empty slot's, an inactive
    plane's) replaced by the unit plane [0, 0, 1, 0]: a zero normal makes
    the plane-tangent Jacobians NaN, and NaN * 0 stays NaN under the
    slot's zero information."""
    unit = planes.new_tensor([0.0, 0.0, 1.0, 0.0])
    return torch.where(torch.sum(planes[..., :3] * planes[..., :3], dim=-1, keepdim=True) > 1e-12, planes, unit)


def build_ell_edges_planes(plane_args: tuple, K: int, R4: int) -> EllEdgesPlanes:
    """``(pe_k, pe_p, pe_meas, pe_info, pe_mask)`` -> per-pose layout, once
    per solve (the plane half of ``pcg.build_ell_edges_planes``; its point
    half is ``build_ell_edges``). The masked prefix of ``pe_k`` must be
    sorted with at most R4 edges per pose (``build_slots``)."""
    pe_k, pe_p, pe_meas, pe_info, pe_mask = plane_args
    slots = build_slots(pe_k, pe_mask, K, R4)
    valid = (slots >= 0).to(pe_meas.dtype)
    return EllEdgesPlanes(
        pl=_gat(pe_p.long(), slots),
        pmeas=unit_plane_rows(_gat(pe_meas, slots)),
        pinfo=_gat(pe_info, slots) * valid[:, :, None, None],
        valid=slots >= 0,
    )


def plane_slot_blocks(poses: Tensor, planes: Tensor, eep: EllEdgesPlanes, robust_kind: str = "none",
                      robust_delta: float = 1.0):
    """The plane slots' blocks of pose rows ``poses [Kr, 7]``
    (``graph/planes.plane_edge_blocks`` over [Kr, R4]): (robust chi2,
    H_kk, W_kp, H_pp, g_k, g_p)."""
    from semantic_slam_tpu_torch.graph.planes import plane_edge_blocks

    pw = unit_plane_rows(planes[eep.pl])
    return plane_edge_blocks(poses[:, None, :].expand(-1, eep.pl.shape[1], -1), pw, eep.pmeas, eep.pinfo,
                             robust_kind, robust_delta)


def ell_linearize_planes(eb: EllBlocks, poses: Tensor, planes: Tensor, eep: EllEdgesPlanes,
                         robust_kind: str = "none", robust_delta: float = 1.0) -> EllBlocks:
    """The point blocks ``eb`` with the plane slots appended, block ids
    offset by L: ``ll [K, R+R4]``, ``W_kl``, ``Hll [L+Pl]`` and the
    diagonal. The marginal recovery then runs unchanged over the B = L + Pl
    blocks (the per-pose analog of the dense plane linearization)."""
    L, Pl = eb.Hll.shape[0], planes.shape[0]
    _, H_kk, W_kp, H_pp, _, _ = plane_slot_blocks(poses, planes, eep, robust_kind, robust_delta)
    Hll_p = plane_table_sum(plane_sum_index(eep, Pl), H_pp.reshape(-1, 3, 3), Pl)
    return EllBlocks(
        ll=torch.cat([eb.ll, eep.pl + L], dim=1),
        H_ij=eb.H_ij,
        W_kl=torch.cat([eb.W_kl, W_kp.to(eb.W_kl.dtype)], dim=1),
        Hll=torch.cat([eb.Hll, Hll_p.to(eb.Hll.dtype)]),
        diag=eb.diag + H_kk.sum(dim=1).to(eb.diag.dtype),
    )


def apply_prior_blocks_planes(eb: EllBlocks, prior: fl.MarginalPrior) -> EllBlocks:
    """The prior's plane information on the appended plane rows ``Hll[L:]``
    of plane-extended blocks (``ell_linearize_planes``), trimmed to what the
    marginal recovery reads: its pose and point parts are folded before the
    plane slots append (``apply_prior_blocks`` on the point
    linearization)."""
    Pl = prior.Hpl.shape[0]
    return eb._replace(Hll=torch.cat([eb.Hll[:-Pl], eb.Hll[-Pl:] + prior.Hpl.to(eb.Hll.dtype)]) if Pl else eb.Hll)


def _edge_args(g: GraphState):
    return (
        g.odom_i, g.odom_j, g.odom_meas, g.odom_info, g.odom_mask(),
        g.lme_k, g.lme_l, g.lme_meas, g.lme_info, g.lme_mask(),
    )


def _ell_chain_upper(eb: EllBlocks, pose_free: Tensor) -> Tensor:
    """Chain coupling blocks: upper[k] joins poses (k, k+1); couplings
    touching fixed poses are zeroed."""
    pf = pose_free.to(eb.H_ij.dtype)
    pf_next = torch.cat([pf[1:], torch.zeros_like(pf[:1])])
    return eb.H_ij * (pf * pf_next)[:, None, None]


def apply_prior_blocks(blocks, prior: fl.MarginalPrior, poses: Tensor, landmarks: Tensor):
    """Fold a fixed-lag prior into a linearization in channel form: any
    NamedTuple with ``gp [6,K]``, ``diag [6,6,K]``, ``gl [L,3]``,
    ``Hll [L,3,3]`` and ``chi2`` (``ellk_soa.SoALin``, the row-range loop's
    reduced state). The gradient, the diagonal blocks and the landmark part
    only: the dense boundary block ``Hp`` is applied by the matvec. Every
    addition lands on replicated (post-reduction) fields. This is the JAX
    package's ``pcg.apply_prior_blocks`` and ``ellk_soa.apply_prior_soa_k``
    in one: the port's SoA linearization has only the channel layout."""
    dtype = blocks.gp.dtype
    PB = prior.max_poses
    idx = prior.p_idx.long()
    gp_add, gl_add, chi_pr = fl.prior_fold_terms(prior, poses, landmarks, dtype)
    return blocks._replace(
        gp=blocks.gp.index_add(1, idx, gp_add.reshape(PB, 6).T.to(dtype)),
        diag=blocks.diag.index_add(2, idx, fl.prior_pose_diag(prior).permute(1, 2, 0).to(dtype)),
        gl=blocks.gl + gl_add.to(dtype),
        Hll=blocks.Hll + prior.Hl.to(dtype),
        chi2=blocks.chi2 + chi_pr.to(blocks.chi2.dtype),
    )


def landmark_marginals_mf_ellk(eb: EllBlocks, pose_free: Tensor, block_free: Tensor,
                               prior: fl.MarginalPrior | None = None) -> Tensor:
    """Matrix-free landmark marginal 3x3 blocks [L,3,3] from per-pose-layout
    blocks (inactive landmarks get identity). With a fixed-lag ``prior``,
    ``eb`` already holds its diagonal blocks and landmark part
    (``apply_prior_blocks``), and its off-diagonal boundary coupling is
    folded here."""
    K, R = eb.ll.shape
    B = eb.Hll.shape[0]
    dtype = eb.diag.dtype
    pf = pose_free.to(dtype)
    lmf = block_free.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=pf.device)
    Dm = eb.diag * pf[:, None, None] + eye6[None] * (1.0 - pf)[:, None, None]
    fac = td.pcr_factor(Dm, _ell_chain_upper(eb, pose_free))

    # W columns [K, 6, 3B]: slot (k, r) adds its [6,3] block at column ll[k,r]
    W_m = eb.W_kl * (pf[:, None] * lmf[eb.ll])[:, :, None, None]
    kl = (torch.arange(K, device=pf.device)[:, None] * B + eb.ll).reshape(-1)
    Ukl = torch.zeros((K * B, 6, 3), dtype=dtype, device=pf.device)
    Ukl.index_add_(0, kl, W_m.reshape(K * R, 6, 3))
    U = Ukl.view(K, B, 6, 3).permute(0, 2, 1, 3).reshape(K, 6, 3 * B)
    return _sigma_from_chain_parts(fac, U, eb.Hll, pose_free, block_free, dtype, prior)


def _sigma_from_chain_parts(fac, U: Tensor, Hll: Tensor, pose_free: Tensor, block_free: Tensor, dtype,
                            prior: fl.MarginalPrior | None = None) -> Tensor:
    """Invert the landmark-reduced information S = Hll - W^T Hpp^-1 W, given
    the factored pose-chain tridiagonal and the W columns U [K,6,3B], and
    return its diagonal 3x3 blocks."""
    B = Hll.shape[0]
    pf = pose_free.to(dtype)
    lmf = block_free.to(dtype)
    dev = U.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    X = td.pcr_solve_cols(fac, U)  # T^-1 W
    if prior is not None:
        X = prior_woodbury(fac, X, prior, pf)

    UtX = torch.einsum("kac,kad->cd", U, X)
    A = Hll * lmf[:, None, None] + eye3[None] * (1.0 - lmf)[:, None, None]
    bidx3 = torch.arange(B, device=dev)
    S = (-UtX).reshape(B, 3, B, 3)
    S[bidx3, :, bidx3, :] += A
    S = S * (lmf[:, None] * lmf[None, :])[:, None, :, None]
    S[bidx3, :, bidx3, :] += eye3[None] * (1.0 - lmf)[:, None, None]
    S = S.reshape(3 * B, 3 * B)
    S = 0.5 * (S + S.T) + 1e-8 * torch.eye(3 * B, dtype=dtype, device=dev)
    Sigma = torch.cholesky_inverse(_cholesky_or_nan(S))
    sigma = Sigma.reshape(B, 3, B, 3)[bidx3, :, bidx3, :]
    sigma = 0.5 * (sigma + sigma.transpose(-1, -2))
    return sigma * lmf[:, None, None] + eye3[None] * (1.0 - lmf)[:, None, None]


def prior_woodbury(fac, X: Tensor, prior: fl.MarginalPrior, pf: Tensor) -> Tensor:
    """Hpp^-1 W from T^-1 W (``X`` [K,6,3B], T the factored chain
    tridiagonal) when Hpp also holds the prior's off-diagonal boundary
    coupling: Hpp = T + Sel (Hp - blockdiag Hp) Sel^T, Sel selecting the
    p_idx rows (the block diagonal is already inside T). Boundary poses
    outside the mask ``pf`` drop out."""
    K, B3 = X.shape[0], X.shape[2]
    dtype, dev = X.dtype, X.device
    PB = prior.max_poses
    idx = prior.p_idx.long()
    bidx = torch.arange(PB, device=dev)
    Hp = prior.Hp.to(dtype)
    bd = Hp.reshape(PB, 6, PB, 6)[bidx, :, bidx, :]  # [PB, 6, 6]
    bd_embed = (bd[:, :, None, :] * torch.eye(PB, dtype=dtype, device=dev)[:, None, :, None]).reshape(6 * PB, 6 * PB)
    Delta = Hp - bd_embed
    E = torch.zeros((K, 6, PB, 6), dtype=dtype, device=dev)
    E[idx, :, bidx, :] = torch.eye(6, dtype=dtype, device=dev)[None] * pf[idx][:, None, None]
    TiS = td.pcr_solve_cols(fac, E.reshape(K, 6, 6 * PB))  # T^-1 Sel
    M = TiS[idx].reshape(6 * PB, 6 * PB)  # Sel^T T^-1 Sel
    SX = X[idx].reshape(6 * PB, B3)  # Sel^T X
    G = torch.linalg.solve(torch.eye(6 * PB, dtype=dtype, device=dev) + Delta @ M, Delta @ SX)
    return X - torch.einsum("kac,cd->kad", TiS, G)
