"""Large-K SoA LM loop over a row range of poses (port of
``semantic_slam_tpu.solver.soa_dist``: one device, or several ranks of a
mesh, ``parallel/dist.py``).

The loop is the JAX package's distributed one: poses, landmarks and the CG
vectors are replicated ``[*, K]``/``[L, *]``, and the edge primitives cover
one contiguous run of pose rows ``[off, off + Kl)`` (on one device the whole
graph, ``off = 0``; on rank r of n ranks ``off = r K / n``, the
``sharded_lm_optimize_soa(_planes)`` entries). Every per-range step hands
partial results to the host, which inserts ``allreduce`` (the identity on
one device; the mesh's all-reduce across ranks):

  * the linearization (kernels K6 + K7, ``tiled_linearize``: one call of
    two launches, the chain as blocks of the first): the per-pose gradient
    and diagonal with the chain's i-side folded in and its j-side
    ``gj``/``Hjj`` left unshifted, and the landmark tables gl/Hll and chi2
    summed over the range's slots only;
  * the matvec's first half (K8, ``tiled_mv_fwd``): Oa per slot and the
    landmark table T = sum Rt^T Oa over the range;
  * its second half (K9, ``tiled_mv_bwd``): u and the chain's j-column vj,
    unshifted; the host embeds both at ``off`` (``_dus``), reduces, and
    applies the pose-axis shift on the reduced array, so the last row of one
    range lands on the first row of the next;
  * the trial objective (K10, ``tiled_chi2``).

The chain's successor pose comes from the host (``roll_up_pose_ch`` of the
replicated poses, sliced to the range), which lets a range's last row see
the next range's first pose. The plain versions of K6-K10 are the
``*_plain`` functions here (the JAX loop's XLA channel-math branch); the
kernels' wrappers in ``solver/tiled_kernels.py`` run them on CPU tensors.

The CG's preconditioner is block-Jacobi, or with ``precond_kind="tridiag"``
the damped odometry-chain block tridiagonal over all rows, factored by
parallel cyclic reduction once per solve (plain PyTorch, as the JAX package
leaves it to XLA; the JAX engine's TPU route takes no preconditioner choice
here, its CPU route honours it through ``pcg.lm_optimize_pcg``).

The block-Jacobi CG is a fixed count of ``max_cg_iters`` steps under an
``active`` mask (an inactive step leaves x, r, p and rz unchanged), which
gives the JAX early-exit loop's result with no host fetch; the tridiagonal
one, which reaches its tolerance in a few steps, fetches the mask every
``ellk_soa.TRIDIAG_CHECK_EVERY`` steps and stops once it is down (the same
result). The LM fetches its (accepted, done) pair once per iteration. The vector work between the
kernels (z = A^-1 T, the shift, the preconditioner, the dots and updates)
is plain PyTorch, as the JAX package leaves it to XLA.

A fixed-lag prior stays outside the kernels, as in the JAX loop: it is folded
once into the replicated post-reduction state of each linearization
(``pcg.apply_prior_blocks``), its chi2 joins each trial objective after the
reduction, and its dense boundary block joins the matvec after K9's
reduction and the shift. That order is what a multi-device loop needs: every
device adds the same terms to the same replicated arrays.

Plane landmarks (``lm_optimize_soa_planes``) ride the same loop as a plane
half in plain PyTorch, as the JAX package computes it in XLA outside its
kernels: the range's SE3-plane slots ([Kl, R4], rows of
``pcg.EllEdgesPlanes``, taken by plain index gathers where the JAX package
has one-hot factors) are linearized once per LM iteration into W blocks [Kl, R4, 6, 3], the pose
diagonal and gradient, and the plane tables Hpl/gpl [Pl, *] (reduced like
the landmark tables). In the matvec, W^T x per slot is summed into the plane
table beside K8's T (the pair is one reduction), z_pl = A_pl^-1 T_pl, and
-W z_pl joins K9's u; the slots' pose blocks ride K9's chain diagonal Hii,
which K9 applies to x. The plane blocks are Schur-eliminated like the
landmark blocks; the step's plane rows retract by ``plane_retract``.

Reference: graph_slam.cpp:182-219 (the lm_var loop).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.graph import residuals as res
from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.solver import chain_soa as chs
from semantic_slam_tpu_torch.solver import ellk_soa as soa
from semantic_slam_tpu_torch.solver import fixed_lag as fl
from semantic_slam_tpu_torch.solver import tridiag as td
from semantic_slam_tpu_torch.solver.ellk_soa import (
    ChainLin,
    SoAEdges,
    _m66_vec,
    _masked_eye,
    _shift_down_soa,
    prior_matvec,
)
from semantic_slam_tpu_torch.solver.lm import LMStats, _free_masks, inv33, inv66
from semantic_slam_tpu_torch.solver.pcg import (
    EllEdges,
    EllEdgesPlanes,
    _edge_args,
    apply_prior_blocks,
    apply_prior_blocks_planes,
    build_ell_edges,
    build_ell_edges_planes,
    build_slots,
    ell_linearize_planes,
    landmark_marginals_mf_ellk,
    plane_slot_blocks,
    plane_sum_index,
    plane_table_sum,
    unit_plane_rows,
)
from semantic_slam_tpu_torch.solver.plane_ba import plane_retract
from semantic_slam_tpu_torch.solver.robust import robust_rho

Tensor = torch.Tensor

# The engine's crossover: pcg solves with more poses than this take the
# row-range loop, the rest the resident loop (``ellk_soa.lm_optimize_soa``).
TILED_FROM_K = 4096


def build_dist_edges(edge_args: tuple, K: int, R: int, L: int, off: int = 0, Kl: int | None = None) -> SoAEdges:
    """The edge store of pose rows ``[off, off + Kl)`` (default: all K) in
    the SoA layout ``[C, R, Kl]``, with a landmark CSR over these rows'
    slots only, built once per solve. Row ``off + Kl - 1``'s chain edge
    points at pose ``off + Kl``, which the host supplies."""
    Kl = K - off if Kl is None else Kl
    if off < 0 or Kl <= 0 or off + Kl > K:
        raise ValueError(f"build_dist_edges: rows [{off}, {off + Kl}) are not inside [0, {K})")
    ee = build_ell_edges(edge_args, K, R)
    valid = build_slots(edge_args[5], edge_args[9], K, R) >= 0
    rows = slice(off, off + Kl)
    return soa.soa_edges_from_ell(EllEdges(*(a[rows] for a in ee)), valid[rows], L)


def build_plane_dist(plane_args: tuple, K: int, R4: int, off: int = 0, Kl: int | None = None) -> EllEdgesPlanes:
    """The plane slots of pose rows ``[off, off + Kl)`` (default: all K) from
    ``(pe_k, pe_p, pe_meas, pe_info, pe_mask)``, built once per solve."""
    Kl = K - off if Kl is None else Kl
    if off < 0 or Kl <= 0 or off + Kl > K:
        raise ValueError(f"build_plane_dist: rows [{off}, {off + Kl}) are not inside [0, {K})")
    eep = build_ell_edges_planes(plane_args, K, R4)
    return EllEdgesPlanes(*(a[off:off + Kl] for a in eep))


def plane_args(pn) -> tuple:
    return (pn.pe_k, pn.pe_p, pn.pe_meas, pn.pe_info, pn.pe_mask())


def plane_chi2(poses_loc: Tensor, planes: Tensor, pe: EllEdgesPlanes, robust_kind: str = "none",
               robust_delta: float = 1.0) -> Tensor:
    """The robust chi2 of the range's plane slots at poses ``poses_loc``
    [Kl, 7] (an empty slot's information is 0)."""
    R4 = pe.pl.shape[1]
    r = res.se3_plane_residual(poses_loc[:, None, :].expand(-1, R4, -1), unit_plane_rows(planes[pe.pl]), pe.pmeas)
    return torch.sum(robust_rho(torch.einsum("kra,krab,krb->kr", r, pe.pinfo, r), robust_kind, robust_delta))


def _dus(vec_loc: Tensor, off: int, Kg: int) -> Tensor:
    """Embed a [..., Kl] row-range block at pose row ``off`` of a [..., Kg]
    zero array (the pre-reduction embedding)."""
    if vec_loc.shape[-1] == Kg:
        return vec_loc
    out = vec_loc.new_zeros(vec_loc.shape[:-1] + (Kg,))
    out[..., off:off + vec_loc.shape[-1]] = vec_loc
    return out


def _slice_k(x: Tensor, off: int, Kl: int) -> Tensor:
    """[..., Kg] -> the row range [..., Kl] at ``off``."""
    return x[..., off:off + Kl]


# ---------------------------------------------------------------------------
# the plain versions of K6-K10 (pose channels pc/pj [7, Kl]: t rows 0-2,
# q rows 3-6; pj is each row's chain successor)
# ---------------------------------------------------------------------------


class TiledLin(NamedTuple):
    """One linearization of a row range (``pallas_tiled.tiled_linearize``'s
    contract, channel layouts of ``ellk_soa.SoALin``)."""

    v: Tensor  # [3, R, Kl]
    Ow: Tensor  # [3, 3, R, Kl]
    Rt: Tensor  # [3, 3, Kl]
    Hii: Tensor  # [6, 6, Kl] chain blocks of edge k -> k+1
    Hij: Tensor
    Hjj: Tensor  # unshifted: the host adds it to pose k+1 after the reduction
    gp: Tensor  # [6, Kl] observation gradient + gi
    gj: Tensor  # [6, Kl] unshifted, like Hjj
    diag: Tensor  # [6, 6, Kl] observation diagonal + Hii
    gl: Tensor  # [L, 3] over the range's slots only
    Hll: Tensor  # [L, 3, 3] over the range's slots only
    chi2: Tensor  # 0-d, the range's observation and chain terms


def chain_plain(pc: Tensor, pj: Tensor, de: SoAEdges) -> ChainLin:
    """Plain version of K7: the chain linearization of each row against its
    supplied successor."""
    Hii, Hij, Hjj, gi, gj, chi_k = chs.chain_linearize_ch(
        pc[:3], pc[3:], pj[:3], pj[3:], de.o_meas_ch[:3], de.o_meas_ch[3:], de.o_info_ch
    )
    return ChainLin(Hii, Hij, Hjj, gi, gj, torch.sum(chi_k))


def obs_plain(pc: Tensor, landmarks: Tensor, de: SoAEdges, chain: ChainLin, robust_kind: str = "none",
              robust_delta: float = 1.0) -> TiledLin:
    """Plain version of K6: the observation linearization of the range, with
    the chain's i-side (gi, Hii) folded in and its j-side left out."""
    v, Ow, Rt, gp_obs, diag_obs, gl, Hll, chi_l = soa.obs_parts(pc.T, landmarks, de, robust_kind, robust_delta)
    return TiledLin(
        v=v, Ow=Ow, Rt=Rt, Hii=chain.Hii, Hij=chain.Hij, Hjj=chain.Hjj, gp=gp_obs + chain.gi, gj=chain.gj,
        diag=diag_obs + chain.Hii, gl=gl, Hll=Hll, chi2=chi_l + chain.chi2,
    )


def mv_fwd_plain(lin: TiledLin, de: SoAEdges, x: Tensor) -> tuple[Tensor, Tensor]:
    """Plain version of K8: (Oa [3, R, Kl], T [L, 3] over the range) for the
    masked x [6, Kl]."""
    return soa.soa_mv_fwd(lin.v, lin.Ow, lin.Rt, de.ll, x, lin.gl.shape[0])


def mv_bwd_plain(lin: TiledLin, de: SoAEdges, Oa: Tensor, z: Tensor, x: Tensor, xj: Tensor) -> tuple[Tensor, Tensor]:
    """Plain version of K9: (u, vj) [6, Kl], vj unshifted."""
    return soa.soa_mv_bwd(lin.v, lin.Ow, lin.Rt, de.ll, Oa, z, x, xj, lin.Hii, lin.Hij, lin.Hjj)


def chi2_plain(pc: Tensor, pj: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str = "none",
               robust_delta: float = 1.0) -> Tensor:
    """Plain version of K10: the range's robust observation and chain chi2."""
    chi_o = torch.sum(chs.chain_chi2_ch(
        pc[:3], pc[3:], pj[:3], pj[3:], de.o_meas_ch[:3], de.o_meas_ch[3:], de.o_info_ch
    ))
    chi_e = soa._obs_residual(pc.T, landmarks, de)[4]
    return chi_o + torch.sum(robust_rho(chi_e, robust_kind, robust_delta))


class TiledOps(NamedTuple):
    """The row-range steps, with the signatures of ``chain_plain`` +
    ``obs_plain`` (``linearize(pc, pj, landmarks, de, kind, delta)``),
    ``mv_fwd_plain``, ``mv_bwd_plain`` and ``chi2_plain``."""

    linearize: Callable
    mv_fwd: Callable
    mv_bwd: Callable
    chi2: Callable


def _linearize_plain(pc, pj, landmarks, de, robust_kind="none", robust_delta=1.0) -> TiledLin:
    return obs_plain(pc, landmarks, de, chain_plain(pc, pj, de), robust_kind, robust_delta)


PLAIN_OPS = TiledOps(_linearize_plain, mv_fwd_plain, mv_bwd_plain, chi2_plain)


def kernel_ops() -> TiledOps:
    """The kernels' wrappers (``solver/tiled_kernels.py``): the plain
    versions on CPU tensors, the CUDA kernels K6-K10 on CUDA tensors."""
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    return TiledOps(tk.tiled_linearize, tk.tiled_mv_fwd, tk.tiled_mv_bwd, tk.tiled_chi2)


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------


def _identity(a):
    return a


class _LinG(NamedTuple):
    """One linearization after the reduction: the range's primitives for the
    matvec and the replicated, j-side-folded gradient and diagonal; with
    planes, the range's plane W blocks and the replicated plane tables."""

    lin: TiledLin
    gp: Tensor  # [6, Kg]
    diag: Tensor  # [6, 6, Kg]
    gl: Tensor  # [L, 3]
    Hll: Tensor  # [L, 3, 3]
    chi2: Tensor
    Wa: Tensor | None = None  # [Kl, 3 R4, 6]: W^T per pose row (W^T x is one batched product)
    Wb: Tensor | None = None  # [Kl, 6, 3 R4]: W per pose row
    gpl: Tensor | None = None  # [Pl, 3]
    Hpl: Tensor | None = None  # [Pl, 3, 3]


def plane_wT_x(Wa: Tensor, x_loc: Tensor, pl_sum: Tensor, Pl: int) -> Tensor:
    """The plane half of the matvec's first half: W^T x of every plane slot
    of the range (``Wa`` [Kl, 3 R4, 6], one batched product), summed into
    the plane table [Pl, 3] at the rows ``pl_sum`` (``pcg.plane_sum_index``)."""
    return plane_table_sum(pl_sum, torch.bmm(Wa, x_loc.T.unsqueeze(-1)).reshape(-1, 3), Pl)


def plane_w_z(Wb: Tensor, z_pl: Tensor, pl_flat: Tensor) -> Tensor:
    """Its second half: W z_pl, z_pl [Pl, 3] gathered per slot and summed
    over each pose's slots (``Wb`` [Kl, 6, 3 R4], one batched product): [6, Kl]."""
    Kl = Wb.shape[0]
    return torch.bmm(Wb, z_pl[pl_flat].reshape(Kl, Wb.shape[2], 1))[..., 0].T


def run_lm_loop_soa_dist(
    poses: Tensor, landmarks: Tensor, pose_free: Tensor, lm_free: Tensor, de: SoAEdges,
    max_iterations: int, rel_tol: float, max_cg_iters: int = 32, init_lambda_tau: float = 1e-5,
    robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0, prior=None,
    cg_tol: float = 1e-8, allreduce: Callable = _identity, off: int = 0, ops: TiledOps | None = None,
    pe: EllEdgesPlanes | None = None, planes: Tensor | None = None, plane_free: Tensor | None = None,
    precond_kind: str = "jacobi", agree: Callable = _identity, final_lin: bool = False,
):
    """The Nielsen LM over the replicated state with the edge primitives of
    rows ``[off, off + Kl)`` (``de``). ``allreduce`` takes a tensor or a
    tuple of tensors and returns the sums over all ranges (the identity on
    one device); ``agree`` maps a tensor of host decisions to the one every
    range takes (on a mesh rank 0's, broadcast: the loop's flags and the
    tridiagonal CG's stop test). ``ops`` defaults to the kernels' wrappers;
    ``PLAIN_OPS`` runs the plain versions on any device. With ``pe`` (the
    range's plane slots), ``planes`` [Pl, 4] and ``plane_free`` [Pl] the
    plane half joins the solve (module docstring). ``final_lin=True`` also
    returns a fresh linearization (``_LinG``) at the final state, last.

    Per LM iteration: one linearization (K6 + K7; the first iteration reuses
    the damping seed's, built at the same state), the right-hand side (K9),
    ``max_cg_iters`` CG steps (K8 and K9 each), the back-substitution (K8)
    and the trial objective (K10); a fixed-lag ``prior`` and the plane half
    add no launch of these kernels.
    Returns (poses, landmarks, LMStats), with planes (poses, landmarks,
    planes, LMStats)."""
    has_planes = pe is not None
    if has_planes != (planes is not None) or has_planes != (plane_free is not None):
        raise ValueError("run_lm_loop_soa_dist: pe, planes and plane_free come together")
    ops = ops or kernel_ops()
    dtype = poses.dtype
    Kg, L = poses.shape[0], landmarks.shape[0]
    Kl = de.ll.shape[0]
    pf = pose_free.to(dtype)[None, :]  # [1, Kg]
    lmf = lm_free.to(dtype)
    if has_planes:
        Pl, R4 = planes.shape[0], pe.pl.shape[1]
        plf = plane_free.to(dtype)
        pl_flat = pe.pl.reshape(-1)  # the gathers' index
        pl_sum = plane_sum_index(pe, Pl)  # the sums'

    def pose_channels(p):
        pc = p.T
        return _slice_k(pc, off, Kl), _slice_k(chs.roll_up_pose_ch(pc), off, Kl)

    def plane_lin(p, pl):
        """The range's plane slots, once per linearization: the W blocks in
        both batched-product layouts, the pose gradient and diagonal
        [6, Kl] / [6, 6, Kl], the plane tables and the robust chi2."""
        chi, H_kk, W_kp, H_pp, g_k, g_p = plane_slot_blocks(_slice_k(p.T, off, Kl).T, pl, pe, robust_kind,
                                                            robust_delta)
        Hpl = plane_table_sum(pl_sum, H_pp.reshape(-1, 3, 3), Pl)
        gpl = plane_table_sum(pl_sum, g_p.reshape(-1, 3), Pl)
        Wb = W_kp.permute(0, 2, 1, 3).reshape(Kl, 6, 3 * R4)
        return (Wb.transpose(1, 2).contiguous(), Wb.contiguous(), g_k.sum(dim=1).T,
                H_kk.sum(dim=1).permute(1, 2, 0), gpl, Hpl, chi)

    def build(p, l, pl=None):
        pc, pj = pose_channels(p)
        lin = ops.linearize(pc, pj, l, de, robust_kind, robust_delta)
        gp_loc, diag_loc, chi_loc = lin.gp, lin.diag, lin.chi2
        extra = ()
        if has_planes:
            Wa, Wb, gp_add, diag_add, gpl, Hpl, chi_p = plane_lin(p, pl)
            gp_loc, diag_loc, chi_loc = gp_loc + gp_add, diag_loc + diag_add, chi_loc + chi_p.to(chi_loc.dtype)
            # K9 applies Hii x per row: the plane slots' pose blocks ride it
            lin = lin._replace(Hii=lin.Hii + diag_add.to(lin.Hii.dtype))
            extra = (gpl, Hpl)
        out = allreduce((
            _dus(gp_loc, off, Kg), _dus(lin.gj, off, Kg), _dus(diag_loc, off, Kg), _dus(lin.Hjj, off, Kg),
            lin.gl, lin.Hll, chi_loc, *extra,
        ))
        gp_e, gj_e, dg_e, hj_e, gl, Hll, chi = out[:7]
        lg = _LinG(lin, gp_e + _shift_down_soa(gj_e), dg_e + _shift_down_soa(hj_e), gl, Hll, chi)
        if has_planes:
            lg = lg._replace(Wa=Wa, Wb=Wb, gpl=out[7], Hpl=out[8])
        if prior is None:
            return lg
        lg = apply_prior_blocks(lg, prior, p, l)
        if has_planes:
            chi_pl, gpl_add = fl._plane_prior_terms(prior, pl)
            lg = lg._replace(gpl=lg.gpl + gpl_add.to(dtype), Hpl=lg.Hpl + prior.Hpl.to(dtype),
                             chi2=lg.chi2 + chi_pl.to(lg.chi2.dtype))
        return lg

    def chi2_at(p, l, pl=None):
        pc, pj = pose_channels(p)
        chi_loc = ops.chi2(pc, pj, l, de, robust_kind, robust_delta)
        if has_planes:
            chi_pl = plane_chi2(_slice_k(p.T, off, Kl).T, pl, pe, robust_kind, robust_delta)
            chi_loc = chi_loc + chi_pl.to(chi_loc.dtype)
        chi = allreduce(chi_loc)
        if prior is not None:
            chi = chi + fl.prior_chi2(prior, p, l).to(chi.dtype)
            if has_planes:
                chi = chi + fl._plane_prior_terms(prior, pl)[0].to(chi.dtype)
        return chi

    def solve(lg: _LinG, lam):
        lin, gp, diag, gl, Hll = lg.lin, lg.gp, lg.diag, lg.gl, lg.Hll
        Ainv = inv33(_masked_eye(Hll, lam, lmf, 3))  # [L, 3, 3]
        if precond_kind == "jacobi":
            Minv = inv66(_masked_eye(diag.permute(2, 0, 1), lam, pf[0], 6)).permute(1, 2, 0)
        if has_planes:
            # A_pl^-1 with the inactive planes' rows zeroed (plf is 0/1): z_pl
            # of an inactive plane is 0 without a mask op a CG step
            Ainv_pl = inv33(_masked_eye(lg.Hpl, lam, plf, 3)) * plf[:, None, None]  # [Pl, 3, 3]
            gplm = lg.gpl * plf[:, None]

        def full_matvec(x):
            xm = x * pf
            xm_loc = _slice_k(xm, off, Kl)
            xj_loc = _slice_k(chs.roll_up_pose_ch(xm), off, Kl)  # the wrap row's information is 0
            Oa, T_loc = ops.mv_fwd(lin, de, xm_loc)
            if has_planes:
                T, T_pl = allreduce((T_loc, plane_wT_x(lg.Wa, xm_loc, pl_sum, Pl)))
                z_pl = torch.einsum("pij,pj->pi", Ainv_pl, T_pl)
            else:
                T = allreduce(T_loc)
            z = torch.einsum("lij,lj->li", Ainv, T)
            u_loc, vj_loc = ops.mv_bwd(lin, de, Oa, z, xm_loc, xj_loc)
            if has_planes:
                u_loc = u_loc - plane_w_z(lg.Wb, z_pl, pl_flat)
            u_e, vj_e = allreduce((_dus(u_loc, off, Kg), _dus(vj_loc, off, Kg)))
            u = u_e + _shift_down_soa(vj_e)
            if prior is not None:
                u = prior_matvec(u, xm, prior.Hp, prior.p_idx)
            return (u + lam * xm) * pf

        if precond_kind == "tridiag":
            # the damped chain tridiagonal over all Kg rows: the range's
            # couplings embedded at off and reduced (with one range, the
            # whole chain), factored by parallel cyclic reduction
            fac = soa.chain_tridiag_factor(diag.permute(2, 0, 1),
                                           allreduce(_dus(lin.Hij, off, Kg)).permute(2, 0, 1), lam, pf[0])

            def precond(r):
                return td.pcr_solve(fac, r.T).T * pf
        else:
            def precond(r):
                return _m66_vec(Minv, r) * pf

        # b = -(gp - c), c = Jp^T O' Rt (A^-1 gl) summed over each pose's
        # slots (K9 with Oa = 0 and x = 0 gives -c), plus W A_pl^-1 gpl
        glm = gl * lmf[:, None]
        y = torch.einsum("lij,lj->li", Ainv, glm)
        zero_loc = gp.new_zeros((6, Kl))
        cu_loc, _ = ops.mv_bwd(lin, de, torch.zeros_like(lin.v), y, zero_loc, zero_loc)
        if has_planes:
            cu_loc = cu_loc - plane_w_z(lg.Wb, torch.einsum("pij,pj->pi", Ainv_pl, gplm), pl_flat)
        b = -(gp + allreduce(_dus(cu_loc, off, Kg))) * pf

        x = torch.zeros_like(b)
        r = b
        p_ = precond(r)
        rz = torch.sum(r * p_)
        b2 = torch.clamp(torch.sum(b * b), min=1e-30)
        zero = b.new_zeros(())
        # the tridiagonal CG stops at its tolerance (a fetch every
        # TRIDIAG_CHECK_EVERY steps); the block-Jacobi one runs every step
        check = soa.TRIDIAG_CHECK_EVERY if precond_kind == "tridiag" else 0
        for step in range(max_cg_iters):
            active = torch.sum(r * r) > cg_tol * b2
            if check and step % check == 0 and not bool(agree(active)):  # a host fetch
                break
            Ap = full_matvec(p_)
            alpha = torch.where(active, rz / torch.clamp(torch.sum(p_ * Ap), min=1e-30), zero)
            x = x + alpha * p_
            r = r - alpha * Ap
            zc = precond(r)
            rz_new = torch.sum(r * zc)
            beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), zero)
            p_ = torch.where(active, zc + beta * p_, p_)
            rz = torch.where(active, rz_new, rz)

        dpk = x * pf
        dp_loc = _slice_k(dpk, off, Kl)
        _, t_loc = ops.mv_fwd(lin, de, dp_loc)
        if has_planes:
            t_tab, t_pl = allreduce((t_loc, plane_wT_x(lg.Wa, dp_loc, pl_sum, Pl)))
            db_pl = torch.einsum("pij,pj->pi", Ainv_pl, -gplm - t_pl)
        else:
            t_tab = allreduce(t_loc)
        db = torch.einsum("lij,lj->li", Ainv, -glm - t_tab) * lmf[:, None]
        return dpk.T, (torch.cat([db, db_pl]) if has_planes else db)

    pl = planes if has_planes else None
    lg = build(poses, landmarks, pl)
    chi2_0 = lg.chi2
    if init_lambda > 0:
        lam = torch.tensor(init_lambda, dtype=dtype, device=poses.device)
    else:
        diag_max = torch.maximum(lg.diag.diagonal(dim1=0, dim2=1).abs().max(),
                                 lg.Hll.diagonal(dim1=-2, dim2=-1).abs().max())
        if has_planes:
            diag_max = torch.maximum(diag_max, lg.Hpl.diagonal(dim1=-2, dim2=-1).abs().max())
        lam = (init_lambda_tau * torch.clamp(diag_max, min=1.0)).to(dtype)

    p, l, chi2_cur, nu, it = poses, landmarks, chi2_0, 2.0, 0
    while it < max_iterations:
        if it > 0:
            lg = build(p, l, pl)
        dp, db = solve(lg, lam)
        p_new = geo.pose_retract(p, dp.to(dtype))
        l_new = l + db[:L].to(dtype)
        pl_new = plane_retract(pl, db[L:].to(dtype)) if has_planes else None
        chi2_new = chi2_at(p_new, l_new, pl_new)

        delta = torch.cat([dp.reshape(-1), db.reshape(-1)])
        gvec = torch.cat([lg.gp.T.reshape(-1), lg.gl.reshape(-1)] + ([lg.gpl.reshape(-1)] if has_planes else []))
        pred = lam * torch.dot(delta, delta) - torch.dot(delta, gvec)
        rho = (chi2_cur - chi2_new) / torch.clamp(pred, min=1e-12)
        finite = torch.isfinite(chi2_new) & torch.all(torch.isfinite(delta))
        accept = (rho > 0) & finite
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_acc, lam * nu)
        converged = accept & ((chi2_cur - chi2_new) <= rel_tol * torch.clamp(chi2_cur, min=1e-12))
        done = converged | (lam > 1e12)
        accepted, stop = agree(torch.stack([accept, done])).tolist()  # the iteration's one host fetch
        if accepted:
            p, l, pl, chi2_cur, nu = p_new, l_new, pl_new, chi2_new, 2.0
        else:
            nu *= 2.0
        it += 1
        if stop:
            break
    stats = LMStats(it, chi2_0, chi2_cur, lam)
    out = (p, l, pl, stats) if has_planes else (p, l, stats)
    return out + (build(p, l, pl),) if final_lin else out


def lm_optimize_soa_tiled(
    g: GraphState, max_iterations: int = 64, min_edges: int = 10, rel_tol: float = 1e-6,
    max_cg_iters: int = 128, robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0,
    prior=None, with_marginals: bool = False, ell_rows: tuple = (1, 1, 8), cg_tol: float = 1e-8,
    ops: TiledOps | None = None, precond_kind: str = "jacobi",
):
    """Single-device large-K entry (drop-in for ``ellk_soa.lm_optimize_soa``):
    the row-range loop over all K rows with identity reductions, the CG
    preconditioned by ``precond_kind`` (``"jacobi"`` or ``"tridiag"``).

    Below ``min_edges`` edges the graph comes back unchanged with
    ``iterations == 0`` (the count is fetched unless ``min_edges`` is 0).
    ``with_marginals=True`` also returns the landmark marginals, recovered
    matrix-free from a fresh linearization at the final state (K2 + K1) with
    the fixed-lag ``prior``, if any, folded in."""
    ops = ops or kernel_ops()
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    pose_free, lm_free = _free_masks(g)
    de = build_dist_edges(_edge_args(g), K, ell_rows[2], L)
    if min_edges > 0 and int(g.num_edges()) < min_edges:  # fetches the count
        pc = g.poses.T
        chi2 = ops.chi2(pc, chs.roll_up_pose_ch(pc), g.landmarks, de, robust_kind, robust_delta)
        if prior is not None:
            chi2 = chi2 + fl.prior_chi2(prior, g.poses, g.landmarks).to(chi2.dtype)
        stats = LMStats(0, chi2, chi2, torch.zeros_like(chi2))
        return (g, stats, None) if with_marginals else (g, stats)

    poses, landmarks, stats = run_lm_loop_soa_dist(
        g.poses, g.landmarks, pose_free, lm_free, de, max_iterations, rel_tol, max_cg_iters,
        robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda, prior=prior, cg_tol=cg_tol,
        ops=ops, precond_kind=precond_kind,
    )
    g = g.replace(poses=poses, landmarks=landmarks)
    if with_marginals:
        # over all K rows the range's edge store is the whole graph's
        lin_ops = soa.PLAIN_OPS if ops is PLAIN_OPS else soa.kernel_ops()
        lin = lin_ops.linearize(g.poses, g.landmarks, de, robust_kind, robust_delta)
        if prior is not None:
            lin = apply_prior_blocks(lin, prior, g.poses, g.landmarks)
        return g, stats, landmark_marginals_mf_ellk(soa.soa_to_ell_blocks(lin, de), pose_free, lm_free, prior)
    return g, stats


def lm_optimize_soa_planes(
    g: GraphState, pn, max_iterations: int = 64, min_edges: int = 10, rel_tol: float = 1e-6,
    max_cg_iters: int = 128, robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0,
    prior=None, with_marginals: bool = False, ell_rows: tuple = (1, 1, 8, 8), cg_tol: float = 1e-8,
    ops: TiledOps | None = None, precond_kind: str = "jacobi",
):
    """The joint LM over poses, point landmarks and plane landmarks ``pn``
    (``graph/planes.PlaneNodes``) on the row-range loop at any K: the point
    slots through K6-K10, the plane slots through the loop's plane half.
    ``ell_rows[3]`` bounds the plane edges per pose, ``prior`` may carry a
    plane part. Returns (graph, planes, LMStats[, landmark marginals]).

    Below ``min_edges`` edges (odometry, observations and plane edges; the
    count is fetched unless ``min_edges`` is 0) the state comes back
    unchanged with ``iterations == 0``. ``with_marginals=True`` also returns
    the point landmarks' marginals, recovered matrix-free over the L + Pl
    blocks of a fresh linearization at the final state (K1 + K2 for the
    point slots, with the prior folded in) and sliced to the first L."""
    ops = ops or kernel_ops()
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    pose_free, lm_free = _free_masks(g)
    de = build_dist_edges(_edge_args(g), K, ell_rows[2], L)
    pe = build_plane_dist(plane_args(pn), K, ell_rows[3])
    if min_edges > 0 and int(g.num_edges() + pn.num_pe) < min_edges:  # fetches the count
        pc = g.poses.T
        chi2 = ops.chi2(pc, chs.roll_up_pose_ch(pc), g.landmarks, de, robust_kind, robust_delta)
        chi2 = chi2 + plane_chi2(g.poses, pn.planes, pe, robust_kind, robust_delta).to(chi2.dtype)
        if prior is not None:
            chi2 = chi2 + fl.prior_chi2_planes(prior, g.poses, g.landmarks, pn.planes).to(chi2.dtype)
        stats = LMStats(0, chi2, chi2, torch.zeros_like(chi2))
        return (g, pn, stats, None) if with_marginals else (g, pn, stats)

    poses, landmarks, planes, stats = run_lm_loop_soa_dist(
        g.poses, g.landmarks, pose_free, lm_free, de, max_iterations, rel_tol, max_cg_iters,
        robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda, prior=prior, cg_tol=cg_tol,
        ops=ops, pe=pe, planes=pn.planes, plane_free=pn.plane_mask(), precond_kind=precond_kind,
    )
    g, pn = g.replace(poses=poses, landmarks=landmarks), pn.replace(planes=planes)
    if not with_marginals:
        return g, pn, stats
    lin_ops = soa.PLAIN_OPS if ops is PLAIN_OPS else soa.kernel_ops()
    lin = lin_ops.linearize(g.poses, g.landmarks, de, robust_kind, robust_delta)
    if prior is not None:
        lin = apply_prior_blocks(lin, prior, g.poses, g.landmarks)
    eb = ell_linearize_planes(soa.soa_to_ell_blocks(lin, de), g.poses, pn.planes, pe, robust_kind, robust_delta)
    if prior is not None:
        eb = apply_prior_blocks_planes(eb, prior)
    block_free = torch.cat([lm_free, pn.plane_mask()])
    return g, pn, stats, landmark_marginals_mf_ellk(eb, pose_free, block_free, prior)[:L]


# ---------------------------------------------------------------------------
# several ranks: the pose rows split over a mesh (parallel/dist.py)
# ---------------------------------------------------------------------------


def _dus_rows(block: Tensor, off: int, Kg: int) -> Tensor:
    """Embed a [Kl, ...] row block at row ``off`` of a zero [Kg, ...] array."""
    if block.shape[0] == Kg:
        return block
    out = block.new_zeros((Kg,) + block.shape[1:])
    out[off:off + block.shape[0]] = block
    return out


def range_marginal_parts(lg: _LinG, de: SoAEdges, off: int, pose_free: Tensor, block_free: Tensor, n_live: tuple,
                         allreduce: Callable = _identity, pe: EllEdgesPlanes | None = None):
    """The marginal recovery's pose-chain factor and W columns from one
    range's linearization ``lg`` (``run_lm_loop_soa_dist(final_lin=True)``:
    K6 + K7 on rows ``[off, off + Kl)``, reduced, with any prior folded):
    the range's W blocks per slot and its chain couplings embed at ``off``
    and are summed in ONE reduction (the JAX package's
    ``landmark_marginals_mf_ellk`` with ``shard=(off, K)``).

    Only the live blocks travel: ``n_live = (n_landmarks, n_planes)`` (the
    prefixes the masks keep; ``n_planes`` with ``pe`` only). An inactive
    block is decoupled from the rest (its rows and columns of S are
    masked), so the live blocks' marginals are those of the live part
    alone; the columns of the capacity's dead blocks, almost all of
    [Kg, 6, 3B] in a session, stay home. Returns (factor, U [Kg, 6, 3b],
    Hll [b, 3, 3], block_free [b]) over the b = n_landmarks (+ n_planes)
    live blocks, points first, for ``pcg._sigma_from_chain_parts``."""
    lin = lg.lin
    dtype = lg.diag.dtype
    Kg = pose_free.shape[0]
    Kl, R = de.ll.shape
    n_lm, n_pl = n_live
    ORt = soa._m33_mul(lin.Ow, lin.Rt[:, :, None, :])
    W_kl = torch.cat([-ORt, -chs.hat_mul(lin.v, ORt)], dim=0).permute(3, 2, 0, 1)  # [Kl, R, 6, 3]
    L = lg.Hll.shape[0]
    # each slot's live block id, or -1
    ll = torch.where(de.ll < n_lm, de.ll, -1)
    Hll, bfree = lg.Hll[:n_lm], block_free[:n_lm]
    if pe is not None:
        R4 = pe.pl.shape[1]
        W_kp = lg.Wb.reshape(Kl, 6, R4, 3).permute(0, 2, 1, 3)
        ll = torch.cat([ll, torch.where(pe.pl < n_pl, pe.pl + n_lm, -1)], dim=1)
        W_kl = torch.cat([W_kl, W_kp.to(W_kl.dtype)], dim=1)
        Hll = torch.cat([Hll, lg.Hpl[:n_pl].to(lg.Hll.dtype)])
        bfree = torch.cat([bfree, block_free[L:L + n_pl]])
    B = Hll.shape[0]
    pf = pose_free.to(dtype)
    pf_loc = pf[off:off + Kl]
    pf_next = torch.cat([pf[1:], pf.new_zeros(1)])[off:off + Kl]
    live = ll >= 0
    ll = torch.where(live, ll, 0)
    W_m = W_kl.to(dtype) * (pf_loc[:, None] * bfree.to(dtype)[ll] * live)[:, :, None, None]
    kl = (torch.arange(Kl, device=pf.device)[:, None] * B + ll).reshape(-1)
    Ukl = torch.zeros((Kl * B, 6, 3), dtype=dtype, device=pf.device)
    Ukl.index_add_(0, kl, W_m.reshape(-1, 6, 3))
    U_loc = Ukl.view(Kl, B, 6, 3).permute(0, 2, 1, 3).reshape(Kl, 6, 3 * B)
    up_loc = lin.Hij.permute(2, 0, 1).to(dtype) * (pf_loc * pf_next)[:, None, None]
    U, upper = allreduce((_dus_rows(U_loc, off, Kg), _dus_rows(up_loc, off, Kg)))
    eye6 = torch.eye(6, dtype=dtype, device=pf.device)
    Dm = lg.diag.permute(2, 0, 1) * pf[:, None, None] + eye6[None] * (1.0 - pf)[:, None, None]
    return td.pcr_factor(Dm, upper), U, Hll, bfree


def _mesh_ops(ops: TiledOps | None) -> bool:
    """Whether a sharded solve runs the plain versions (``PLAIN_OPS``) or
    the kernels' wrappers (None): other ops do not cross processes."""
    if ops is not None and ops is not PLAIN_OPS:
        raise ValueError("a sharded solve takes ops=None (the kernels' wrappers) or PLAIN_OPS")
    return ops is PLAIN_OPS


def _sharded_soa_body(mesh, payload: dict, *, R: int, R4: int, max_iterations: int, rel_tol: float,
                      max_cg_iters: int, robust_kind: str, robust_delta: float, init_lambda: float,
                      with_marginals: bool, cg_tol: float, plain: bool, precond_kind: str, n_live: tuple = (0, 0)):
    """One rank's share of ``sharded_lm_optimize_soa(_planes)``: the loop
    over pose rows ``[rank Kl, (rank + 1) Kl)`` with the mesh's reductions,
    and with marginals the range's parts of their recovery (the dense tail
    on rank 0 only, the one rank whose result is read)."""
    from semantic_slam_tpu_torch.graph.planes import PlaneNodes
    from semantic_slam_tpu_torch.parallel.dist import unpack
    from semantic_slam_tpu_torch.solver.pcg import _sigma_from_chain_parts

    g = unpack(GraphState, "g", payload)
    pn = unpack(PlaneNodes, "pn", payload)
    prior = unpack(fl.MarginalPrior, "prior", payload)
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    Kl = K // mesh.size
    off = mesh.rank * Kl
    pose_free, lm_free = _free_masks(g)
    de = build_dist_edges(_edge_args(g), K, R, L, off, Kl)
    kw = dict(robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda, prior=prior,
              cg_tol=cg_tol, allreduce=mesh.allreduce, off=off, ops=PLAIN_OPS if plain else None,
              precond_kind=precond_kind, agree=mesh.agree, final_lin=with_marginals)
    if pn is None:
        out = run_lm_loop_soa_dist(g.poses, g.landmarks, pose_free, lm_free, de, max_iterations, rel_tol,
                                   max_cg_iters, **kw)
        block_free, pe = lm_free, None
    else:
        pe = build_plane_dist(plane_args(pn), K, R4, off, Kl)
        out = run_lm_loop_soa_dist(g.poses, g.landmarks, pose_free, lm_free, de, max_iterations, rel_tol,
                                   max_cg_iters, pe=pe, planes=pn.planes, plane_free=pn.plane_mask(), **kw)
        block_free = torch.cat([lm_free, pn.plane_mask()])
    if not with_marginals:
        return out
    fac, U, Hll, bfree = range_marginal_parts(out[-1], de, off, pose_free, block_free, n_live, mesh.allreduce, pe)
    if mesh.rank != 0:
        return None
    # the live landmarks' blocks; a dead one's marginal is the identity
    marg = torch.eye(3, dtype=U.dtype, device=U.device).repeat(L, 1, 1)
    marg[:n_live[0]] = _sigma_from_chain_parts(fac, U, Hll, pose_free, bfree, U.dtype, prior)[:n_live[0]]
    return out[:-1] + (marg,)


def _sharded_soa(g: GraphState, pn, mesh, max_iterations, min_edges, rel_tol, max_cg_iters, robust_kind,
                 robust_delta, init_lambda, prior, with_marginals, ell_rows, cg_tol, ops, precond_kind):
    from semantic_slam_tpu_torch.parallel.dist import pack

    n, K = mesh.size, g.poses.shape[0]
    if K % n:
        raise ValueError(f"a sharded solve splits the {K} pose rows evenly over the {n} ranks: K % n must be 0")
    if precond_kind not in ("jacobi", "tridiag"):
        raise ValueError(f"precond_kind must be 'jacobi' or 'tridiag', got {precond_kind!r}")
    kw = dict(max_iterations=max_iterations, min_edges=min_edges, rel_tol=rel_tol, max_cg_iters=max_cg_iters,
              robust_kind=robust_kind, robust_delta=robust_delta, init_lambda=init_lambda, prior=prior,
              with_marginals=with_marginals, ell_rows=ell_rows, cg_tol=cg_tol, ops=ops, precond_kind=precond_kind)
    n_edges = g.num_edges() + (pn.num_pe if pn is not None else 0)
    if min_edges > 0 and int(n_edges) < min_edges:
        # the gate, decided on the controller (one count fetch) before any
        # rank runs: the single-device entry returns the graph unchanged
        # with iterations == 0 and the current chi2
        return lm_optimize_soa_tiled(g, **kw) if pn is None else lm_optimize_soa_planes(g, pn, **kw)
    payload = {**pack("g", g), **pack("pn", pn), **pack("prior", prior)}
    # the live landmark (and plane) counts, one fetch: the marginals send
    # only their blocks
    n_live = tuple(torch.stack([g.num_landmarks] + ([pn.num_planes] if pn is not None else [g.num_landmarks]))
                   .tolist()) if with_marginals else (0, 0)
    out = mesh.run(
        _sharded_soa_body, payload, R=ell_rows[2], R4=ell_rows[3] if pn is not None else 0,
        max_iterations=max_iterations, rel_tol=rel_tol, max_cg_iters=max_cg_iters, robust_kind=robust_kind,
        robust_delta=robust_delta, init_lambda=float(init_lambda), with_marginals=with_marginals, cg_tol=cg_tol,
        plain=_mesh_ops(ops), precond_kind=precond_kind, n_live=n_live,
    )
    res_ = (g.replace(poses=out[0], landmarks=out[1]),)
    if pn is not None:
        res_ += (pn.replace(planes=out[2]),)
    return res_ + out[len(res_) + 1:]


def sharded_lm_optimize_soa(
    g: GraphState, mesh, max_iterations: int = 64, min_edges: int = 10, rel_tol: float = 1e-6,
    max_cg_iters: int = 128, robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0,
    prior=None, with_marginals: bool = False, ell_rows: tuple = (1, 1, 8), cg_tol: float = 1e-8,
    ops: TiledOps | None = None, precond_kind: str = "jacobi",
):
    """The row-range loop over a mesh (``parallel.dist.make_mesh``): rank r
    owns pose rows ``[r Kl, (r + 1) Kl)`` (``Kl = K / n``; ``K % n`` is a
    ``ValueError``), state and CG vectors are replicated, and every partial
    result is all-reduced: per CG step one [3L]-class reduction (K8's table)
    and one [12K]-class (K9's u and vj), per linearization one of the
    gradient, diagonal and landmark tables, with ``precond_kind="tridiag"``
    one more of the chain couplings [6, 6, K]; and one broadcast of the LM's
    flags per iteration (every 8 CG steps the tridiagonal CG's stop flag).
    A fixed-lag ``prior`` is replicated and folded after each reduction.

    Below ``min_edges`` edges (the count is fetched unless ``min_edges`` is
    0) no rank runs: the graph comes back unchanged with ``iterations ==
    0`` and the current chi2, as from ``lm_optimize_soa_tiled`` (the JAX
    package runs the loop there and drops its result; only its
    ``lambda_final`` and marginals differ, and no caller reads them).
    ``with_marginals=True`` also returns the landmark
    marginals at the loop's final state: each rank linearizes its rows
    there (K6 + K7), the live landmarks' W columns and the chain couplings
    are reduced once (``range_marginal_parts``), and the dense tail runs on
    rank 0. Returns (graph, LMStats[, marginals])."""
    return _sharded_soa(g, None, mesh, max_iterations, min_edges, rel_tol, max_cg_iters, robust_kind, robust_delta,
                        init_lambda, prior, with_marginals, ell_rows, cg_tol, ops, precond_kind)


def sharded_lm_optimize_soa_planes(
    g: GraphState, pn, mesh, max_iterations: int = 64, min_edges: int = 10, rel_tol: float = 1e-6,
    max_cg_iters: int = 128, robust_kind: str = "none", robust_delta: float = 1.0, init_lambda: float = 0.0,
    prior=None, with_marginals: bool = False, ell_rows: tuple = (1, 1, 8, 8), cg_tol: float = 1e-8,
    ops: TiledOps | None = None, precond_kind: str = "jacobi",
):
    """``sharded_lm_optimize_soa`` with plane landmarks ``pn``: each rank's
    plane slots ride its rows, the plane tables [3Pl] are reduced with the
    landmark tables (one collective), and the marginals run over the L + Pl
    blocks, sliced to the points. Returns (graph, planes, LMStats[,
    marginals])."""
    return _sharded_soa(g, pn, mesh, max_iterations, min_edges, rel_tol, max_cg_iters, robust_kind, robust_delta,
                        init_lambda, prior, with_marginals, ell_rows, cg_tol, ops, precond_kind)
