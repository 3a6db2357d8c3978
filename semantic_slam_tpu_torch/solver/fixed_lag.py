"""Fixed-lag smoothing: Schur marginalization of old keyframes into a prior
(port of ``semantic_slam_tpu.solver.fixed_lag``).

When the active window exceeds the configured lag, the oldest ``drop``
keyframes are marginalized out and the graph arrays are compacted in place,
so the solve works on a bounded window instead of the whole history.

* **Pose chain, exact.** Every odometry edge touching a dropped pose (plus
  the previous prior's pose part, re-linearized at the current estimates) is
  assembled over the dropped poses M and the boundary poses B, and M is
  Schur-eliminated: ``H' = H_BB - H_BM H_MM^-1 H_MB``, a dense Gaussian
  prior over at most PB boundary poses in local SE(3) coordinates.
* **Landmark observations, cross term sparsified.** An observation from a
  dropped pose becomes a world-frame unary landmark prior (``J_l^T O J_l``)
  and a pose-side block (``J_p^T O J_p``) that joins the pose elimination;
  only the cross block ``J_p^T O J_l`` is dropped. Landmarks are never
  removed: landmark id == graph index stays invariant.
* **Plane observations** (plane-landmark sessions, ``marginalize_planes``):
  the same sparsification, into anchored priors in each plane's tangent
  coordinates (``plane_local``) and pose-side blocks.

The prior is the quadratic ``c0 + 2 g0.e + e^T H e`` in the local
coordinates ``e_p = log(ref^-1 x)`` (boundary poses) and ``e_l = l - l_ref``
(landmarks), and ``e_pl = plane_local(pl, pl_ref)`` (planes); its gradient
and Hessian fold into every linearization (``apply_prior`` /
``apply_prior_planes`` for the dense LM, ``pcg.apply_prior_blocks`` and the
row-range loop's plane half for the PCG loops, whose matvec applies ``Hp``
itself).

Differences from the JAX module:

* ``_pose_local`` forms the relative translation as ``R_ref^T (t_x - t_ref)``.
  The JAX module's ``pose_inv(ref) * x`` cancels two large rotated vectors,
  which in f32 far from the origin loses the local coordinate (the same
  fault class as the chain residual's, ``chain_soa.chain_residual_ch``). In
  f64 the two forms agree to rounding.
* ``_marginalize_impl`` assembles the pose blocks only over the dropped and
  boundary poses (``drop + PB`` of them), from the edge endpoints; the JAX
  module builds a dense ``[K, K, 6, 6]`` array and reads the same blocks.
* A point-landmark session's prior has an empty plane part (Pl = 0), and
  ``grow_prior`` keeps it empty; the JAX engine sizes it like the landmark
  table in every session.

``prior_from_numpy`` / ``prior_to_numpy`` carry a prior between the JAX
package (its ``MarginalPrior`` leaves as numpy arrays) and the port.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.frontend.hull import plane_basis
from semantic_slam_tpu_torch.graph import residuals as res
from semantic_slam_tpu_torch.graph.state import GraphState
from semantic_slam_tpu_torch.solver import lm as lm_mod
from semantic_slam_tpu_torch.solver.lm import Linearization, LMStats

Tensor = torch.Tensor


class MarginalPrior(NamedTuple):
    """Gaussian prior produced by marginalization.

    Pose part: dense information over up to PB boundary poses (local SE(3)
    coordinates around ``p_ref``). Landmark part: independent 3x3 blocks over
    the full landmark capacity (world coordinates around ``l_ref``); zero
    blocks mean no prior. Slots >= num_p are all-zero by invariant, with
    ``p_idx`` 0. Plane part (plane-landmark sessions): 3x3 blocks in each
    plane's tangent coordinates around ``pl_ref``, the Schur plane blocks'
    shape; zero when unused, and Pl = 0 in point-landmark sessions.
    """

    p_idx: Tensor  # [PB] int32 graph pose indices
    p_ref: Tensor  # [PB, 7] linearization poses
    num_p: Tensor  # int32 0-d
    Hp: Tensor  # [6PB, 6PB] dense pose information
    gp0: Tensor  # [6PB] gradient at p_ref
    Hl: Tensor  # [L, 3, 3] per-landmark information
    l_ref: Tensor  # [L, 3]
    gl0: Tensor  # [L, 3]
    c0: Tensor  # 0-d chi2 offset
    Hpl: Tensor  # [Pl, 3, 3] per-plane information
    pl_ref: Tensor  # [Pl, 4]
    gpl0: Tensor  # [Pl, 3]

    @property
    def max_poses(self) -> int:
        return self.p_idx.shape[0]


def _unit_planes(n: int, dtype, device) -> Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device).repeat(n, 1)


def empty_prior(L: int, PB: int = 8, Pl: int = 0, dtype=torch.float32, device=None) -> MarginalPrior:
    return MarginalPrior(
        p_idx=torch.zeros((PB,), dtype=torch.int32, device=device),
        p_ref=geo.pose_identity(dtype, device).repeat(PB, 1),
        num_p=torch.zeros((), dtype=torch.int32, device=device),
        Hp=torch.zeros((6 * PB, 6 * PB), dtype=dtype, device=device),
        gp0=torch.zeros((6 * PB,), dtype=dtype, device=device),
        Hl=torch.zeros((L, 3, 3), dtype=dtype, device=device),
        l_ref=torch.zeros((L, 3), dtype=dtype, device=device),
        gl0=torch.zeros((L, 3), dtype=dtype, device=device),
        c0=torch.zeros((), dtype=dtype, device=device),
        Hpl=torch.zeros((Pl, 3, 3), dtype=dtype, device=device),
        pl_ref=_unit_planes(Pl, dtype, device),
        gpl0=torch.zeros((Pl, 3), dtype=dtype, device=device),
    )


def grow_prior(prior: MarginalPrior, new_L: int) -> MarginalPrior:
    """Pad the landmark-capacity arrays after the graph's landmarks grow, and
    a plane part, if the prior has one, to the same capacity (plane nodes are
    sized with the landmark table; new ``pl_ref`` rows are the unit plane)."""
    L = prior.Hl.shape[0]
    if new_L <= L:
        return prior

    def pad(a, n, fill=None):
        out = a.new_zeros((new_L,) + a.shape[1:]) if fill is None else fill
        out[:n] = a
        return out

    out = prior._replace(Hl=pad(prior.Hl, L), l_ref=pad(prior.l_ref, L), gl0=pad(prior.gl0, L))
    Pl = prior.Hpl.shape[0]
    if 0 < Pl < new_L:
        out = out._replace(Hpl=pad(prior.Hpl, Pl), gpl0=pad(prior.gpl0, Pl),
                           pl_ref=pad(prior.pl_ref, Pl, _unit_planes(new_L, prior.pl_ref.dtype, prior.pl_ref.device)))
    return out


def prior_from_numpy(arrays: Mapping[str, np.ndarray]) -> MarginalPrior:
    """A port prior (on the CPU) from the JAX ``MarginalPrior`` leaves as
    numpy arrays (e.g. ``{k: np.asarray(v) for k, v in prior._asdict().items()}``);
    float leaves keep their dtype."""
    ints = ("p_idx", "num_p")
    return MarginalPrior(**{
        name: torch.tensor(np.asarray(arrays[name]).astype(np.int32) if name in ints else np.asarray(arrays[name]))
        for name in MarginalPrior._fields
    })


def prior_to_numpy(prior: MarginalPrior) -> dict[str, np.ndarray]:
    """The prior's leaves as numpy arrays, keyed like the JAX ``MarginalPrior``."""
    return {name: getattr(prior, name).detach().cpu().numpy() for name in MarginalPrior._fields}


def _pose_local(x: Tensor, ref: Tensor) -> Tensor:
    """e = log(ref^-1 x), the inverse of pose_retract(ref, e); the relative
    translation is R_ref^T (t_x - t_ref), formed difference first."""
    qi = geo.quat_conj(ref[..., 3:])
    t = geo.quat_rotate(qi, x[..., :3] - ref[..., :3])
    q = geo.quat_normalize(geo.quat_mul(qi, x[..., 3:]))
    return geo.se3_log(geo.pose_make(t, q))


def plane_local(x4: Tensor, ref4: Tensor) -> Tensor:
    """Tangent coordinates of planes ``x4`` around ``ref4`` ([..., 4]): the
    inverse of ``plane_retract(ref, e)`` where n_ref . n_x > 0; the tangent
    components before the normalization are (u . n_x) / (n_ref . n_x)."""
    n_r, n_x = ref4[..., :3], x4[..., :3]
    u, v = plane_basis(n_r)
    c = torch.clamp(torch.sum(n_r * n_x, dim=-1), min=1e-6)
    return torch.stack([torch.sum(u * n_x, dim=-1) / c, torch.sum(v * n_x, dim=-1) / c, x4[..., 3] - ref4[..., 3]],
                       dim=-1)


def _plane_prior_terms(prior: MarginalPrior, planes: Tensor) -> tuple[Tensor, Tensor]:
    """(chi2, gradient [Pl, 3]) of the plane part at ``planes``."""
    e = plane_local(planes, prior.pl_ref).to(prior.Hpl.dtype)
    He = torch.einsum("pij,pj->pi", prior.Hpl, e)
    return 2.0 * torch.sum(prior.gpl0 * e) + torch.sum(e * He), prior.gpl0 + He


def _prior_coords(prior: MarginalPrior, poses: Tensor, landmarks: Tensor) -> tuple[Tensor, Tensor]:
    e_p = _pose_local(poses[prior.p_idx.long()], prior.p_ref)  # [PB, 6]
    return e_p.reshape(-1), landmarks - prior.l_ref


def prior_chi2(prior: MarginalPrior, poses: Tensor, landmarks: Tensor) -> Tensor:
    """The prior factor's value at (poses, landmarks)."""
    ep, el = _prior_coords(prior, poses, landmarks)
    pose_part = 2.0 * torch.dot(prior.gp0, ep) + ep @ (prior.Hp @ ep)
    Hl_el = torch.einsum("lij,lj->li", prior.Hl, el)
    lm_part = 2.0 * torch.sum(prior.gl0 * el) + torch.sum(el * Hl_el)
    return prior.c0 + pose_part + lm_part


def prior_fold_terms(prior: MarginalPrior, poses: Tensor, landmarks: Tensor, dtype):
    """What every prior fold needs, computed once: the prior gradient at the
    current estimate (``gp_add [6PB]``, ``gl_add [L,3]``) and the prior chi2.
    Shared by the dense and the PCG folds so their math cannot diverge."""
    ep, el = _prior_coords(prior, poses, landmarks)
    gp_add = prior.gp0 + prior.Hp @ ep.to(dtype)
    gl_add = prior.gl0 + torch.einsum("lij,lj->li", prior.Hl, el.to(dtype))
    return gp_add, gl_add, prior_chi2(prior, poses, landmarks)


def prior_pose_diag(prior: MarginalPrior) -> Tensor:
    """[PB, 6, 6] diagonal blocks of the boundary-pose information (what
    block-Jacobi preconditioners read)."""
    PB = prior.max_poses
    Hp4 = prior.Hp.reshape(PB, 6, PB, 6).permute(0, 2, 1, 3)
    b = torch.arange(PB, device=Hp4.device)
    return Hp4[b, b]


def apply_prior(lin: Linearization, prior: MarginalPrior, poses: Tensor, landmarks: Tensor) -> Linearization:
    """Add the prior's gradient and Hessian blocks into a dense
    linearization (out of place). Padded slots repeat index 0 with all-zero
    rows, so repeated indices accumulate."""
    dtype = lin.Hpp.dtype
    gp_add, gl_add, chi_pr = prior_fold_terms(prior, poses, landmarks, dtype)
    r6 = (6 * prior.p_idx.long()[:, None] + torch.arange(6, device=prior.p_idx.device)).reshape(-1)  # [6PB]
    Hpp = lin.Hpp.index_put((r6[:, None], r6[None, :]), prior.Hp.to(dtype), accumulate=True)
    gp = lin.gp.index_add(0, r6, gp_add)
    return Linearization(Hpp, lin.W, lin.Hll + prior.Hl, gp, lin.gl + gl_add.reshape(-1), lin.chi2 + chi_pr)


def prior_chi2_planes(prior: MarginalPrior, poses: Tensor, landmarks: Tensor, planes: Tensor) -> Tensor:
    """The prior's value with its plane part (plane-landmark sessions)."""
    return prior_chi2(prior, poses, landmarks) + _plane_prior_terms(prior, planes)[0]


def apply_prior_planes(lin: Linearization, prior: MarginalPrior, poses: Tensor, landmarks: Tensor,
                       planes: Tensor) -> Linearization:
    """``apply_prior`` for the plane-extended layout of
    ``graph/planes.linearize_with_planes``: the landmark blocks are
    ``Hll[:L]``/``gl[:3L]``, the plane blocks the tail."""
    L = landmarks.shape[0]
    out = apply_prior(lin._replace(Hll=lin.Hll[:L], gl=lin.gl[: 3 * L]), prior, poses, landmarks)
    chi_pl, gpl = _plane_prior_terms(prior, planes)
    dtype = lin.Hpp.dtype
    return out._replace(
        Hll=torch.cat([out.Hll, lin.Hll[L:] + prior.Hpl.to(dtype)]),
        gl=torch.cat([out.gl, lin.gl[3 * L:] + gpl.to(dtype).reshape(-1)]),
        chi2=out.chi2 + chi_pl,
    )


def lm_optimize_prior(
    g: GraphState,
    prior: MarginalPrior,
    max_iterations: int = 64,
    min_edges: int = 10,
    rel_tol: float = 1e-6,
    robust_kind: str = "none",
    robust_delta: float = 1.0,
    init_lambda: float = 0.0,
    with_marginals: bool = False,
):
    """Dense Schur LM over the active window plus the marginal prior
    (``lm.lm_optimize`` with the prior folded into every linearization).
    Below ``min_edges`` edges the graph comes back unchanged with
    ``iterations == 0`` (as ``lm.lm_optimize``; the chi2 includes the prior).
    ``with_marginals=True`` also returns the landmark marginals of the loop's
    final linearization, prior included."""
    pose_free, lm_free = lm_mod._free_masks(g)
    edges = lm_mod._edge_args(g)

    def lin_fn(p, l):
        lin = lm_mod.linearize_arrays(p, l, *edges, robust_kind=robust_kind, robust_delta=robust_delta)
        return apply_prior(lin, prior, p, l)

    if min_edges > 0 and int(g.num_edges()) < min_edges:  # fetches the count
        chi2 = lm_mod.chi2_arrays(g.poses, g.landmarks, *edges, robust_kind=robust_kind, robust_delta=robust_delta)
        chi2 = chi2 + prior_chi2(prior, g.poses, g.landmarks)
        stats = LMStats(0, chi2, chi2, torch.zeros_like(chi2))
        return (g, stats, None) if with_marginals else (g, stats)

    poses, landmarks, stats, lin_f = lm_mod.run_lm_loop(
        g.poses, g.landmarks, lin_fn, pose_free, lm_free, max_iterations, rel_tol, init_lambda=init_lambda,
    )
    g = g.replace(poses=poses, landmarks=landmarks)
    if with_marginals:
        return g, stats, lm_mod.marginals_from_lin(lin_f, pose_free, lm_free)
    return g, stats


def landmark_marginals_prior(g: GraphState, prior: MarginalPrior) -> Tensor:
    """``lm.landmark_marginals`` with the prior information included (a
    fresh linearization at the current estimate)."""
    pose_free, lm_free = lm_mod._free_masks(g)
    lin = apply_prior(lm_mod.linearize(g), prior, g.poses, g.landmarks)
    return lm_mod.marginals_from_lin(lin, pose_free, lm_free)


# ---------------------------------------------------------------------------
# marginalization and compaction
# ---------------------------------------------------------------------------


def _quad_min_dense(H: Tensor, g: Tensor) -> Tensor:
    """min over e of 2 g.e + e^T H e = -g^T H^+ g for PSD H (masked slots
    carry g = 0). Zero diagonal entries get 1 so the solve is well-posed; a
    tiny ridge guards near-singular directions."""
    n = H.shape[0]
    d = torch.diagonal(H)
    fix = (torch.abs(d) < 1e-10).to(H.dtype)
    Hr = H + torch.diag(fix) + 1e-8 * torch.clamp(d.max(), min=1.0) * torch.eye(n, dtype=H.dtype, device=H.device)
    c = lm_mod._cholesky_or_nan(Hr)
    return -torch.dot(g, torch.cholesky_solve(g[:, None], c)[:, 0])


def _quad_min33(H: Tensor, g: Tensor) -> Tensor:
    """``_quad_min_dense`` for each 3x3 block of H [N, 3, 3], g [N, 3]: [N]."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    fix = (torch.abs(d) < 1e-10).to(H.dtype)
    ridge = 1e-8 * torch.clamp(d.max(dim=-1).values, min=1.0)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hr = H + torch.diag_embed(fix) + ridge[:, None, None] * eye
    return -torch.sum(g * torch.linalg.solve(Hr, g), dim=-1)


def _stable_partition(keep: Tensor) -> Tensor:
    """Permutation putting kept slots first, original order preserved."""
    n = keep.shape[0]
    idx = torch.arange(n, device=keep.device)
    return torch.argsort(torch.where(keep, idx, n + idx))


def _marginalize_impl(g: GraphState, prior: MarginalPrior, drop: int, pn=None):
    """Marginalize the oldest ``drop`` keyframes; compact the graph (and the
    plane edges of ``pn``, plane nodes, if given).

    Returns ``(graph', prior', num_boundary)``, with ``pn`` ``(graph',
    planes', prior', num_boundary)``; ``num_boundary`` (int32 0-d,
    on the device) is the number of boundary poses the new prior needed. The
    caller checks it against ``prior.max_poses`` on the host: beyond it the
    information is truncated (with chain odometry the boundary is 1-2 poses).
    The caller guarantees ``0 < drop < num_poses``. Edge capacities stay as
    they are."""
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    PB = prior.max_poses
    dtype, dev = g.poses.dtype, g.poses.device
    poses, landmarks = g.poses, g.landmarks
    oi, oj, lk, ll = (a.long() for a in (g.odom_i, g.odom_j, g.lme_k, g.lme_l))
    pidx = prior.p_idx.long()
    arK, arPB = torch.arange(K, device=dev), torch.arange(PB, device=dev)

    # ---- edge partitions
    act_o, act_e = g.odom_mask(), g.lme_mask()
    drop_o = act_o & ((oi < drop) | (oj < drop))
    drop_e = act_e & (lk < drop)

    # ---- anchored landmark priors from the dropped observation edges
    e_info = g.lme_info * drop_e.to(dtype)[:, None, None]
    r_l, Jp, Jl = res.se3_point_residual_jac(poses[lk], landmarks[ll], g.lme_meas)
    JlT_O = torch.einsum("eai,eab->eib", Jl, e_info)
    Hl_add = torch.zeros((L, 3, 3), dtype=dtype, device=dev).index_add_(0, ll, torch.einsum("eia,eaj->eij", JlT_O, Jl))
    gl_add = torch.zeros((L, 3), dtype=dtype, device=dev).index_add_(0, ll, torch.einsum("eia,ea->ei", JlT_O, r_l))
    c_anchor = torch.einsum("ea,eab,eb->", r_l, e_info, r_l)

    # ---- re-center the old prior's landmark part to the current estimates
    d_l = (landmarks - prior.l_ref).to(dtype)
    Hl_dl = torch.einsum("lij,lj->li", prior.Hl, d_l)
    lchi = 2.0 * torch.sum(prior.gl0 * d_l) + torch.sum(d_l * Hl_dl)
    gl0_new = prior.gl0 + Hl_dl + gl_add
    Hl_new = prior.Hl + Hl_add

    # ---- plane-landmark sessions: anchored plane priors from the dropped
    # plane edges, and the old plane part re-centered to the current planes
    zero = torch.zeros((), dtype=dtype, device=dev)
    c_anchor_pl = plchi = zero
    gpl0_new, Hpl_new = prior.gpl0, prior.Hpl
    if pn is not None:
        from semantic_slam_tpu_torch.graph.planes import plane_edge_jac

        pk, pp = pn.pe_k.long(), pn.pe_p.long()
        pe_drop = pn.pe_mask() & (pk < drop)
        p_info = pn.pe_info * pe_drop.to(dtype)[:, None, None]
        r_pe, Jk_pe, Jpl_pe = plane_edge_jac(poses[pk], pn.planes[pp], pn.pe_meas)
        JplT_O = torch.einsum("eai,eab->eib", Jpl_pe, p_info)
        Hpl_add = torch.zeros_like(prior.Hpl).index_add_(0, pp, JplT_O @ Jpl_pe)
        gpl_add = torch.zeros_like(prior.gpl0).index_add_(0, pp, torch.einsum("eia,ea->ei", JplT_O, r_pe))
        c_anchor_pl = torch.einsum("ea,eab,eb->", r_pe, p_info, r_pe)
        d_pl = plane_local(pn.planes, prior.pl_ref).to(dtype)
        Hpl_dpl = torch.einsum("pij,pj->pi", prior.Hpl, d_pl)
        plchi = 2.0 * torch.sum(prior.gpl0 * d_pl) + torch.sum(d_pl * Hpl_dpl)
        gpl0_new = prior.gpl0 + Hpl_dpl + gpl_add
        Hpl_new = prior.Hpl + Hpl_add

    # ---- per-edge pose blocks of the dropped odometry edges
    o_info = g.odom_info * drop_o.to(dtype)[:, None, None]
    r_o, Ji, Jj = res.se3_edge_residual_jac(poses[oi], poses[oj], g.odom_meas)
    JiT_O = torch.einsum("eai,eab->eib", Ji, o_info)
    JjT_O = torch.einsum("eai,eab->eib", Jj, o_info)
    H_ij = torch.einsum("eia,eaj->eij", JiT_O, Jj)
    c_odom = torch.einsum("ea,eab,eb->", r_o, o_info, r_o)
    # pose side of the dropped observation edges (their cross term to the
    # landmark is dropped, see the module docstring)
    JpT_O = torch.einsum("eai,eab->eib", Jp, e_info)

    # the old prior's pose part, linearized at the current poses
    ep_old = _pose_local(poses[pidx], prior.p_ref).reshape(-1).to(dtype)
    pchi = 2.0 * torch.dot(prior.gp0, ep_old) + ep_old @ (prior.Hp @ ep_old)
    gp_fold = (prior.gp0 + prior.Hp @ ep_old).reshape(PB, 6)
    Hp_fold = prior.Hp.reshape(PB, 6, PB, 6).permute(0, 2, 1, 3)  # [PB, PB, 6, 6]

    # ---- boundary: kept poses touched by a dropped odometry edge or by the
    # old prior, ascending, then the rest to fill PB slots
    def touched(idx, on):
        return torch.zeros(K, dtype=torch.int32, device=dev).index_add_(0, idx, on.to(torch.int32))

    inv = (touched(oi, drop_o & (oi >= drop)) + touched(oj, drop_o & (oj >= drop))
           + touched(pidx, (arPB < prior.num_p) & (pidx >= drop))) > 0
    num_b = torch.sum(inv.to(torch.int32))
    b_idx = torch.argsort(torch.where(inv, arK, K + arK))[:PB]
    b_act = (arPB < torch.clamp(num_b, max=PB)).to(dtype)

    # ---- the blocks over the dropped poses [0, drop) and the boundary
    # slots: local slot loc[k] of pose k (-1 outside), boundary pose b_idx[b]
    # at drop + b unless it is itself a dropped pose
    n = drop + PB
    loc = torch.full((K + 1,), -1, dtype=torch.long, device=dev)
    loc[:drop] = torch.arange(drop, device=dev)
    loc.index_put_((torch.where(b_idx >= drop, b_idx, K),), drop + arPB)
    loc = loc[:K]
    pos_b = loc[b_idx]
    Hloc = torch.zeros((n * n + 1, 6, 6), dtype=dtype, device=dev)
    gloc = torch.zeros((n + 1, 6), dtype=dtype, device=dev)

    def add_blocks(i, j, blocks):
        li, lj = loc[i.reshape(-1)], loc[j.reshape(-1)]
        Hloc.index_add_(0, torch.where((li >= 0) & (lj >= 0), li * n + lj, n * n), blocks.reshape(-1, 6, 6))

    def add_grad(i, vals):
        li = loc[i]
        gloc.index_add_(0, torch.where(li >= 0, li, n), vals)

    add_blocks(oi, oi, torch.einsum("eia,eaj->eij", JiT_O, Ji))
    add_blocks(oi, oj, H_ij)
    add_blocks(oj, oi, H_ij.transpose(-1, -2))
    add_blocks(oj, oj, torch.einsum("eia,eaj->eij", JjT_O, Jj))
    add_blocks(lk, lk, torch.einsum("eia,eaj->eij", JpT_O, Jp))
    add_blocks(pidx[:, None].expand(PB, PB), pidx[None, :].expand(PB, PB), Hp_fold)
    add_grad(oi, torch.einsum("eia,ea->ei", JiT_O, r_o))
    add_grad(oj, torch.einsum("eia,ea->ei", JjT_O, r_o))
    add_grad(lk, torch.einsum("eia,ea->ei", JpT_O, r_l))
    add_grad(pidx, gp_fold)
    if pn is not None:
        # pose side of the dropped plane edges (the cross term to the plane is
        # dropped, as for the points)
        JkT_O = torch.einsum("eai,eab->eib", Jk_pe, p_info)
        add_blocks(pk, pk, JkT_O @ Jk_pe)
        add_grad(pk, torch.einsum("eia,ea->ei", JkT_O, r_pe))

    # gauge: pose 0 (local slot 0) is a constant, not a variable
    Hf = Hloc[: n * n].reshape(n, n, 6, 6)
    free = (torch.arange(n, device=dev) != 0).to(dtype)
    Hf = Hf * free[:, None, None, None] * free[None, :, None, None]
    gf = gloc[:n] * free[:, None]

    # ---- Schur-eliminate the dropped poses
    def blocks_to_mat(B4):  # [m, n, 6, 6] -> [6m, 6n]
        return B4.permute(0, 2, 1, 3).reshape(6 * B4.shape[0], 6 * B4.shape[1])

    H_MM = blocks_to_mat(Hf[:drop, :drop])
    H_MB = blocks_to_mat(Hf[:drop][:, pos_b])
    H_BB = blocks_to_mat(Hf[pos_b][:, pos_b])
    g_M = gf[:drop].reshape(-1)
    g_B = gf[pos_b].reshape(-1)

    # identity on empty diagonal blocks (pose 0, disconnected), tiny ridge
    dvec = torch.diagonal(H_MM)
    fix = (torch.sum(torch.abs(dvec.reshape(drop, 6)), dim=1) < 1e-8).to(dtype)
    ridge = 1e-6 * torch.clamp(dvec.max(), min=1.0)
    H_MM = H_MM + torch.diag(torch.repeat_interleave(fix, 6)) + ridge * torch.eye(6 * drop, dtype=dtype, device=dev)

    X = torch.cholesky_solve(torch.cat([H_MB, g_M[:, None]], dim=1), lm_mod._cholesky_or_nan(H_MM))
    Hinv_HMB, Hinv_gM = X[:, :-1], X[:, -1]
    Hp_new = H_BB - H_MB.T @ Hinv_HMB
    gp_new = g_B - H_MB.T @ Hinv_gM
    c_pose = c_odom + prior.c0 + pchi - torch.dot(g_M, Hinv_gM)

    bmask6 = torch.repeat_interleave(b_act, 6)
    Hp_new = Hp_new * (bmask6[:, None] * bmask6[None, :])
    gp_new = gp_new * bmask6
    Hp_new = 0.5 * (Hp_new + Hp_new.T)  # cholesky_solve round-off

    # Non-negativity lift (as the JAX module): the sparsified cross term and
    # the nonlinear re-centering can leave the carried quadratic's minimum
    # below zero; its parts are separable, so the minimum is cheap here, and
    # lifting c0 by its negative part shifts every chi2 by a constant
    c0_new = c_pose + lchi + c_anchor + plchi + c_anchor_pl
    qmin = c0_new + _quad_min_dense(Hp_new, gp_new) + torch.sum(_quad_min33(Hl_new, gl0_new))
    if Hpl_new.shape[0] > 0:
        qmin = qmin + torch.sum(_quad_min33(Hpl_new, gpl0_new))
    c0_new = c0_new - torch.clamp(qmin, max=0.0) + 1e-5 * (1.0 + torch.abs(qmin))

    active = b_act.to(torch.bool)
    prior_new = MarginalPrior(
        p_idx=torch.where(active, b_idx - drop, 0).to(torch.int32),
        p_ref=torch.where(active[:, None], poses[b_idx], geo.pose_identity(dtype, dev)[None, :]),
        num_p=torch.clamp(num_b, max=PB).to(torch.int32),
        Hp=Hp_new,
        gp0=gp_new,
        Hl=Hl_new,
        l_ref=landmarks,
        gl0=gl0_new,
        c0=c0_new,
        Hpl=Hpl_new,
        pl_ref=prior.pl_ref if pn is None else pn.planes,
        gpl0=gpl0_new,
    )

    # ---- compaction
    poses2 = torch.cat([poses[drop:], geo.pose_identity(dtype, dev).repeat(drop, 1)])

    def sub(a):
        return torch.clamp(a - drop, 0, K - 1).to(torch.int32)

    keep_o = act_o & ~drop_o
    po = _stable_partition(keep_o)
    keep_e = act_e & ~drop_e
    pe = _stable_partition(keep_e)
    g2 = g.replace(
        poses=poses2,
        num_poses=(g.num_poses - drop).to(torch.int32),
        odom_i=sub(oi[po]),
        odom_j=sub(oj[po]),
        odom_meas=g.odom_meas[po],
        odom_info=g.odom_info[po],
        num_odom=torch.sum(keep_o.to(torch.int32)).to(torch.int32),
        lme_k=sub(lk[pe]),
        lme_l=g.lme_l[pe],
        lme_meas=g.lme_meas[pe],
        lme_info=g.lme_info[pe],
        num_lme=torch.sum(keep_e.to(torch.int32)).to(torch.int32),
    )
    if pn is None:
        return g2, prior_new, num_b
    keep_pe = pn.pe_mask() & ~pe_drop
    pp_ = _stable_partition(keep_pe)
    pn2 = pn.replace(
        pe_k=sub(pk[pp_]),
        pe_p=pn.pe_p[pp_],
        pe_meas=pn.pe_meas[pp_],
        pe_info=pn.pe_info[pp_],
        num_pe=torch.sum(keep_pe.to(torch.int32)).to(torch.int32),
    )
    return g2, pn2, prior_new, num_b


def marginalize(g: GraphState, prior: MarginalPrior, drop: int) -> tuple[GraphState, MarginalPrior, Tensor]:
    if drop < 1:
        raise ValueError(f"marginalize: drop={drop} must be >= 1")
    return _marginalize_impl(g, prior, drop)


def marginalize_planes(g: GraphState, pn, prior: MarginalPrior, drop: int):
    """Plane-landmark marginalization: also turns the dropped SE3-plane edges
    into anchored plane-tangent priors (their pose side joins the pose
    elimination, the pose-plane cross term is dropped as for the points) and
    compacts the plane edges. Returns ``(graph', planes', prior',
    num_boundary)``."""
    if drop < 1:
        raise ValueError(f"marginalize_planes: drop={drop} must be >= 1")
    return _marginalize_impl(g, prior, drop, pn=pn)
