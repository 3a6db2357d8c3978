"""Plane landmarks in the Schur solver (port of
``semantic_slam_tpu.graph.planes``).

Each landmark of a plane-landmark session is a planar patch: the point
machinery constrains its centroid, and SE3-plane edges onto ``PlaneNodes``
constrain its orientation and offset. A plane block is 3-dof (two
normal-tangent components and the offset), like a point block, so the plane
blocks append onto the block-diagonal landmark system (``Hll``/``W``/``gl``
grow from L to L + Pl blocks) and the reduced pose solve is unchanged.
Capacity masks keep empty plane slots inert. Plane node i is landmark i's
patch (the engine keeps the indices equal).

The edge Jacobian is the closed form of the JAX package's forward-mode one
(``graph/residuals.se3_plane_residual_jac`` and
``solver/plane_ba.plane_retract_jac``). The dense linearization assembles
with ``index_add_`` (the JAX module's one-hot assembly is a TPU workaround).

``plane_nodes_from_numpy`` / ``plane_nodes_to_numpy`` carry plane nodes
between the JAX package (its ``PlaneNodes`` leaves as numpy arrays) and the
port. This is the wired form of the reference's disabled ``EdgeSE3Plane``
(component 16, ``graph_slam.cpp:30-33``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.graph import residuals as res
from semantic_slam_tpu_torch.graph.state import GraphState, set_rows
from semantic_slam_tpu_torch.solver import lm as lm_mod
from semantic_slam_tpu_torch.solver.plane_ba import plane_retract, plane_retract_jac
from semantic_slam_tpu_torch.solver.robust import robust_rho, robust_weight

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PlaneNodes:
    planes: Tensor  # [Pl, 4] (unit n, d)
    num_planes: Tensor  # i32 0-d
    pe_k: Tensor  # [E3] i32 pose index
    pe_p: Tensor  # [E3] i32 plane index
    pe_meas: Tensor  # [E3, 4] sensor-frame plane observation
    pe_info: Tensor  # [E3, 3, 3]
    num_pe: Tensor  # i32 0-d

    @property
    def max_planes(self) -> int:
        return self.planes.shape[0]

    @property
    def max_edges(self) -> int:
        return self.pe_k.shape[0]

    def replace(self, **kw) -> "PlaneNodes":
        return dataclasses.replace(self, **kw)

    def plane_mask(self) -> Tensor:
        return torch.arange(self.planes.shape[0], device=self.planes.device) < self.num_planes

    def pe_mask(self) -> Tensor:
        return torch.arange(self.pe_k.shape[0], device=self.planes.device) < self.num_pe


FIELDS = tuple(f.name for f in dataclasses.fields(PlaneNodes))
_INT_FIELDS = {"pe_k", "pe_p", "num_planes", "num_pe"}


def _unit_planes(n: int, dtype, device) -> Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=dtype, device=device).repeat(n, 1)


def make_planes(max_planes: int = 32, max_edges: int = 256, dtype=torch.float32, device=None) -> PlaneNodes:
    def count():
        return torch.zeros((), dtype=torch.int32, device=device)

    return PlaneNodes(
        planes=_unit_planes(max_planes, dtype, device),
        num_planes=count(),
        pe_k=torch.zeros((max_edges,), dtype=torch.int32, device=device),
        pe_p=torch.zeros((max_edges,), dtype=torch.int32, device=device),
        pe_meas=_unit_planes(max_edges, dtype, device),
        pe_info=torch.zeros((max_edges, 3, 3), dtype=dtype, device=device),
        num_pe=count(),
    )


def add_plane_node(pn: PlaneNodes, plane4: Tensor) -> tuple[PlaneNodes, Tensor]:
    idx = pn.num_planes
    return pn.replace(planes=set_rows(pn.planes, idx, plane4), num_planes=idx + 1), idx


def add_se3_plane_edge(pn: PlaneNodes, k, p, meas4: Tensor, info33: Tensor) -> PlaneNodes:
    e = pn.num_pe
    dev = pn.planes.device
    return pn.replace(
        pe_k=set_rows(pn.pe_k, e, torch.as_tensor(k, device=dev).to(torch.int32)),
        pe_p=set_rows(pn.pe_p, e, torch.as_tensor(p, device=dev).to(torch.int32)),
        pe_meas=set_rows(pn.pe_meas, e, meas4),
        pe_info=set_rows(pn.pe_info, e, info33),
        num_pe=e + 1,
    )


def grow_planes(pn: PlaneNodes, factor: int = 2) -> PlaneNodes:
    """Multiply both capacities by ``factor``, keeping the active prefixes."""
    big = make_planes(pn.max_planes * factor, pn.max_edges * factor, pn.planes.dtype, pn.planes.device)
    out = {}
    for name in FIELDS:
        src = getattr(pn, name)
        if name.startswith("num_"):
            out[name] = src
        else:
            dst = getattr(big, name).clone()
            dst[: src.shape[0]] = src
            out[name] = dst
    return PlaneNodes(**out)


def plane_nodes_from_numpy(arrays: Mapping[str, np.ndarray], device=None, dtype=None) -> PlaneNodes:
    """Port plane nodes from the JAX ``PlaneNodes`` leaves as numpy arrays
    (e.g. ``{k: np.asarray(v) for k, v in jax_pn._asdict().items()}``).
    Float leaves keep their dtype unless ``dtype`` is given; integer leaves
    load as int32."""
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            out[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            t = torch.tensor(a, device=device)
            out[name] = t if dtype is None else t.to(dtype)
    return PlaneNodes(**out)


def plane_nodes_to_numpy(pn: PlaneNodes) -> dict[str, np.ndarray]:
    """The plane nodes' leaves as numpy arrays, keyed like the JAX ``PlaneNodes``."""
    return {name: getattr(pn, name).detach().cpu().numpy() for name in FIELDS}


# ---------------------------------------------------------------------------
# edge blocks
# ---------------------------------------------------------------------------


def plane_edge_jac(pose_k: Tensor, plane4: Tensor, meas4: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Residual [...,3], J_pose [...,3,6] (right pose perturbation) and
    J_plane [...,3,3] (the plane tangent of ``plane_retract``)."""
    r, Jk, Jn = res.se3_plane_residual_jac(pose_k, plane4, meas4)
    return r, Jk, Jn @ plane_retract_jac(plane4)


def plane_edge_blocks(pose_k: Tensor, plane4: Tensor, meas4: Tensor, info: Tensor, robust_kind: str = "none",
                      robust_delta: float = 1.0):
    """The blocks of SE3-plane edges batched over any leading dims, ``info``
    already masked: (robust chi2 total, H_kk [..,6,6], W_kp [..,6,3],
    H_pp [..,3,3], g_k [..,6], g_p [..,3]). The robust kernel's IRLS weight
    scales the information, as for the point edges."""
    r, Jk, Jp = plane_edge_jac(pose_k, plane4, meas4)
    chi_e = torch.einsum("...a,...ab,...b->...", r, info, r)
    chi = torch.sum(robust_rho(chi_e, robust_kind, robust_delta))
    if robust_kind != "none":
        info = info * robust_weight(chi_e, robust_kind, robust_delta).to(info.dtype)[..., None, None]
    JkT_O = torch.einsum("...ai,...ab->...ib", Jk, info)
    JpT_O = torch.einsum("...ai,...ab->...ib", Jp, info)
    return (chi, JkT_O @ Jk, JkT_O @ Jp, JpT_O @ Jp, torch.einsum("...ia,...a->...i", JkT_O, r),
            torch.einsum("...ia,...a->...i", JpT_O, r))


def linearize_with_planes(g: GraphState, pn: PlaneNodes, robust_kind: str = "none",
                          robust_delta: float = 1.0) -> lm_mod.Linearization:
    """The point linearization with the plane blocks appended onto the
    landmark system: ``W [6K, 3(L+Pl)]``, ``Hll [L+Pl, 3, 3]``, ``gl [3(L+Pl)]``.
    ``robust_kind`` reweights the point observations and the plane edges
    alike; odometry stays unweighted (graph_slam.cpp:155-161 puts kernels on
    landmark edges only)."""
    lin = lm_mod.linearize_arrays(g.poses, g.landmarks, *lm_mod._edge_args(g), robust_kind=robust_kind,
                                  robust_delta=robust_delta)
    K, Pl = g.poses.shape[0], pn.planes.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    pk, pp = pn.pe_k.long(), pn.pe_p.long()
    info = pn.pe_info * pn.pe_mask().to(dtype)[:, None, None]
    chi_p, H_kk, W_kp, H_pp, g_k, g_p = plane_edge_blocks(g.poses[pk], pn.planes[pp], pn.pe_meas, info, robust_kind,
                                                          robust_delta)
    K6 = 6 * K
    Hpp = lin.Hpp.reshape(-1)
    Hpp.index_add_(0, lm_mod._block_flat_index(pk, pk, 6, 6, K6), H_kk.reshape(-1))  # lin's own fresh tensor
    Wp = torch.zeros(K6 * 3 * Pl, dtype=dtype, device=dev)
    Wp.index_add_(0, lm_mod._block_flat_index(pk, pp, 6, 3, 3 * Pl), W_kp.reshape(-1))
    gp = lin.gp.reshape(K, 6).index_add(0, pk, g_k).reshape(-1)
    Hll_p = torch.zeros((Pl, 3, 3), dtype=dtype, device=dev).index_add_(0, pp, H_pp)
    gl_p = torch.zeros((Pl, 3), dtype=dtype, device=dev).index_add_(0, pp, g_p)
    return lm_mod.Linearization(
        Hpp.view(K6, K6), torch.cat([lin.W, Wp.view(K6, 3 * Pl)], dim=1), torch.cat([lin.Hll, Hll_p]), gp,
        torch.cat([lin.gl, gl_p.reshape(-1)]), lin.chi2 + chi_p,
    )


def chi2_with_planes(g: GraphState, pn: PlaneNodes, robust_kind: str = "none", robust_delta: float = 1.0) -> Tensor:
    base = lm_mod.chi2_arrays(g.poses, g.landmarks, *lm_mod._edge_args(g), robust_kind=robust_kind,
                              robust_delta=robust_delta)
    r = res.se3_plane_residual(g.poses[pn.pe_k.long()], pn.planes[pn.pe_p.long()], pn.pe_meas)
    chi_p = robust_rho(torch.einsum("ei,eij,ej->e", r, pn.pe_info, r), robust_kind, robust_delta)
    return base + torch.sum(chi_p * pn.pe_mask().to(g.poses.dtype))


def lm_optimize_with_planes(
    g: GraphState,
    pn: PlaneNodes,
    max_iterations: int = 64,
    min_edges: int = 10,
    rel_tol: float = 1e-6,
    robust_kind: str = "none",
    robust_delta: float = 1.0,
    init_lambda: float = 0.0,
    prior=None,
) -> tuple[GraphState, PlaneNodes, lm_mod.LMStats]:
    """Joint dense LM over poses, point landmarks and planes (both block
    types Schur-eliminated, ``lm.schur_solve`` over L + Pl blocks). A
    fixed-lag ``prior`` with a plane part (``fixed_lag.MarginalPrior``) folds
    into every linearization. Below ``min_edges`` edges (odometry,
    observations and plane edges; the count is fetched unless ``min_edges``
    is 0) the state comes back unchanged with ``iterations == 0``."""
    from semantic_slam_tpu_torch.solver import fixed_lag as fl

    L = g.landmarks.shape[0]
    pose_free, lm_free = lm_mod._free_masks(g)
    block_free = torch.cat([lm_free, pn.plane_mask()])

    def lin_fn(p, lp):
        gt, pt = g.replace(poses=p, landmarks=lp[0]), pn.replace(planes=lp[1])
        lin = linearize_with_planes(gt, pt, robust_kind, robust_delta)
        return lin if prior is None else fl.apply_prior_planes(lin, prior, p, lp[0], lp[1])

    def retract_fn(p, lp, dp, db):
        return geo.pose_retract(p, dp.to(p.dtype)), (lp[0] + db[:L].to(p.dtype),
                                                     plane_retract(lp[1], db[L:].to(p.dtype)))

    if min_edges > 0 and int(g.num_edges() + pn.num_pe) < min_edges:  # fetches the count
        chi2 = chi2_with_planes(g, pn, robust_kind, robust_delta)
        if prior is not None:
            chi2 = chi2 + fl.prior_chi2_planes(prior, g.poses, g.landmarks, pn.planes).to(chi2.dtype)
        return g, pn, lm_mod.LMStats(0, chi2, chi2, torch.zeros_like(chi2))

    poses, (landmarks, planes), stats, _ = lm_mod.run_lm_loop(
        g.poses, (g.landmarks, pn.planes), lin_fn, pose_free, block_free, max_iterations, rel_tol,
        init_lambda=init_lambda, retract_fn=retract_fn,
    )
    return g.replace(poses=poses, landmarks=landmarks), pn.replace(planes=planes), stats
