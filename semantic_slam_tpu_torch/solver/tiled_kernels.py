"""Hand-written CUDA kernels of the row-range SoA Schur-PCG loop and their
wrappers (port of ``semantic_slam_tpu.solver.pallas_tiled``).

  * ``tiled_linearize``       -- K6 + K7, ``csrc/tiled_linearize.cu``: K1's
    two launches (``csrc/soa_common.cuh``) on the rows' arrays, the chain
    (K7) as blocks of the first, split by ``kernels.lin_split``;
    ``tiled_fused_linearize`` also returns the chain's own outputs, and
    ``tiled_obs_linearize`` runs K6 alone on given chain blocks
  * ``tiled_mv_fwd``          -- K8, ``csrc/tiled_matvec.cu``
  * ``tiled_mv_bwd``          -- K9, ``csrc/tiled_matvec.cu``
  * ``tiled_chi2``            -- K10, ``csrc/tiled_chi2.cu``: K3's slot pass
    (``csrc/soa_common.cuh``) against the host's successors, split by
    ``kernels.lin_split``

Every wrapper works on one run of pose rows ``[off, off + Kl)``: ``pc`` and
``pj`` are the pose channels [7, Kl] of the rows and of their chain
successors, ``de`` the rows' edge store (``soa_dist.build_dist_edges``), and
the landmark outputs are sums over the rows' slots only (``soa_dist`` says
what the host does with them). Each wrapper checks shapes and index dtypes
first, on every device. On CPU tensors it then runs its plain
version (``soa_dist.chain_plain``, ``obs_plain``, ``mv_fwd_plain``,
``mv_bwd_plain``, ``chi2_plain``); on CUDA tensors it launches its kernel on
the current stream or raises. The kernels work in f32: inputs are cast to
f32 and outputs back to the caller's dtype. No wrapper synchronizes with the
host. Each counts its calls that launch kernels in ``.launches``.

Not ported, as TPU VMEM workarounds: the K-block size choice
(``pick_block``, ``tiled_fits``) and the landmark digit grids; landmark
tables stay [L, 3] / [L, 3, 3].
"""

from __future__ import annotations

import torch

from semantic_slam_tpu_torch.solver import soa_dist as sd
from semantic_slam_tpu_torch.solver.ellk_soa import ChainLin, SoAEdges
from semantic_slam_tpu_torch.solver import kernels
from semantic_slam_tpu_torch.solver.kernels import _check_device, _check_edges, _check_shape, _f32, _robust, _stream
from semantic_slam_tpu_torch.solver.soa_dist import TiledLin

Tensor = torch.Tensor


def _edges_on(de: SoAEdges) -> dict:
    return {f"de.{k}": v for k, v in de._asdict().items()}


def _check_lin(what: str, lin: TiledLin, R: int, Kl: int, L: int) -> None:
    for name, shape in (("v", (3, R, Kl)), ("Ow", (3, 3, R, Kl)), ("Rt", (3, 3, Kl)), ("Hii", (6, 6, Kl)),
                        ("Hij", (6, 6, Kl)), ("Hjj", (6, 6, Kl)), ("gl", (L, 3))):
        _check_shape(what, f"lin.{name}", getattr(lin, name), shape)


def _check_lin_inputs(what: str, pc: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str) -> tuple:
    """(Kl, R, L, robust kind code) of a row-range linearization's inputs, on
    every device."""
    Kl, L = pc.shape[-1], landmarks.shape[0]
    _check_shape(what, "pc", pc, (7, Kl))
    _check_shape(what, "landmarks", landmarks, (L, 3))
    return Kl, _check_edges(what, de, Kl, L), L, _robust(what, robust_kind)


def _linearize(what: str, pc: Tensor, pj: Tensor | None, landmarks: Tensor, de: SoAEdges, chain: ChainLin | None,
               R: int, kind: int, robust_delta: float) -> tuple[TiledLin, ChainLin]:
    """The entry point of ``csrc/tiled_linearize.cu`` on CUDA tensors: K6
    with K7's chain blocks (against the successors ``pj``) in its first
    launch (``chain`` None), or K6 alone on the given chain blocks."""
    dev = pc.device
    given = {"pj": pj} if chain is None else {f"chain.{k}": v for k, v in chain._asdict().items()}
    _check_device(what, dev, landmarks=landmarks, **_edges_on(de), **given)
    Kl, L = pc.shape[-1], landmarks.shape[0]

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_linearize")
    f32 = dict(dtype=torch.float32, device=dev)
    pose, lm, meas, info = _f32(pc), _f32(landmarks), _f32(de.meas), _f32(de.info)
    o_meas, o_info = _f32(de.o_meas_ch), _f32(de.o_info_ch)
    if chain is None:
        succ = _f32(pj)
        Hii, Hij, Hjj = (torch.empty((6, 6, Kl), **f32) for _ in range(3))
        gi, gj, chi_chain = torch.empty((6, Kl), **f32), torch.empty((6, Kl), **f32), torch.empty((), **f32)
    else:
        succ = None
        Hii, Hij, Hjj, gi, gj, chi_chain = (_f32(t) for t in chain)
    v, Ow = torch.empty((3, R, Kl), **f32), torch.empty((3, 3, R, Kl), **f32)
    Rt = torch.empty((3, 3, Kl), **f32)
    gp, diag = torch.empty((6, Kl), **f32), torch.empty((6, 6, Kl), **f32)
    gl, Hll = torch.empty((L, 3), **f32), torch.empty((L, 3, 3), **f32)
    chi = torch.empty((), **f32)
    RB, G = kernels._lin_split_on(dev, Kl, R)  # K6 alone takes the pair's split
    fused = int(chain is None)
    scratch = torch.empty((lib.tiled_lin_scratch(Kl, R, RB, fused),), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_lin_launch(
            pose.data_ptr(), None if succ is None else succ.data_ptr(), lm.data_ptr(), meas.data_ptr(),
            info.data_ptr(), de.ll_rk.data_ptr(), de.lm_slots.data_ptr(), de.lm_start.data_ptr(), o_meas.data_ptr(),
            o_info.data_ptr(), Kl, R, L, RB, G, fused, kind, float(robust_delta), Hii.data_ptr(), Hij.data_ptr(),
            Hjj.data_ptr(), gi.data_ptr(), gj.data_ptr(), chi_chain.data_ptr(), v.data_ptr(), Ow.data_ptr(),
            Rt.data_ptr(), gp.data_ptr(), diag.data_ptr(), gl.data_ptr(), Hll.data_ptr(), chi.data_ptr(),
            scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, f"{what} kernel launch", "tiled_linearize")
    dt = pc.dtype
    lin = TiledLin(
        v=v.to(dt), Ow=Ow.to(dt), Rt=Rt.to(dt), Hii=Hii.to(dt), Hij=Hij.to(dt), Hjj=Hjj.to(dt), gp=gp.to(dt),
        gj=gj.to(dt), diag=diag.to(dt), gl=gl.to(dt), Hll=Hll.to(dt), chi2=chi.to(dt),
    )
    return lin, ChainLin(*(t.to(dt) for t in (Hii, Hij, Hjj, gi, gj, chi_chain)))


def tiled_fused_linearize(pc: Tensor, pj: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str = "none",
                          robust_delta: float = 1.0) -> tuple[TiledLin, ChainLin]:
    """K6 + K7: the rows' linearization, one entry point of two launches with
    the chain (K7, each row against its successor pj) as blocks of K6's
    first launch. Returns the linearization and the chain's own blocks,
    gradients and chi2, whose i-side it folds in."""
    what = "tiled_fused_linearize"
    Kl, R, L, kind = _check_lin_inputs(what, pc, landmarks, de, robust_kind)
    _check_shape(what, "pj", pj, (7, Kl))
    if pc.device.type == "cpu":
        chain = sd.chain_plain(pc, pj, de)
        return sd.obs_plain(pc, landmarks, de, chain, robust_kind, robust_delta), chain
    out = _linearize(what, pc, pj, landmarks, de, None, R, kind, robust_delta)
    tiled_fused_linearize.launches += 1
    return out


def tiled_linearize(pc: Tensor, pj: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str = "none",
                    robust_delta: float = 1.0) -> TiledLin:
    """K6 + K7 (``tiled_fused_linearize``): the rows' linearization."""
    return tiled_fused_linearize(pc, pj, landmarks, de, robust_kind, robust_delta)[0]


def tiled_obs_linearize(pc: Tensor, landmarks: Tensor, de: SoAEdges, chain: ChainLin, robust_kind: str = "none",
                        robust_delta: float = 1.0) -> TiledLin:
    """K6 alone: the observation linearization of the rows, with the given
    chain's i-side (gi, Hii) folded in and its j-side passed through (the
    same entry point without its chain blocks)."""
    what = "tiled_obs_linearize"
    Kl, R, L, kind = _check_lin_inputs(what, pc, landmarks, de, robust_kind)
    for name, shape in (("Hii", (6, 6, Kl)), ("Hij", (6, 6, Kl)), ("Hjj", (6, 6, Kl)), ("gi", (6, Kl)),
                        ("gj", (6, Kl)), ("chi2", ())):
        _check_shape(what, f"chain.{name}", getattr(chain, name), shape)
    if pc.device.type == "cpu":
        return sd.obs_plain(pc, landmarks, de, chain, robust_kind, robust_delta)
    lin = _linearize(what, pc, None, landmarks, de, chain, R, kind, robust_delta)[0]
    tiled_obs_linearize.launches += 1
    return lin


def tiled_mv_fwd(lin: TiledLin, de: SoAEdges, x: Tensor) -> tuple[Tensor, Tensor]:
    """K8: (Oa [3, R, Kl], T [L, 3] over the rows' slots) for the masked
    direction x [6, Kl]."""
    what = "tiled_mv_fwd"
    Kl, L = x.shape[-1], lin.gl.shape[0]
    R = _check_edges(what, de, Kl, L)
    _check_lin(what, lin, R, Kl, L)
    _check_shape(what, "x", x, (6, Kl))
    if x.device.type == "cpu":
        return sd.mv_fwd_plain(lin, de, x)
    dev = x.device
    _check_device(what, dev, v=lin.v, Ow=lin.Ow, Rt=lin.Rt, lm_slots=de.lm_slots, lm_start=de.lm_start)

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_matvec")
    f32 = dict(dtype=torch.float32, device=dev)
    ins = [_f32(t) for t in (lin.v, lin.Ow, lin.Rt, x)]
    Oa, T = torch.empty((3, R, Kl), **f32), torch.empty((L, 3), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_mv_fwd_launch(
            *(t.data_ptr() for t in ins), de.lm_slots.data_ptr(), de.lm_start.data_ptr(), Kl, R, L, Oa.data_ptr(),
            T.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_mv_fwd kernel launch", "tiled_matvec")
    tiled_mv_fwd.launches += 1
    return Oa.to(x.dtype), T.to(x.dtype)


def tiled_mv_bwd(lin: TiledLin, de: SoAEdges, Oa: Tensor, z: Tensor, x: Tensor, xj: Tensor) -> tuple[Tensor, Tensor]:
    """K9: (u, vj) [6, Kl] given z = A^-1 T [L, 3]; vj unshifted."""
    what = "tiled_mv_bwd"
    Kl, L = x.shape[-1], lin.gl.shape[0]
    R = _check_edges(what, de, Kl, L)
    _check_lin(what, lin, R, Kl, L)
    for name, t, shape in (("Oa", Oa, (3, R, Kl)), ("z", z, (L, 3)), ("x", x, (6, Kl)), ("xj", xj, (6, Kl))):
        _check_shape(what, name, t, shape)
    if x.device.type == "cpu":
        return sd.mv_bwd_plain(lin, de, Oa, z, x, xj)
    dev = x.device
    _check_device(what, dev, Oa=Oa, z=z, xj=xj, ll_rk=de.ll_rk,
                  **{n: getattr(lin, n) for n in ("v", "Ow", "Rt", "Hii", "Hij", "Hjj")})

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_matvec")
    f32 = dict(dtype=torch.float32, device=dev)
    ins = [_f32(t) for t in (lin.v, lin.Ow, lin.Rt, Oa, z)]
    chain = [_f32(t) for t in (x, xj, lin.Hii, lin.Hij, lin.Hjj)]
    u, vj = torch.empty((6, Kl), **f32), torch.empty((6, Kl), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_mv_bwd_launch(
            *(t.data_ptr() for t in ins), de.ll_rk.data_ptr(), *(t.data_ptr() for t in chain), Kl, R, u.data_ptr(),
            vj.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_mv_bwd kernel launch", "tiled_matvec")
    tiled_mv_bwd.launches += 1
    return u.to(x.dtype), vj.to(x.dtype)


def tiled_chi2(pc: Tensor, pj: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str = "none",
               robust_delta: float = 1.0) -> Tensor:
    """K10: the rows' objective, as a 0-d tensor on the device."""
    what = "tiled_chi2"
    Kl, L = pc.shape[-1], landmarks.shape[0]
    _check_shape(what, "pc", pc, (7, Kl))
    _check_shape(what, "pj", pj, (7, Kl))
    _check_shape(what, "landmarks", landmarks, (L, 3))
    R = _check_edges(what, de, Kl, L)
    kind = _robust(what, robust_kind)
    if pc.device.type == "cpu":
        return sd.chi2_plain(pc, pj, landmarks, de, robust_kind, robust_delta)
    dev = pc.device
    _check_device(what, dev, pj=pj, landmarks=landmarks, **_edges_on(de))

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_chi2")
    f32 = dict(dtype=torch.float32, device=dev)
    ins = [_f32(t) for t in (pc, pj, landmarks, de.meas, de.info)]
    o_meas, o_info = _f32(de.o_meas_ch), _f32(de.o_info_ch)
    chi = torch.empty((), **f32)
    RB, G = kernels._lin_split_on(dev, Kl, R, chain=False)
    scratch = torch.empty((lib.tiled_chi2_scratch(Kl, R, RB),), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_chi2_launch(
            *(t.data_ptr() for t in ins), de.ll_rk.data_ptr(), o_meas.data_ptr(), o_info.data_ptr(), Kl, R, RB, G,
            kind, float(robust_delta), chi.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_chi2 kernel launch", "tiled_chi2")
    tiled_chi2.launches += 1
    return chi.to(pc.dtype)


tiled_fused_linearize.launches = 0  # calls that launched kernels (CUDA path only)
tiled_obs_linearize.launches = 0
tiled_mv_fwd.launches = 0
tiled_mv_bwd.launches = 0
tiled_chi2.launches = 0
