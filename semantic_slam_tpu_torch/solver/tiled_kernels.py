"""Hand-written CUDA kernels of the row-range SoA Schur-PCG loop and their
wrappers (port of ``semantic_slam_tpu.solver.pallas_tiled``).

  * ``tiled_chain_linearize`` -- K7, ``csrc/tiled_linearize.cu``
  * ``tiled_obs_linearize``   -- K6, ``csrc/tiled_linearize.cu``: K1's two
    launches (``csrc/soa_common.cuh``) on the rows' arrays, split by
    ``kernels.lin_split``; ``tiled_linearize`` runs K7 then K6
  * ``tiled_mv_fwd``          -- K8, ``csrc/tiled_matvec.cu``
  * ``tiled_mv_bwd``          -- K9, ``csrc/tiled_matvec.cu``
  * ``tiled_chi2``            -- K10, ``csrc/tiled_chi2.cu``

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
host. Each counts its kernel launches in ``.launches``.

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


def tiled_chain_linearize(pc: Tensor, pj: Tensor, de: SoAEdges) -> ChainLin:
    """K7: the chain linearization of each row against its successor pj."""
    what = "tiled_chain_linearize"
    Kl = pc.shape[-1]
    for name, t, shape in (("pc", pc, (7, Kl)), ("pj", pj, (7, Kl)), ("de.o_meas_ch", de.o_meas_ch, (7, Kl)),
                           ("de.o_info_ch", de.o_info_ch, (6, 6, Kl))):
        _check_shape(what, name, t, shape)
    if pc.device.type == "cpu":
        return sd.chain_plain(pc, pj, de)
    dev = pc.device
    _check_device(what, dev, pj=pj, o_meas_ch=de.o_meas_ch, o_info_ch=de.o_info_ch)

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_linearize")
    f32 = dict(dtype=torch.float32, device=dev)
    ins = [_f32(t) for t in (pc, pj, de.o_meas_ch, de.o_info_ch)]
    Hii, Hij, Hjj = (torch.empty((6, 6, Kl), **f32) for _ in range(3))
    gi, gj = torch.empty((6, Kl), **f32), torch.empty((6, Kl), **f32)
    chi = torch.empty((), **f32)
    scratch = torch.empty((lib.tiled_chain_lin_scratch(Kl),), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_chain_lin_launch(
            *(t.data_ptr() for t in ins), Kl, Hii.data_ptr(), Hij.data_ptr(), Hjj.data_ptr(), gi.data_ptr(),
            gj.data_ptr(), chi.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_chain_lin kernel launch", "tiled_linearize")
    tiled_chain_linearize.launches += 1
    dt = pc.dtype
    return ChainLin(*(t.to(dt) for t in (Hii, Hij, Hjj, gi, gj, chi)))


def tiled_obs_linearize(pc: Tensor, landmarks: Tensor, de: SoAEdges, chain: ChainLin, robust_kind: str = "none",
                        robust_delta: float = 1.0) -> TiledLin:
    """K6: the observation linearization of the rows, with the chain's
    i-side (K7's gi, Hii) folded in and its j-side passed through."""
    what = "tiled_obs_linearize"
    Kl, L = pc.shape[-1], landmarks.shape[0]
    _check_shape(what, "pc", pc, (7, Kl))
    _check_shape(what, "landmarks", landmarks, (L, 3))
    R = _check_edges(what, de, Kl, L)
    for name, shape in (("Hii", (6, 6, Kl)), ("Hij", (6, 6, Kl)), ("Hjj", (6, 6, Kl)), ("gi", (6, Kl)),
                        ("gj", (6, Kl)), ("chi2", ())):
        _check_shape(what, f"chain.{name}", getattr(chain, name), shape)
    kind = _robust(what, robust_kind)
    if pc.device.type == "cpu":
        return sd.obs_plain(pc, landmarks, de, chain, robust_kind, robust_delta)
    dev = pc.device
    _check_device(what, dev, landmarks=landmarks, **_edges_on(de),
                  **{f"chain.{k}": v for k, v in chain._asdict().items()})

    from semantic_slam_tpu_torch import _build

    lib = _build.library("tiled_linearize")
    f32 = dict(dtype=torch.float32, device=dev)
    pose, lm, meas, info = _f32(pc), _f32(landmarks), _f32(de.meas), _f32(de.info)
    Hii, Hij, Hjj, gi, gj, chi_chain = (_f32(t) for t in chain)
    v, Ow = torch.empty((3, R, Kl), **f32), torch.empty((3, 3, R, Kl), **f32)
    Rt = torch.empty((3, 3, Kl), **f32)
    gp, diag = torch.empty((6, Kl), **f32), torch.empty((6, 6, Kl), **f32)
    gl, Hll = torch.empty((L, 3), **f32), torch.empty((L, 3, 3), **f32)
    chi = torch.empty((), **f32)
    RB, G = kernels._lin_split_on(dev, Kl, R, chain=False)
    scratch = torch.empty((lib.tiled_obs_lin_scratch(Kl, R, RB),), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_obs_lin_launch(
            pose.data_ptr(), lm.data_ptr(), meas.data_ptr(), info.data_ptr(), de.ll_rk.data_ptr(),
            de.lm_slots.data_ptr(), de.lm_start.data_ptr(), Hii.data_ptr(), gi.data_ptr(), chi_chain.data_ptr(),
            Kl, R, L, RB, G, kind, float(robust_delta), v.data_ptr(), Ow.data_ptr(), Rt.data_ptr(), gp.data_ptr(),
            diag.data_ptr(), gl.data_ptr(), Hll.data_ptr(), chi.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_obs_lin kernel launch", "tiled_linearize")
    tiled_obs_linearize.launches += 1
    dt = pc.dtype
    return TiledLin(
        v=v.to(dt), Ow=Ow.to(dt), Rt=Rt.to(dt), Hii=Hii.to(dt), Hij=Hij.to(dt), Hjj=Hjj.to(dt), gp=gp.to(dt),
        gj=gj.to(dt), diag=diag.to(dt), gl=gl.to(dt), Hll=Hll.to(dt), chi2=chi.to(dt),
    )


def tiled_linearize(pc: Tensor, pj: Tensor, landmarks: Tensor, de: SoAEdges, robust_kind: str = "none",
                    robust_delta: float = 1.0) -> TiledLin:
    """K7 then K6: the rows' linearization."""
    return tiled_obs_linearize(pc, landmarks, de, tiled_chain_linearize(pc, pj, de), robust_kind, robust_delta)


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
    scratch = torch.empty((lib.tiled_chi2_scratch(Kl),), **f32)
    with torch.cuda.device(dev):
        code = lib.tiled_chi2_launch(
            *(t.data_ptr() for t in ins), de.ll_rk.data_ptr(), o_meas.data_ptr(), o_info.data_ptr(), Kl, R, kind,
            float(robust_delta), chi.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, "tiled_chi2 kernel launch", "tiled_chi2")
    tiled_chi2.launches += 1
    return chi.to(pc.dtype)


tiled_chain_linearize.launches = 0  # kernel launches (CUDA path only)
tiled_obs_linearize.launches = 0
tiled_mv_fwd.launches = 0
tiled_mv_bwd.launches = 0
tiled_chi2.launches = 0
