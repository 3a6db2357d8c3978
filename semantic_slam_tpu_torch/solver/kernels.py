"""Hand-written CUDA kernels of the SoA Schur-PCG solver and their wrappers
(port of the resident kernels of ``semantic_slam_tpu.solver.pallas_cg``).

  * ``resident_linearize`` -- K1 + K2, ``csrc/soa_linearize.cu``: one entry
    point of two launches, K2 (the chain) as blocks of K1's first launch;
    ``fused_linearize`` also returns the chain's own outputs, and
    ``obs_linearize`` runs K1 alone on given chain blocks
  * ``resident_chi2``      -- K3, ``csrc/soa_chi2.cu``; ``lin_split`` spreads
    K1's, K3's (and the row-range K6's and K10's) slots over the grid
  * ``resident_solve``     -- K4, ``csrc/soa_solve.cu``, with the fixed-lag
    prior's dense boundary block when one is given; ``solve_shape`` picks
    its launch shape (one thread-block cluster or the cooperative grid)

On CPU tensors each wrapper runs its plain version (``solver/ellk_soa.py``
``soa_linearize``, ``soa_obs_linearize``, ``soa_chi2``,
``soa_schur_step``). On CUDA tensors it
launches its kernel on the current stream or raises; there is no other
switch between the two. The kernels work in f32, as the TPU kernels do:
inputs are cast to f32 and outputs back to the caller's dtype. No wrapper
synchronizes with the host: scalars that live on the device (lambda, chi2)
stay there. Each wrapper counts its calls that launch kernels in
``.launches``; ``resident_solve.prior_launches`` counts K4's launches with a
prior.
"""

from __future__ import annotations

import torch

from semantic_slam_tpu_torch.solver import ellk_soa as soa
from semantic_slam_tpu_torch.solver.ellk_soa import ChainLin, SoAEdges, SoALin

Tensor = torch.Tensor

ROBUST_KINDS = {"none": 0, "huber": 1, "dcs": 2}
MAX_SOLVE_BLOCKS = 4096  # K4's dot-product partials are sized for this many blocks

# K4's cluster shape (csrc/soa_solve.cu): up to 16 CTAs, each owning a range of
# poses (a multiple of 32) with its slots, pose blocks and the landmarks' z in
# shared memory, beside a fixed 17,764 bytes of static shared memory
SOLVE_CLUSTER_CTAS = 16
SOLVE_STATIC_SMEM = 17764


# K1's, K3's, K6's and K10's blocks (csrc/soa_common.cuh): 32 consecutive
# poses, one a lane, times up to 8 slot groups (warps); K2's chain blocks
# beside K1's, and K7's beside K6's, are 32 rows with the same warps
LIN_POSES = 32
LIN_MAX_GROUPS = 8
# warps of the slot pass an SM holds at once: 16 at the 128 registers a
# thread that its launch bounds allow (65,536 an SM), so 2 blocks of 8 slot
# groups or 4 of 4 (a block's 33,920 bytes of shared memory fit 4 times)
LIN_WARPS_PER_SM = 16


def lin_split(K: int, R: int, sms: int, chain: bool = True) -> tuple[int, int]:
    """The launch split ``(RB, G)`` of K1's, K3's, K6's and K10's slot pass: a
    slot block takes 32 poses and a chunk of RB of their R slots, walked by G
    slot groups (warps); the chunks of a pose range are blocks of their own.
    A grid of blocks of G warps fits one wave where it holds at most
    16 // G blocks an SM (``sms`` SMs). The grid is ceil(K / 32) pose ranges
    x ceil(R / RB) chunks, plus with ``chain`` the ceil(K / 32) chain blocks
    of K2 (or K7) in the same launch. RB is the smallest of min(8, R),
    doubled up to R, whose grid fits one wave at G = min(RB, 8); R where none
    does. G is min(RB, 8), or 4 where 8 spills a wave and 4 fits one. On an
    H100 (the sweep of ``tools/kernel_times.py --sweep``, PERF.md) this is
    the fastest split tried for K6 + K7 on all and on half of the tiled
    session's rows, and within 5% of the fastest for K1 + K2 and K3 at the
    fixed-lag pcg and pcg sessions' graphs; K6 alone takes the pair's split.
    Nothing else picks or forces a split."""
    ranges = -(-K // LIN_POSES)

    def fits(RB: int, G: int) -> bool:
        return ranges * -(-R // RB) + (ranges if chain else 0) <= LIN_WARPS_PER_SM // G * sms

    RB = min(LIN_MAX_GROUPS, R)
    while RB < R and not fits(RB, min(RB, LIN_MAX_GROUPS)):
        RB = min(2 * RB, R)
    G = min(RB, LIN_MAX_GROUPS)
    if G == LIN_MAX_GROUPS and not fits(RB, G) and fits(RB, G // 2):
        G //= 2
    return RB, G


def _lin_split_on(dev: torch.device, K: int, R: int, chain: bool = True) -> tuple[int, int]:
    return lin_split(K, R, torch.cuda.get_device_properties(dev).multi_processor_count, chain)


def solve_cluster_smem(K: int, R: int, L: int) -> int:
    """Bytes of shared memory one CTA of K4's cluster shape takes (the
    kernel's ``ClusterLayout`` and ``Shared``): per slot v, O', Oa and ll_rk
    (16 words), per pose Rt, the chain blocks (Hij and Hjj with one pose
    more), pf, M^-1 and five CG vectors (184 words, +72), per landmark z (3)."""
    per_cta = -(-K // SOLVE_CLUSTER_CTAS)
    Kb = 32 * -(-per_cta // 32)
    return 4 * (16 * R * Kb + 184 * Kb + 72 + 3 * L) + SOLVE_STATIC_SMEM


def solve_shape(K: int, R: int, L: int, smem_per_block: int) -> str:
    """K4's launch shape: ``"cluster"`` (one thread-block cluster, state in
    shared memory, hardware barriers) when a CTA's share of the graph fits the
    card's ``smem_per_block`` (bytes a block may opt in to: 232,448 on an
    H100), else ``"grid"`` (the cooperative grid over device memory). The
    fixed-lag prior's block stays in device memory in both, so it does not
    enter. Nothing else picks or forces a shape."""
    return "cluster" if solve_cluster_smem(K, R, L) <= smem_per_block else "grid"


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def _i32(t: Tensor) -> Tensor:
    return t.to(torch.int32).contiguous()


def _check_device(what: str, dev: torch.device, **tensors: Tensor) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {dev}")


def _check_shape(what: str, name: str, t: Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_edges(what: str, se: SoAEdges, K: int, L: int) -> int:
    R = se.ll_rk.shape[0]
    for name, shape in (
        ("ll_rk", (R, K)), ("meas", (3, R, K)), ("info", (3, 3, R, K)), ("o_meas_ch", (7, K)),
        ("o_info_ch", (6, 6, K)), ("lm_slots", (R * K,)), ("lm_start", (L + 1,)),
    ):
        _check_shape(what, f"se.{name}", getattr(se, name), shape)
    for name in ("ll_rk", "lm_slots", "lm_start"):
        if getattr(se, name).dtype != torch.int32:
            raise TypeError(f"{what}: se.{name} must be int32, got {getattr(se, name).dtype}")
    return R


def _robust(what: str, robust_kind: str) -> int:
    if robust_kind not in ROBUST_KINDS:
        raise ValueError(f"{what}: unknown robust kernel {robust_kind!r}")
    return ROBUST_KINDS[robust_kind]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_lin_inputs(what: str, poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str) -> tuple:
    """(K, R, L, robust kind code) of a linearization's inputs, on every
    device."""
    K, L = poses.shape[0], landmarks.shape[0]
    _check_shape(what, "poses", poses, (K, 7))
    _check_shape(what, "landmarks", landmarks, (L, 3))
    return K, _check_edges(what, se, K, L), L, _robust(what, robust_kind)


def _linearize(what: str, poses: Tensor, landmarks: Tensor, se: SoAEdges, chain: ChainLin | None, R: int,
               kind: int, robust_delta: float) -> tuple[SoALin, ChainLin]:
    """The entry point of ``csrc/soa_linearize.cu`` on CUDA tensors: K1 with
    K2's chain blocks in its first launch (``chain`` None), or K1 alone on
    the given chain blocks."""
    dev = poses.device
    given = {} if chain is None else {f"chain.{k}": v for k, v in chain._asdict().items()}
    _check_device(what, dev, landmarks=landmarks, **{f"se.{k}": v for k, v in se._asdict().items()}, **given)
    K, L = poses.shape[0], landmarks.shape[0]

    from semantic_slam_tpu_torch import _build

    lib = _build.library("soa_linearize")
    f32 = dict(dtype=torch.float32, device=dev)
    pose_ch, lm, meas, info = _f32(poses.T), _f32(landmarks), _f32(se.meas), _f32(se.info)
    o_meas, o_info = _f32(se.o_meas_ch), _f32(se.o_info_ch)
    if chain is None:
        Hii, Hij, Hjj = (torch.empty((6, 6, K), **f32) for _ in range(3))
        gi, gj, chi_chain = torch.empty((6, K), **f32), torch.empty((6, K), **f32), torch.empty((), **f32)
    else:
        Hii, Hij, Hjj, gi, gj, chi_chain = (_f32(t) for t in chain)
    v, Ow = torch.empty((3, R, K), **f32), torch.empty((3, 3, R, K), **f32)
    Rt = torch.empty((3, 3, K), **f32)
    gp, diag = torch.empty((6, K), **f32), torch.empty((6, 6, K), **f32)
    gl, Hll = torch.empty((L, 3), **f32), torch.empty((L, 3, 3), **f32)
    chi = torch.empty((), **f32)
    RB, G = _lin_split_on(dev, K, R)  # K1 alone takes the pair's split
    fused = int(chain is None)
    scratch = torch.empty((lib.soa_lin_scratch(K, R, RB, fused),), **f32)
    with torch.cuda.device(dev):
        code = lib.soa_lin_launch(
            pose_ch.data_ptr(), lm.data_ptr(), meas.data_ptr(), info.data_ptr(), se.ll_rk.data_ptr(),
            se.lm_slots.data_ptr(), se.lm_start.data_ptr(), o_meas.data_ptr(), o_info.data_ptr(), K, R, L, RB, G, fused,
            kind, float(robust_delta), Hii.data_ptr(), Hij.data_ptr(), Hjj.data_ptr(), gi.data_ptr(), gj.data_ptr(),
            chi_chain.data_ptr(), v.data_ptr(), Ow.data_ptr(), Rt.data_ptr(), gp.data_ptr(), diag.data_ptr(),
            gl.data_ptr(), Hll.data_ptr(), chi.data_ptr(), scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, f"{what} kernel launch", "soa_linearize")
    dt = poses.dtype
    lin = SoALin(
        v=v.to(dt), Ow=Ow.to(dt), Rt=Rt.to(dt), Hii=Hii.to(dt), Hij=Hij.to(dt), Hjj=Hjj.to(dt), Hll=Hll.to(dt),
        gp=gp.to(dt), gl=gl.to(dt), diag=diag.to(dt), chi2=chi.to(dt),
    )
    return lin, ChainLin(*(t.to(dt) for t in (Hii, Hij, Hjj, gi, gj, chi_chain)))


def fused_linearize(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none",
                    robust_delta: float = 1.0) -> tuple[SoALin, ChainLin]:
    """K1 + K2: the whole graph's linearization, one entry point of two
    launches with the chain (K2) as blocks of K1's first launch. Returns the
    linearization and the chain's own blocks, gradients and chi2, which it
    folds in."""
    what = "fused_linearize"
    K, R, L, kind = _check_lin_inputs(what, poses, landmarks, se, robust_kind)
    if poses.device.type == "cpu":
        chain = soa.soa_chain_linearize(poses, se)
        return soa.soa_obs_linearize(poses, landmarks, se, chain, robust_kind, robust_delta), chain
    out = _linearize(what, poses, landmarks, se, None, R, kind, robust_delta)
    fused_linearize.launches += 1
    return out


def resident_linearize(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none",
                       robust_delta: float = 1.0) -> SoALin:
    """K1 + K2 (``fused_linearize``): the whole graph's linearization."""
    return fused_linearize(poses, landmarks, se, robust_kind, robust_delta)[0]


def obs_linearize(poses: Tensor, landmarks: Tensor, se: SoAEdges, chain: ChainLin, robust_kind: str = "none",
                  robust_delta: float = 1.0) -> SoALin:
    """K1 alone: the observation linearization, folded with the given chain
    blocks (the same entry point without its chain blocks)."""
    what = "obs_linearize"
    K, R, L, kind = _check_lin_inputs(what, poses, landmarks, se, robust_kind)
    for name, shape in (("Hii", (6, 6, K)), ("Hij", (6, 6, K)), ("Hjj", (6, 6, K)), ("gi", (6, K)), ("gj", (6, K)),
                        ("chi2", ())):
        _check_shape(what, f"chain.{name}", getattr(chain, name), shape)
    if poses.device.type == "cpu":
        return soa.soa_obs_linearize(poses, landmarks, se, chain, robust_kind, robust_delta)
    lin = _linearize(what, poses, landmarks, se, chain, R, kind, robust_delta)[0]
    obs_linearize.launches += 1
    return lin


def resident_chi2(poses: Tensor, landmarks: Tensor, se: SoAEdges, robust_kind: str = "none",
                  robust_delta: float = 1.0) -> Tensor:
    """K3: the objective alone, as a 0-d tensor on the device."""
    if poses.device.type == "cpu":
        return soa.soa_chi2(poses, landmarks, se, robust_kind, robust_delta)
    what = "resident_chi2"
    dev = poses.device
    _check_device(what, dev, landmarks=landmarks, **{f"se.{k}": v for k, v in se._asdict().items()})
    K, L = poses.shape[0], landmarks.shape[0]
    _check_shape(what, "poses", poses, (K, 7))
    _check_shape(what, "landmarks", landmarks, (L, 3))
    R = _check_edges(what, se, K, L)
    kind = _robust(what, robust_kind)

    from semantic_slam_tpu_torch import _build

    lib = _build.library("soa_chi2")
    f32 = dict(dtype=torch.float32, device=dev)
    pose_ch, lm = _f32(poses.T), _f32(landmarks)
    meas, info, o_meas, o_info = _f32(se.meas), _f32(se.info), _f32(se.o_meas_ch), _f32(se.o_info_ch)
    chi = torch.empty((), **f32)
    RB, G = _lin_split_on(dev, K, R, chain=False)
    scratch = torch.empty((lib.soa_chi2_scratch(K, R, RB),), **f32)
    with torch.cuda.device(dev):
        code = lib.soa_chi2_launch(
            pose_ch.data_ptr(), lm.data_ptr(), meas.data_ptr(), info.data_ptr(), se.ll_rk.data_ptr(),
            o_meas.data_ptr(), o_info.data_ptr(), K, R, RB, G, kind, float(robust_delta), chi.data_ptr(),
            scratch.data_ptr(), _stream(dev),
        )
    _build.check(code, "soa_chi2 kernel launch", "soa_chi2")
    resident_chi2.launches += 1
    return chi.to(poses.dtype)


def _check_prior(what: str, prior_Hp: Tensor | None, prior_idx: Tensor | None) -> int:
    """PB of a fixed-lag prior (``prior_Hp [6PB,6PB]``, ``prior_idx [PB]``),
    0 without one."""
    if (prior_Hp is None) != (prior_idx is None):
        raise ValueError(f"{what}: prior_Hp and prior_idx go together")
    if prior_Hp is None:
        return 0
    PB = prior_idx.shape[0] if prior_idx.dim() == 1 else -1
    _check_shape(what, "prior_idx", prior_idx, (PB,))
    _check_shape(what, "prior_Hp", prior_Hp, (6 * PB, 6 * PB))
    if PB < 1:
        raise ValueError(f"{what}: a prior needs at least one boundary slot")
    return PB


def resident_solve(lin: SoALin, se: SoAEdges, lam: Tensor, pose_free: Tensor, lm_free: Tensor, n_steps: int,
                   cg_tol: float = 1e-8, prior_Hp: Tensor | None = None,
                   prior_idx: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """K4: the damped Schur-reduced PCG step (``n_steps`` steps under the
    ``active`` mask against ``cg_tol``) and the landmark back-substitution.
    ``lam`` is a 0-d tensor. With a fixed-lag prior (``prior_Hp
    [6PB,6PB]``, ``prior_idx [PB]``; ``lin`` already carries its gradient,
    diagonal and landmark part) the matvec adds the dense boundary block on
    every CG step. Returns (dp [K,6], db [L,3])."""
    PB = _check_prior("resident_solve", prior_Hp, prior_idx)
    if lin.gp.device.type == "cpu":
        return soa.soa_schur_step(lin, se, lam, pose_free, lm_free, n_steps, cg_tol, prior_Hp, prior_idx)
    what = "resident_solve"
    dev = lin.gp.device
    lam = torch.as_tensor(lam, device=dev)
    prior = {} if PB == 0 else {"prior_Hp": prior_Hp, "prior_idx": prior_idx}
    _check_device(what, dev, lam=lam, pose_free=pose_free, lm_free=lm_free, **prior,
                  **{f"lin.{k}": v for k, v in lin._asdict().items()},
                  **{f"se.{k}": v for k, v in se._asdict().items()})
    K, L = lin.gp.shape[1], lin.gl.shape[0]
    R = _check_edges(what, se, K, L)
    for name, shape in (
        ("v", (3, R, K)), ("Ow", (3, 3, R, K)), ("Rt", (3, 3, K)), ("Hii", (6, 6, K)), ("Hij", (6, 6, K)),
        ("Hjj", (6, 6, K)), ("diag", (6, 6, K)), ("gp", (6, K)), ("gl", (L, 3)), ("Hll", (L, 3, 3)),
    ):
        _check_shape(what, f"lin.{name}", getattr(lin, name), shape)
    _check_shape(what, "pose_free", pose_free, (K,))
    _check_shape(what, "lm_free", lm_free, (L,))
    _check_shape(what, "lam", lam, ())
    if n_steps < 0:
        raise ValueError(f"{what}: n_steps={n_steps} must be >= 0")

    from semantic_slam_tpu_torch import _build

    lib = _build.library("soa_solve")
    f32 = dict(dtype=torch.float32, device=dev)
    ins = [_f32(getattr(lin, n)) for n in ("v", "Ow", "Rt", "Hii", "Hij", "Hjj", "diag", "gp", "gl", "Hll")]
    lmf, pf, lam32 = _f32(lm_free), _f32(pose_free), _f32(lam)
    if PB:
        Hp, pidx = _f32(prior_Hp), _i32(prior_idx)
    else:  # never read: PB = 0 skips the prior branch
        Hp, pidx = torch.zeros((1,), **f32), torch.zeros((1,), dtype=torch.int32, device=dev)
    dp, db = torch.empty((6, K), **f32), torch.empty((L, 3), **f32)
    scratch = torch.empty((lib.soa_solve_scratch(K, R, L, PB, MAX_SOLVE_BLOCKS),), **f32)
    with torch.cuda.device(dev):
        smem = lib.soa_solve_smem_optin()
        if smem <= 0:
            raise RuntimeError(f"{what}: could not read the device's shared memory per block")
        shape = solve_shape(K, R, L, smem)
        code = lib.soa_solve_launch(
            *(t.data_ptr() for t in ins), lmf.data_ptr(), pf.data_ptr(), se.ll_rk.data_ptr(),
            se.lm_slots.data_ptr(), se.lm_start.data_ptr(), lam32.data_ptr(), Hp.data_ptr(), pidx.data_ptr(), PB,
            float(cg_tol), int(n_steps), K, R, L, dp.data_ptr(), db.data_ptr(), scratch.data_ptr(),
            MAX_SOLVE_BLOCKS, int(shape == "cluster"), _stream(dev),
        )
    _build.check(code, "soa_solve kernel launch", "soa_solve")
    resident_solve.launches += 1
    resident_solve.shapes[shape] += 1
    if PB:
        resident_solve.prior_launches += 1
    dt = lin.gp.dtype
    return dp.T.to(dt), db.to(dt)


fused_linearize.launches = 0  # calls that launched kernels (CUDA path only)
obs_linearize.launches = 0
resident_chi2.launches = 0
resident_solve.launches = 0
resident_solve.prior_launches = 0  # of those, launches with a fixed-lag prior
resident_solve.shapes = {"cluster": 0, "grid": 0}  # of those, launches per shape
