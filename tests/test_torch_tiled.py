"""The port's row-range (large-K) SoA loop and the plain versions of its
kernels K6-K10 against the JAX package, on the CPU.

Inputs are seeded numpy graphs handed to both packages: the chain graph of
``tests/test_solver.build_chain_graph`` (16 pose rows) with its observations
sorted into the engine's order (``tests/test_pcg._sort_obs_edges``); for the
kernels it is grown to fill all 16 rows (4 landmarks seen from every pose,
R=4). Each kernel runs on the whole row range and on the upper half
``[K/2, K)``. The JAX side
runs as ``tests/test_soa_dist.py`` runs it: the distributed loop's XLA
channel math (``use_tiled=False``), and the tiled Pallas kernels in interpret
mode with 4-row blocks (``use_tiled=True, interpret=True``). The XLA branch's
per-range pieces are closures inside ``soa_dist.run_lm_loop_soa_dist``; the
``xla_*`` helpers below restate them with the JAX package's own channel
functions. The JAX side's results are stored (``REF``,
``tests/jax_golden.py``). On the CPU the port's kernel wrappers run their
plain versions.

Tolerances:
  * f64 against the XLA branch: 1e-8 of each output's scale (summation order
    only: ``index_add_`` and batched einsums against one-hot contractions);
  * f32 against the Pallas kernels in interpret mode: 1e-4 of each output's
    scale;
  * the two-halves identity (partials of [0, K/2) and [K/2, K) summed,
    embedded and shifted against the whole range), f64: 1e-12 of scale;
  * the LM at fixed work: ``tests/test_soa_dist.py``'s bounds (poses atol
    1e-8 and chi2 rtol 1e-8 in f64, with marginals rtol 1e-6; poses atol 5e-4
    and chi2 rtol 1e-3 in f32 against the interpret-mode kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.solver import chain_soa as jchs
from semantic_slam_tpu.solver import ellk_soa as jsoa
from semantic_slam_tpu.solver import pallas_tiled as jpt
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu.solver import soa_dist as jsd
from semantic_slam_tpu.solver.pallas_cg import digit_split
from semantic_slam_tpu.solver.robust import robust_rho, robust_weight
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.runtime import engine as teng
from semantic_slam_tpu_torch.solver import chain_soa as tchs
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from semantic_slam_tpu_torch.solver import tiled_kernels as ttk
from semantic_slam_tpu_torch.solver.pcg import _edge_args
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

ROBUST = ["none", "huber", "dcs"]
RANGES = {"whole": lambda K: (0, K), "upper-half": lambda K: (K // 2, K // 2)}
KW = dict(max_iterations=12, rel_tol=0.0, max_cg_iters=16, cg_tol=0.0)
REF = jax_golden.Recorded("torch_tiled", tol=1e-8)


def close(got, want, rtol, err_msg=""):
    """|got - want| <= rtol * max|want| (scale-relative)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, atol=rtol * max(float(np.abs(want).max()), 1e-300), rtol=0, err_msg=err_msg)


def _graphs(dtype, perturb=False):
    """The chain graph in both packages: as ``tests/test_soa_dist.py`` builds
    it (6 of 16 pose rows live) for the LM; with ``perturb``, every pose row
    live and moved by ~5 cm and ~0.02 rad (seeded) for the kernels, so that
    both row ranges hold real edges and no chain output is rounding noise (at
    the start the poses integrate the odometry and every chain residual is
    0)."""
    g, _, _ = build_chain_graph(np.random.default_rng(0), n_poses=16 if perturb else 6, noise=0.05)
    if perturb:
        assert int(g.num_poses) == g.poses.shape[0]
        rng = np.random.default_rng(1)
        p = np.asarray(g.poses)
        p = p + np.concatenate([0.05 * rng.normal(size=(p.shape[0], 3)), 0.01 * rng.normal(size=(p.shape[0], 4))], 1)
        p[:, 3:] /= np.linalg.norm(p[:, 3:], axis=1, keepdims=True)
        g = g._replace(poses=jnp.asarray(p))
    if dtype == jnp.float32:
        g = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, g)
    g, rows = _sort_obs_edges(g)
    tg = tgs.graph_from_numpy({k: np.asarray(v) for k, v in g._asdict().items()})
    return g, tg, rows


@pytest.fixture(scope="module")
def f64():
    return _graphs(jnp.float64)


@pytest.fixture(scope="module")
def f32():
    return _graphs(jnp.float32)


@pytest.fixture(scope="module")
def moved64():
    return _graphs(jnp.float64, perturb=True)


@pytest.fixture(scope="module")
def moved32():
    return _graphs(jnp.float32, perturb=True)


@pytest.fixture()
def force_small_blocks():
    """4-row Pallas blocks, so that interpret mode runs real multi-block
    grids (``tests/test_soa_dist.py``)."""
    old = jpt._FORCE_BLOCK
    jpt._FORCE_BLOCK = 4
    yield
    jpt._FORCE_BLOCK = old


def jax_range(g, rows, off, Kl, use_tiled):
    """One row range of a graph as the JAX package lays it out: its dist
    edges and its pose channels (t, q, tj, qj)."""
    K, L, R = g.poses.shape[0], g.landmarks.shape[0], rows[2]
    ee = jpcg.build_ell_edges(jpcg._edge_args(g), K, R)
    jde = jsd.build_dist_edges(jax.tree.map(lambda a: a[off:off + Kl], ee), L, use_tiled)
    t, q = jnp.transpose(g.poses[:, :3]), jnp.transpose(g.poses[:, 3:7])
    tj, qj = jchs.roll_up_pose_ch(t), jchs.roll_up_pose_ch(q)
    return jde, [a[:, off:off + Kl] for a in (t, q, tj, qj)]


class Range:
    """One row range of a graph, laid out for the port."""

    def __init__(self, g, tg, rows, off, Kl):
        K, L, R = g.poses.shape[0], g.landmarks.shape[0], rows[2]
        self.off, self.Kl, self.L, self.R = off, Kl, L, R
        self.de = tsd.build_dist_edges(_edge_args(tg), K, R, L, off, Kl)
        pc = tg.poses.T
        self.pc, self.pj = pc[:, off:off + Kl], tchs.roll_up_pose_ch(pc)[:, off:off + Kl]

    def inputs(self, seed, dtype):
        """Shared matvec inputs: x, xj [6, Kl], z [L, 3], Oa [3, R, Kl]."""
        rng = np.random.default_rng(seed)
        return [rng.normal(size=s).astype(dtype) for s in ((6, self.Kl), (6, self.Kl), (self.L, 3),
                                                          (3, self.R, self.Kl))]


# ---------------------------------------------------------------------------
# the JAX loop's XLA channel math for one range (soa_dist.py:292-347,
# :373-395, :526-544)
# ---------------------------------------------------------------------------


def xla_lin(de, pose, landmarks, kind):
    (t, q, tj, qj), L, (R, _, Kl) = pose, landmarks.shape[0], de.meas_t.shape
    Hii, Hij, Hjj, gi, gj, chi_k = jchs.chain_linearize_ch(t, q, tj, qj, de.omt, de.omq, de.oO)
    meas = jnp.transpose(de.meas_t, (1, 0, 2))
    info = jnp.transpose(de.info_t.reshape(R, 3, 3, Kl), (1, 2, 0, 3))
    Rt = jsoa._rotmat_conj_channels(q[0], q[1], q[2], q[3])[:, :, None, :]
    lw = jsoa._gather_oh(de.oh_lo, de.oh_hi, landmarks, L)
    v = jsoa._m33_vec(Rt, jnp.transpose(lw.reshape(Kl, R, 3), (2, 1, 0)) - t[:, None, :])
    r = v - meas
    Or = jsoa._m33_vec(info, r)
    chi_e = sum(r[i] * Or[i] for i in range(3))
    chi_l = jnp.sum(robust_rho(chi_e.reshape(-1), kind, 1.0))
    Ow = info
    if kind != "none":
        w = robust_weight(chi_e.reshape(-1), kind, 1.0).reshape(R, Kl)
        Ow, Or = info * w[None, None], Or * w[None]
    gp_obs = jnp.concatenate([jnp.sum(-Or, axis=1), jnp.sum(-jsoa._cross(v, Or), axis=1)], axis=0)
    gl = jsoa._seg_sum_oh(de.oh_lo, de.oh_hi, jnp.transpose(jsoa._m33T_vec(Rt, Or), (2, 1, 0)).reshape(Kl * R, 3), L)
    Hll_e = jchs.m33T_mul(Rt, jchs.m33_mul(Ow, Rt))
    Hll = jsoa._seg_sum_oh(de.oh_lo, de.oh_hi, jnp.transpose(Hll_e, (3, 2, 0, 1)).reshape(Kl * R, 9), L)
    OB = jsoa._ob_product(Ow, v)
    diag_obs = jnp.sum(jsoa._assemble_h66(Ow, -OB, -jsoa._hat_mul(v, OB)), axis=2)
    return dict(v=v, Ow=Ow, Rt=Rt[:, :, 0], Hii=Hii, Hij=Hij, Hjj=Hjj, gp=gp_obs + gi, gj=gj, diag=diag_obs + Hii,
                gl=gl, Hll=Hll.reshape(L, 3, 3), chi2=jnp.sum(chi_k) + chi_l, chain_gi=gi, chain_chi2=jnp.sum(chi_k))


def xla_mv(de, lin, x, xj, z, Oa_in):
    L, (R, _, Kl) = z.shape[0], de.meas_t.shape
    v, Ow, Rt = lin["v"], lin["Ow"], lin["Rt"][:, :, None, :]
    a = -x[:3, None, :] + jsoa._cross(v, jnp.broadcast_to(x[3:, None, :], v.shape))
    Oa = jsoa._m33_vec(Ow, a)
    T = jsoa._seg_sum_oh(de.oh_lo, de.oh_hi, jnp.transpose(jsoa._m33T_vec(Rt, Oa), (2, 1, 0)).reshape(Kl * R, 3), L)
    zb = jnp.transpose(jsoa._gather_oh(de.oh_lo, de.oh_hi, z, L).reshape(Kl, R, 3), (2, 1, 0))
    m = Oa_in - jsoa._m33_vec(Ow, jsoa._m33_vec(Rt, zb))
    u = jnp.concatenate([jnp.sum(-m, axis=1), jnp.sum(-jsoa._cross(v, m), axis=1)], axis=0)
    u = u + jsoa._m66_vec(lin["Hii"], x) + jsoa._m66_vec(lin["Hij"], xj)
    vj = jsoa._m66T_vec(lin["Hij"], x) + jsoa._m66_vec(lin["Hjj"], xj)
    return dict(Oa=Oa, T=T, u=u, vj=vj)


def xla_range(g, rows, off, Kl, kind, x, xj, z, Oa_in):
    """The XLA branch on one row range: the linearization (with the chain's
    own gi and chi2) and the matvec halves on the inputs."""
    de, pose = jax_range(g, rows, off, Kl, use_tiled=False)
    lin = xla_lin(de, pose, g.landmarks, kind)
    return lin, xla_mv(de, lin, *map(jnp.asarray, (x, xj, z, Oa_in)))


def pallas_range(g, rows, off, Kl, x, xj, z):
    """The tiled Pallas kernels in interpret mode on one row range (Huber),
    laid out as the port's outputs: the linearization, the matvec halves on
    the inputs and chi2. The landmark digit grids are converted with the JAX
    package's helpers."""
    de, pose = jax_range(g, rows, off, Kl, use_tiled=True)
    L, R = g.landmarks.shape[0], rows[2]
    lo_w, hi = digit_split(L)

    def tab(grid, D):
        return jsd._grids_to_tab(grid, lo_w, hi, D, L)

    lmT = jsd._tab_to_grids(g.landmarks, lo_w, hi, 3, L)
    args = (lmT, de.meas_t, de.info_t, de.lodig, de.hidig, de.omt, de.omq, de.oO, lo_w)
    (v, Ow, Rt, Hii, Hij, Hjj, gp, gj, diag, _, glT, HllT, chi) = jpt.tiled_linearize(
        *pose, *args, robust_kind="huber", interpret=True)
    lin = dict(v=jnp.transpose(v, (1, 0, 2)), Ow=jnp.transpose(Ow.reshape(R, 3, 3, Kl), (1, 2, 0, 3)),
               Rt=Rt.reshape(3, 3, Kl), Hii=Hii, Hij=Hij, Hjj=Hjj, gp=gp, gj=gj, diag=diag.reshape(6, 6, Kl),
               gl=tab(glT, 3), Hll=tab(HllT, 9).reshape(L, 3, 3), chi2=chi)
    Oa, T = jpt.tiled_mv_fwd(v, Ow, de.lodig, de.hidig, Rt, jnp.asarray(x), lo_w, hi, interpret=True)
    u, vj = jpt.tiled_mv_bwd(v, Ow, de.lodig, de.hidig, Rt, Oa, jsd._tab_to_grids(jnp.asarray(z), lo_w, hi, 3, L),
                             jnp.asarray(x), jnp.asarray(xj), Hii, Hij, Hjj, lo_w, hi, interpret=True)
    mv = dict(Oa=jnp.transpose(Oa, (1, 0, 2)), T=tab(T, 3), u=u, vj=vj)
    return lin, mv, jpt.tiled_chi2(*pose, *args, robust_kind="huber", interpret=True)


def port_lin(rg, landmarks, kind):
    """The linearization of the fused wrapper (K6 + K7), with the chain's own
    gradient gi and chi2 beside it."""
    lin, chain = ttk.tiled_fused_linearize(rg.pc, rg.pj, landmarks, rg.de, kind, 1.0)
    return {**{f: getattr(lin, f) for f in lin._fields}, "chain_gi": chain.gi, "chain_chi2": chain.chi2}, lin


def port_mv(rg, lin, x, xj, z, Oa_in):
    Oa, T = ttk.tiled_mv_fwd(lin, rg.de, x)
    u, vj = ttk.tiled_mv_bwd(lin, rg.de, Oa_in, z, x, xj)
    return dict(Oa=Oa, T=T, u=u, vj=vj)


# ---------------------------------------------------------------------------
# K6-K10, plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", sorted(RANGES))
@pytest.mark.parametrize("robust", ROBUST)
def test_plain_matches_xla_f64(moved64, robust, where):
    """K6+K7 (the linearization, and the chain's own gi and chi2), K8 and K9
    (the matvec halves, on shared seeded inputs) and K10 (the objective)
    against the XLA branch."""
    g, tg, rows = moved64
    off, Kl = RANGES[where](g.poses.shape[0])
    rg = Range(g, tg, rows, off, Kl)
    x, xj, z, Oa = rg.inputs(1, np.float64)
    want_lin, want = REF(xla_range, g, rows, off, Kl, robust, x, xj, z, Oa)
    got, lin = port_lin(rg, tg.landmarks, robust)
    for name, w in want_lin.items():
        close(got[name].numpy(), w, 1e-8, name)
    got = port_mv(rg, lin, *map(torch.as_tensor, (x, xj, z, Oa)))
    for name, w in want.items():
        close(got[name].numpy(), w, 1e-8, name)
    chi = ttk.tiled_chi2(rg.pc, rg.pj, tg.landmarks, rg.de, robust, 1.0)
    close(chi.numpy(), want_lin["chi2"], 1e-8, "chi2")


def test_plain_matches_pallas_interpret_f32(moved32, force_small_blocks):
    """Each plain version in f32 against the TPU kernel it replaces, run in
    Pallas interpret mode on the upper half of the rows (Huber: both rho and
    the IRLS weight). (Interpret mode costs ~25 s of JAX compiles per row
    range on the CPU, so the whole range is left to the LM test below.)"""
    g, tg, rows = moved32
    off, Kl = RANGES["upper-half"](g.poses.shape[0])
    rg = Range(g, tg, rows, off, Kl)
    x, xj, z, _ = rg.inputs(2, np.float32)
    want, mv, chi = REF(pallas_range, g, rows, off, Kl, x, xj, z, context={"block": jpt._FORCE_BLOCK}, tol=1e-4)
    got, lin = port_lin(rg, tg.landmarks, "huber")
    for name, w in want.items():
        close(got[name].numpy(), w, 1e-4, name)
    got = port_mv(rg, lin, torch.as_tensor(x), torch.as_tensor(xj), torch.as_tensor(z), torch.as_tensor(mv["Oa"]))
    for name in ("Oa", "T", "u", "vj"):
        close(got[name].numpy(), mv[name], 1e-4, name)
    close(ttk.tiled_chi2(rg.pc, rg.pj, tg.landmarks, rg.de, "huber", 1.0).numpy(), chi, 1e-4, "chi2")


def test_two_halves_equal_whole(moved64):
    """The row-range contract a multi-device loop builds on: the partials of
    rows [0, K/2) and [K/2, K), summed (landmark tables, chi2) or embedded at
    their offsets (``_dus``) and summed, with the chain's j-side shifted after
    the sum, equal the whole range's result (K6+K7, then K8 -> K9)."""
    g, tg, rows = moved64
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    whole, lo, up = (Range(g, tg, rows, off, Kl) for off, Kl in ((0, K), (0, K // 2), (K // 2, K // 2)))
    parts = [ttk.tiled_linearize(r.pc, r.pj, tg.landmarks, r.de, "dcs", 1.0) for r in (whole, lo, up)]
    lw, la, lb = parts

    def embedded(name, a, b):
        return tsd._dus(getattr(a, name), lo.off, K) + tsd._dus(getattr(b, name), up.off, K)

    for name in ("gl", "Hll", "chi2"):
        close((getattr(la, name) + getattr(lb, name)).numpy(), getattr(lw, name).numpy(), 1e-12, name)
    for name in ("v", "Ow", "Rt", "gp", "gj", "diag", "Hjj"):
        close(embedded(name, la, lb).numpy(), getattr(lw, name).numpy(), 1e-12, name)
    close((embedded("gp", la, lb) + tsd._shift_down_soa(embedded("gj", la, lb))).numpy(),
          (lw.gp + tsd._shift_down_soa(lw.gj)).numpy(), 1e-12, "gp folded")

    x = torch.as_tensor(np.random.default_rng(3).normal(size=(6, K)))
    xj = tchs.roll_up_pose_ch(x)
    fwd = [ttk.tiled_mv_fwd(lin, r.de, tsd._slice_k(x, r.off, r.Kl)) for r, lin in zip((whole, lo, up), parts)]
    T = fwd[1][1] + fwd[2][1]
    close(T.numpy(), fwd[0][1].numpy(), 1e-12, "T")
    z = torch.einsum("lij,lj->li", torch.linalg.inv(lw.Hll + torch.eye(3, dtype=x.dtype)), T)
    u, vj = [], []
    for r, lin, (Oa, _) in zip((whole, lo, up), parts, fwd):
        ur, vr = ttk.tiled_mv_bwd(lin, r.de, Oa, z, tsd._slice_k(x, r.off, r.Kl), tsd._slice_k(xj, r.off, r.Kl))
        u.append(tsd._dus(ur, r.off, K))
        vj.append(tsd._dus(vr, r.off, K))
    close((u[1] + u[2] + tsd._shift_down_soa(vj[1] + vj[2])).numpy(),
          (u[0] + tsd._shift_down_soa(vj[0])).numpy(), 1e-12, "u")


def test_dist_edges_range_csr(f64):
    """The upper range's edge store holds its rows only, with slot ids local
    to it, and its CSR covers exactly its real slots."""
    g, tg, rows = f64
    K, L, R = g.poses.shape[0], g.landmarks.shape[0], rows[2]
    whole = tsd.build_dist_edges(_edge_args(tg), K, R, L)
    up = tsd.build_dist_edges(_edge_args(tg), K, R, L, K // 2)
    assert up.ll.shape == (K // 2, R) and torch.equal(up.meas, whole.meas[..., K // 2:])
    real = (up.info.abs().sum(dim=(0, 1)) > 0).reshape(-1)
    seg = up.lm_slots[:int(up.lm_start[L])].long()
    assert int(up.lm_start[L]) == int(real.sum()) and bool(real[seg].all())
    assert torch.equal(up.ll_rk.reshape(-1)[seg], torch.repeat_interleave(torch.arange(L), torch.diff(up.lm_start)))
    with pytest.raises(ValueError, match="inside"):
        tsd.build_dist_edges(_edge_args(tg), K, R, L, K // 2, K)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def test_lm_optimize_soa_tiled_fixed_work_f64(f64):
    """Fixed work, with the marginals: the JAX loop on XLA channel math."""
    g, tg, rows = f64
    jg, js, jm = REF(jsd.lm_optimize_soa_tiled, g, ell_rows=rows, use_tiled=False, with_marginals=True, **KW)
    tg2, ts, tm = tsd.lm_optimize_soa_tiled(tg, ell_rows=rows, with_marginals=True, **KW)
    assert ts.iterations == int(js.iterations) == KW["max_iterations"]
    np.testing.assert_allclose(tg2.poses.numpy(), np.asarray(jg.poses), atol=1e-8, rtol=0)
    np.testing.assert_allclose(tg2.landmarks.numpy(), np.asarray(jg.landmarks), atol=1e-8, rtol=0)
    for name in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(float(getattr(ts, name)), float(getattr(js, name)), rtol=1e-8)
    assert float(ts.chi2_final) < float(ts.chi2_initial)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-12)


def test_lm_optimize_soa_tiled_matches_pallas_interpret_f32(f32, force_small_blocks):
    g, tg, rows = f32
    jg, js = REF(jsd.lm_optimize_soa_tiled, g, ell_rows=rows, use_tiled=True, interpret=True,
                 context={"block": jpt._FORCE_BLOCK}, tol=5e-4, **KW)
    tg2, ts = tsd.lm_optimize_soa_tiled(tg, ell_rows=rows, **KW)
    np.testing.assert_allclose(tg2.poses.numpy(), np.asarray(jg.poses), atol=5e-4, rtol=0)
    np.testing.assert_allclose(float(ts.chi2_final), float(js.chi2_final), rtol=1e-3)


# ---------------------------------------------------------------------------
# the engine and the wrappers
# ---------------------------------------------------------------------------


def test_engine_dispatch():
    assert tsd.TILED_FROM_K == 4096
    assert [teng._soa_dispatch(K) for K in (512, 4096, 4097, 8192, 16384)] == ["soa", "soa", "tiled", "tiled",
                                                                                "tiled"]


def test_session_tiled_matches_resident(monkeypatch):
    """One small ``--solver pcg`` session on the CPU, f64, growing past its
    capacities, with the crossover lowered so that every solve takes the
    row-range loop: the same keyframes, map and edges as on the resident
    loop, poses within 1e-6."""
    from semantic_slam_tpu_torch.config import (
        AssociationConfig, CapacityConfig, KeyframeConfig, SegmentationConfig, SlamConfig, SolverConfig,
    )
    from semantic_slam_tpu_torch.io import replay, synthetic

    cfg = SlamConfig(
        keyframe=KeyframeConfig(delta_trans=0.4, delta_angle=0.4, delta_time=2.0),
        segmentation=SegmentationConfig(num_point_seg=100, norm_point_thres=400, planar_area=0.01, crop_height=32,
                                        crop_width=32, max_planes_per_detection=2, num_hypotheses=32,
                                        normal_smoothing_size=10),
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4),
        solver=SolverConfig(max_iterations=16, linear_solver="pcg", pcg_iters=32, dtype="float64"),
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=16, max_odom_edges=8, max_landmark_edges=32,
                                max_detections_per_frame=4),
    )
    log = synthetic.make_synthetic_log(seed=3, n_steps=90, sensor_every=5, drift_noise=0.008, H=96, W=128)
    calls = []
    orig = tsd.lm_optimize_soa_tiled

    def recording(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    def session(tiled_from):
        monkeypatch.setattr(tsd, "TILED_FROM_K", tiled_from)
        engine = teng.SlamEngine(cfg, device="cpu")
        replay.replay(log, engine)
        return engine

    resident = session(4096)
    assert not calls
    monkeypatch.setattr(tsd, "lm_optimize_soa_tiled", recording)
    tiled = session(0)
    assert calls and tiled.graph.max_poses > 8
    assert any(s["iterations"] > 0 for s in tiled.stats_history)
    assert (len(tiled.keyframes), int(tiled.table.count), int(tiled.graph.num_edges())) == (
        len(resident.keyframes), int(resident.table.count), int(resident.graph.num_edges()))
    n = int(resident.graph.num_lme)
    assert torch.equal(tiled.graph.lme_l[:n], resident.graph.lme_l[:n])
    np.testing.assert_allclose(tiled.get_keyframe_poses(), resident.get_keyframe_poses(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tiled.table.cov.numpy(), resident.table.cov.numpy(), atol=1e-6, rtol=0)


def test_wrappers_refuse_other_devices_and_bad_shapes(f32):
    """Only CPU tensors take the plain versions; any other device that is not
    CUDA is refused, and bad shapes and index types are refused on every
    device."""
    _, tg, rows = f32
    rg = Range(*f32, 0, tg.poses.shape[0])
    lin = ttk.tiled_linearize(rg.pc, rg.pj, tg.landmarks, rg.de)
    x = torch.zeros((6, rg.Kl))
    meta = rg.de._replace(**{k: v.to("meta") for k, v in rg.de._asdict().items()})
    with pytest.raises(ValueError, match="unsupported device"):
        ttk.tiled_linearize(rg.pc.to("meta"), rg.pj.to("meta"), tg.landmarks.to("meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ttk.tiled_chi2(rg.pc.to("meta"), rg.pj.to("meta"), tg.landmarks.to("meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ttk.tiled_mv_fwd(lin._replace(v=lin.v.to("meta")), meta, x.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        ttk.tiled_fused_linearize(rg.pc, rg.pj[:, 1:], tg.landmarks, rg.de)
    with pytest.raises(ValueError, match="shape"):
        ttk.tiled_obs_linearize(rg.pc, tg.landmarks[:-1], rg.de, tsd.chain_plain(rg.pc, rg.pj, rg.de))
    with pytest.raises(ValueError, match="shape"):
        ttk.tiled_mv_fwd(lin, rg.de, x[:, 1:])
    with pytest.raises(ValueError, match="shape"):
        ttk.tiled_mv_bwd(lin, rg.de, torch.zeros_like(lin.v), torch.zeros((3, 3)), x, x)
    with pytest.raises(TypeError, match="int32"):
        ttk.tiled_chi2(rg.pc, rg.pj, tg.landmarks, rg.de._replace(ll_rk=rg.de.ll_rk.long()))
    with pytest.raises(ValueError, match="unknown robust"):
        ttk.tiled_chi2(rg.pc, rg.pj, tg.landmarks, rg.de, "cauchy")
