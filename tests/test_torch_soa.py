"""The port's SoA Schur-PCG solver against the JAX package, on the CPU.

Inputs are seeded numpy graphs handed to both packages: the chain graph of
``tests/test_solver.build_chain_graph`` with its observations sorted into the
engine's order (``tests/test_pcg._sort_obs_edges``), and
``__graft_entry__._build_graph``. On the CPU the port's kernel wrappers run
their plain versions, so these tests hold the plain versions (and the loop
around them) to the JAX functions, whose results are stored (``REF``,
``tests/jax_golden.py``) where they cost a compile.

Tolerances:
  * f64 against JAX's XLA path: 1e-12 for the chain and PCR math, 1e-10
    relative to each quantity's scale for the linearization, the Schur step
    and the LM at fixed work (summation order only: ``index_add_`` and
    batched einsums against XLA's one-hot contractions);
  * f32 against the Pallas kernels in interpret mode: rtol 1e-4, atol 1e-5
    (``tests/test_pallas_cg.py``'s bounds);
  * the layouts (``build_slots``, ``build_ell_edges``, the synthetic graph):
    exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_graph, _ell_rows_for
import jax_golden
from semantic_slam_tpu.solver import chain_soa as jchs
from semantic_slam_tpu.solver import ellk_soa as jsoa
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu.solver import tridiag as jtd
from semantic_slam_tpu.solver.assembly import build_slots as jbuild_slots
from semantic_slam_tpu.solver.lm import _free_masks as jfree
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.graph import synthetic as tsyn
from semantic_slam_tpu_torch.solver import chain_soa as tchs
from semantic_slam_tpu_torch.solver import ellk_soa as tsoa
from semantic_slam_tpu_torch.solver import kernels as tk
from semantic_slam_tpu_torch.solver import pcg as tpcg
from semantic_slam_tpu_torch.solver import tridiag as ttd
from semantic_slam_tpu_torch.solver.lm import _free_masks as tfree
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph

ROBUST = ["none", "huber", "dcs"]


# the JAX package's results, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_soa", tol=1e-10)

def close(got, want, rtol, err_msg=""):
    """|got - want| <= rtol * max|want| (scale-relative)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, atol=rtol * max(float(np.abs(want).max()), 1e-300), rtol=0, err_msg=err_msg)


def to_torch(jg):
    return tgs.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})


def _graphs(dtype):
    g, _, _ = build_chain_graph(np.random.default_rng(0), noise=0.05)
    if dtype == jnp.float32:
        g = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, g)
    g, rows = _sort_obs_edges(g)
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    tg = to_torch(g)
    jse = jsoa.build_soa_edges(jpcg._edge_args(g), K, rows[2], L)
    tse = tsoa.build_soa_edges(tpcg._edge_args(tg), K, rows[2], L)
    return g, tg, rows, jse, tse


@pytest.fixture(scope="module")
def f64():
    return _graphs(jnp.float64)


@pytest.fixture(scope="module")
def f32():
    return _graphs(jnp.float32)


# ---------------------------------------------------------------------------
# chain_soa and tridiag
# ---------------------------------------------------------------------------


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw])


def _random_chain_inputs(rng, K, dtype=np.float64):
    """Chain edges as the solver sees them: arbitrary absolute poses, relative
    motions of up to ~0.6 rad and measurements within ~0.2 rad of them (near
    pi, Jr^-1's cot(theta/2) amplifies rounding past 1e-12)."""
    def quats(scale):
        q = np.concatenate([np.ones((1, K)), scale * rng.normal(size=(3, K))])
        return q / np.linalg.norm(q, axis=0)

    q_i = rng.normal(size=(4, K))
    q_i /= np.linalg.norm(q_i, axis=0)
    dq = quats(0.3)
    t_i, t_j, m_t = (rng.normal(size=(3, K)) for _ in range(3))
    A = rng.normal(size=(K, 6, 6))
    O = np.transpose(A @ np.swapaxes(A, -1, -2) + np.eye(6), (1, 2, 0))
    return [a.astype(dtype) for a in (t_i, q_i, t_j, _qmul(q_i, dq), m_t, _qmul(dq, quats(0.1)), O)]


def _newton_quat_log(q):
    """The JAX package's quaternion log, Newton atan2 and all (chain_soa.py
    ``_atan2_q1``), in torch: isolates the one op the port changed."""
    sign = torch.where(q[0:1] < 0, -1.0, 1.0).to(q.dtype)
    q = q * sign
    w = torch.clamp(q[0], -1.0, 1.0)
    v = q[1:]
    vnorm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    c_in = torch.clamp(w, min=0.0)
    rad = torch.sqrt(vnorm * vnorm + c_in * c_in)
    s, c = vnorm / rad, c_in / rad
    y = (np.pi / 2.0) * s / (s + c)
    for _ in range(2):
        y = y - (torch.sin(y) * c - torch.cos(y) * s) / (torch.cos(y) * c + torch.sin(y) * s)
    scale = torch.where(vnorm < 1e-8, 2.0 / torch.clamp(w, min=1e-12), 2.0 * y / torch.clamp(vnorm, min=1e-32))
    return scale * v


def test_chain_soa_matches_f64(monkeypatch):
    """With the JAX package's Newton atan2 swapped in, the chain math agrees
    to 1e-12 in f64. With the port's torch.atan2 it agrees to 1e-10: the
    Newton form is off by up to 5.8e-13 rad in f64 (measured over [0, pi/2]),
    and Jr^-1 and the information weights carry that into the blocks."""
    rng = np.random.default_rng(0)
    args = _random_chain_inputs(rng, 33)
    want = jchs.chain_linearize_ch(*(jnp.asarray(a) for a in args))
    want_chi = jchs.chain_chi2_ch(*(jnp.asarray(a) for a in args))
    for tol, log in ((1e-10, tchs.quat_log_ch), (1e-12, _newton_quat_log)):
        monkeypatch.setattr(tchs, "quat_log_ch", log)
        got = tchs.chain_linearize_ch(*(torch.as_tensor(a) for a in args))
        for name, g, w in zip(("Hii", "Hij", "Hjj", "gi", "gj", "chi"), got, want):
            close(g.numpy(), w, tol, f"{name} at {tol}")
        close(tchs.chain_chi2_ch(*(torch.as_tensor(a) for a in args)).numpy(), want_chi, tol)
    t, q, dv, dw = args[0], args[1], rng.normal(size=(3, 33)) * 0.2, rng.normal(size=(3, 33)) * 0.2
    dw[:, :3] = 1e-6  # the small-angle branch
    for g, w in zip(tchs.retract_ch(*(torch.as_tensor(a) for a in (t, q, dv, dw))),
                    jchs.retract_ch(*(jnp.asarray(a) for a in (t, q, dv, dw)))):
        close(g.numpy(), w, 1e-12)


def test_quat_log_atan2():
    """The port's quaternion log uses torch.atan2 where the JAX one iterates a
    Newton atan2. In f64 the port is exact to resolution (1e-15 against
    numpy's arctan2) and the JAX form is within 2e-12 (twice its measured
    5.8e-13 rad angle error). In f32 the two agree within 2e-6 rad."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 257))
    q /= np.linalg.norm(q, axis=0)
    q[:, :4] = np.array([[1.0, 0, 0, 0], [0.0, 1, 0, 0], [1e-9, 1, 0, 0], [-1.0, 1e-9, 0, 0]]).T
    got = tchs.quat_log_ch(torch.as_tensor(q)).numpy()
    qs = q * np.where(q[0:1] < 0, -1.0, 1.0)
    vn = np.linalg.norm(qs[1:], axis=0)
    exact = np.where(vn < 1e-8, 2.0 / np.maximum(qs[0], 1e-12),
                     2.0 * np.arctan2(vn, np.maximum(qs[0], 0.0)) / np.maximum(vn, 1e-32)) * qs[1:]
    np.testing.assert_allclose(got, exact, atol=1e-15, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jchs.quat_log_ch(jnp.asarray(q))), atol=2e-12, rtol=0)
    q32 = q.astype(np.float32)
    np.testing.assert_allclose(tchs.quat_log_ch(torch.as_tensor(q32)).numpy(),
                               np.asarray(jchs.quat_log_ch(jnp.asarray(q32))), atol=2e-6, rtol=0)


def test_tridiag_matches_f64():
    rng = np.random.default_rng(2)
    K = 13
    A = rng.normal(size=(K, 6, 6))
    diag = A @ np.swapaxes(A, -1, -2) + 6.0 * np.eye(6)
    upper = 0.3 * rng.normal(size=(K, 6, 6))
    upper[-1] = 0.0
    jf = jtd.pcr_factor(jnp.asarray(diag), jnp.asarray(upper))
    tf = ttd.pcr_factor(torch.as_tensor(diag), torch.as_tensor(upper))
    for g, w in zip(tf, jf):
        close(g.numpy(), w, 1e-12)
    r, cols = rng.normal(size=(K, 6)), rng.normal(size=(K, 6, 5))
    close(ttd.pcr_solve(tf, torch.as_tensor(r)).numpy(), jtd.pcr_solve(jf, jnp.asarray(r)), 1e-12)
    close(ttd.pcr_solve_cols(tf, torch.as_tensor(cols)).numpy(), jtd.pcr_solve_cols(jf, jnp.asarray(cols)), 1e-12)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def test_build_slots_and_ell_edges_exact(f64):
    g, tg, rows, _, _ = f64
    K, R = g.poses.shape[0], rows[2]
    for idx, mask, r in ((g.lme_k, g.lme_mask(), R), (g.odom_i, g.odom_mask(), 1)):
        got = tpcg.build_slots(torch.as_tensor(np.asarray(idx)), torch.as_tensor(np.asarray(mask)), K, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbuild_slots(idx, mask, K, r)))
    want = REF(jpcg.build_ell_edges, jpcg._edge_args(g), K, R, tol=0.0)
    got = tpcg.build_ell_edges(tpcg._edge_args(tg), K, R)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    # empty chain rows carry the identity measurement (NaN * 0 stays NaN)
    assert (got.o_w.numpy() == 0).any()
    np.testing.assert_array_equal(got.o_meas.numpy()[got.o_w.numpy() == 0], [[0, 0, 0, 1, 0, 0, 0]] * int((got.o_w == 0).sum()))


def test_landmark_csr(f64):
    """Every real slot sits in its landmark's CSR segment, in ascending slot
    order; empty slots sit past lm_start[L]."""
    g, _, rows, _, se = f64
    K, L, R = g.poses.shape[0], g.landmarks.shape[0], rows[2]
    real = (se.info.abs().sum(dim=(0, 1)) > 0).numpy()  # [R, K]
    start, slots = se.lm_start.numpy(), se.lm_slots.numpy()
    assert start[0] == 0 and start[L] == real.sum() and len(slots) == R * K
    ll = se.ll_rk.numpy().reshape(-1)
    for l in range(L):
        seg = slots[start[l]:start[l + 1]]
        assert (np.diff(seg) > 0).all() and (ll[seg] == l).all() and real.reshape(-1)[seg].all()


def test_graph_synthetic_matches_build_graph():
    for dtype, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        jg = _build_graph(64, 16, 256, dtype, seed=3, noise=0.05)
        tg = tsyn.build_graph(64, 16, 256, tdt, seed=3, noise=0.05)
        got = tgs.graph_to_numpy(tg)
        for name, leaf in jg._asdict().items():
            np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=name)
            assert got[name].dtype == np.asarray(leaf).dtype, name
    assert tsyn.ell_rows_for(4096, 16384) == _ell_rows_for(4096, 16384) == (1, 1, 4)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against XLA (f64) and Pallas (f32)
# ---------------------------------------------------------------------------


def _lin_fields(lin_t, lin_j):
    """(name, port value, JAX value) of every linearization output, in the
    JAX layout."""
    return [
        ("v", lin_t.v, lin_j.v), ("Ow", lin_t.Ow, lin_j.Ow), ("Rt", lin_t.Rt, jnp.squeeze(lin_j.Rt, 2)),
        ("Hii", lin_t.Hii, lin_j.Hii), ("Hij", lin_t.Hij, lin_j.Hij), ("Hjj", lin_t.Hjj, lin_j.Hjj),
        ("Hll", lin_t.Hll, lin_j.Hll), ("gp", lin_t.gp.T, lin_j.gp), ("gl", lin_t.gl, lin_j.gl),
        ("diag", lin_t.diag.permute(2, 0, 1), lin_j.diag), ("chi2", lin_t.chi2, lin_j.chi2),
    ]


@pytest.mark.parametrize("robust", ROBUST)
def test_linearize_and_chi2_match_xla_f64(f64, robust):
    g, tg, _, jse, tse = f64
    lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse, robust_kind=robust, robust_delta=1.0)
    lin_t = tk.resident_linearize(tg.poses, tg.landmarks, tse, robust, 1.0)
    for name, got, want in _lin_fields(lin_t, lin_j):
        close(got.numpy(), want, 1e-10, name)
    chi_t = tk.resident_chi2(tg.poses, tg.landmarks, tse, robust, 1.0)
    close(chi_t.numpy(), REF(jsoa.soa_chi2, g.poses, g.landmarks, jse, robust_kind=robust, robust_delta=1.0), 1e-10)
    close(chi_t.numpy(), lin_t.chi2.numpy(), 1e-12)


def test_stored_reference_matches_live(f64):
    """A stored Schur step recomputed by the JAX package (on its stored
    linearization): the stored file is still what the package computes, in
    this run."""
    g, _, _, jse, _ = f64
    lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse)
    REF.check_live(jsoa.soa_schur_step, lin_j, jse, jnp.float64(1e-3), *jfree(g), 64, cg_tol=0.0)


@pytest.mark.parametrize("cg_tol", [0.0, 1e-6], ids=["fixed-work", "early-exit"])
def test_schur_step_matches_xla_f64(f64, cg_tol):
    """The port's fixed-count masked CG equals JAX's early-exit while loop."""
    g, tg, _, jse, tse = f64
    lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse)
    lin_t = tsoa.soa_linearize(tg.poses, tg.landmarks, tse)
    for lam in (1e-3, 10.0):
        dp_j, db_j = REF(jsoa.soa_schur_step, lin_j, jse, jnp.float64(lam), *jfree(g), 64, cg_tol=cg_tol)
        dp_t, db_t = tk.resident_solve(lin_t, tse, torch.tensor(lam, dtype=torch.float64), *tfree(tg), 64, cg_tol)
        close(dp_t.numpy(), dp_j, 1e-10, "dp")
        close(db_t.numpy(), db_j, 1e-10, "db")


@pytest.mark.parametrize("kernel", ["linearize", "chi2", "solve"])
def test_plain_matches_pallas_interpret_f32(f32, kernel):
    """Each kernel's plain version against the TPU kernel it replaces, run
    once in Pallas interpret mode, in f32 (Huber: both the rho and the IRLS
    weight; the solve with the early-exit mask)."""
    g, tg, _, jse, tse = f32
    kw = dict(use_pallas=True, pallas_interpret=True)
    if kernel == "linearize":
        lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse, robust_kind="huber", robust_delta=1.0, tol=1e-5,
                    **kw)
        lin_t = tk.resident_linearize(tg.poses, tg.landmarks, tse, "huber", 1.0)
        for name, got, want in _lin_fields(lin_t, lin_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=name)
    elif kernel == "chi2":
        want = REF(jsoa.soa_chi2, g.poses, g.landmarks, jse, robust_kind="huber", robust_delta=1.0, tol=1e-5, **kw)
        got = tk.resident_chi2(tg.poses, tg.landmarks, tse, "huber", 1.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    else:
        lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse, tol=1e-6)
        lin_t = tsoa.soa_linearize(tg.poses, tg.landmarks, tse)
        dp_j, db_j = REF(jsoa.soa_schur_step, lin_j, jse, jnp.float32(1e-3), *jfree(g), 64, cg_tol=1e-6, tol=1e-6, **kw)
        dp_t, db_t = tk.resident_solve(lin_t, tse, torch.tensor(1e-3), *tfree(tg), 64, 1e-6)
        np.testing.assert_allclose(dp_t.numpy(), np.asarray(dp_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(db_t.numpy(), np.asarray(db_j), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the LM and the marginals
# ---------------------------------------------------------------------------


def test_lm_optimize_soa_fixed_work_f64():
    """Fixed work (rel_tol=0), with the matrix-free marginals, on a
    ``_build_graph`` graph: the same poses, landmarks, chi2 and marginals."""
    K, L, E2 = 32, 12, 100
    jg = _build_graph(K, L, E2, jnp.float64, seed=0, noise=0.05)
    tg = to_torch(jg)
    kw = dict(max_iterations=6, rel_tol=0.0, ell_rows=_ell_rows_for(K, E2), max_cg_iters=32, with_marginals=True)
    jg2, js, jm = REF(jsoa.lm_optimize_soa, jg, use_pallas=False, **kw)
    tg2, ts, tm = tsoa.lm_optimize_soa(tg, **kw)
    assert ts.iterations == int(js.iterations) == 6
    n, m = int(jg.num_poses), int(jg.num_landmarks)
    close(tg2.poses[:n].numpy(), jg2.poses[:n], 1e-10, "poses")
    close(tg2.landmarks[:m].numpy(), jg2.landmarks[:m], 1e-10, "landmarks")
    for name in ("chi2_initial", "chi2_final", "lambda_final"):
        close(getattr(ts, name).numpy(), getattr(js, name), 1e-10, name)
    assert float(ts.chi2_final) < float(ts.chi2_initial)
    close(tm.numpy(), jm, 1e-10, "marginals")


def test_marginals_graph_matches_f64(f64):
    """The on-demand matrix-free recovery (Euclidean-gating export) equals
    the JAX package's ``pcg.landmark_marginals_graph``."""
    g, tg, rows, _, _ = f64
    close(tsoa.landmark_marginals_graph(tg, rows).numpy(), REF(jpcg.landmark_marginals_graph, g), 1e-10)


def test_skip_below_min_edges(f64):
    """Below ``min_edges`` the graph comes back unchanged with 0 iterations
    and the objective at the start (held against JAX in the chi2 test)."""
    _, tg, rows, _, tse = f64
    tg2, stats = tsoa.lm_optimize_soa(tg, min_edges=10_000, ell_rows=rows)
    assert stats.iterations == 0 and torch.equal(tg2.poses, tg.poses)
    assert torch.equal(stats.chi2_final, tsoa.soa_chi2(tg.poses, tg.landmarks, tse))


def test_wrappers_refuse_other_devices(f32):
    """Only CPU tensors take the plain versions; any other device that is not
    CUDA is refused, not computed elsewhere."""
    _, tg, _, _, tse = f32
    meta = tse._replace(**{k: v.to("meta") for k, v in tse._asdict().items()})
    with pytest.raises(ValueError, match="unsupported device"):
        tk.resident_linearize(tg.poses.to("meta"), tg.landmarks.to("meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.resident_chi2(tg.poses.to("meta"), tg.landmarks.to("meta"), meta)
    lin = tsoa.soa_linearize(tg.poses, tg.landmarks, tse)
    pf, lf = tfree(tg)
    Hp, idx = torch.eye(48), torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        tk.resident_solve(lin, tse, torch.tensor(1e-3), pf, lf, 8, prior_Hp=Hp)
    with pytest.raises(ValueError, match="shape"):
        tk.resident_solve(lin, tse, torch.tensor(1e-3), pf, lf, 8, 1e-8, Hp[:-6, :-6], idx)
    meta_lin = lin._replace(**{k: v.to("meta") for k, v in lin._asdict().items()})
    with pytest.raises(ValueError, match="unsupported device"):
        tk.resident_solve(meta_lin, meta, torch.tensor(1e-3), pf, lf, 8, 1e-8, Hp, idx)


def test_linearize_wrappers_check_shapes_and_dtypes(f32):
    """K1 + K2 (``fused_linearize``) and K1 alone (``obs_linearize``) refuse
    bad shapes, index dtypes and robust kernels on every device; on the CPU
    they run the plain versions, the pair giving the chain's own outputs
    beside the linearization that folds them in."""
    _, tg, _, _, tse = f32
    with pytest.raises(ValueError, match="shape"):
        tk.fused_linearize(tg.poses, tg.landmarks[:-1], tse)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_linearize(tg.poses[:, :6], tg.landmarks, tse)
    with pytest.raises(TypeError, match="int32"):
        tk.fused_linearize(tg.poses, tg.landmarks, tse._replace(lm_slots=tse.lm_slots.long()))
    with pytest.raises(ValueError, match="unknown robust"):
        tk.fused_linearize(tg.poses, tg.landmarks, tse, "cauchy")
    chain = tsoa.soa_chain_linearize(tg.poses, tse)
    with pytest.raises(ValueError, match="shape"):
        tk.obs_linearize(tg.poses, tg.landmarks, tse, chain._replace(gj=chain.gj[:, :-1]))
    with pytest.raises(TypeError, match="int32"):
        tk.obs_linearize(tg.poses, tg.landmarks, tse._replace(ll_rk=tse.ll_rk.long()), chain)
    lin, ch = tk.fused_linearize(tg.poses, tg.landmarks, tse, "huber")
    want = tsoa.soa_linearize(tg.poses, tg.landmarks, tse, "huber")
    assert all(torch.equal(a, b) for a, b in zip(ch, chain))
    assert all(torch.equal(a, b) for a, b in zip(lin, want))
    assert all(torch.equal(a, b) for a, b in zip(tk.obs_linearize(tg.poses, tg.landmarks, tse, chain, "huber"), want))


H100_SMEM_PER_BLOCK = 232448  # bytes a block may opt in to on an H100 (227 KB)


def test_solve_shape_rule():
    """K4's launch shape: one thread-block cluster at the fixed-lag pcg
    session's graph (K=512, L=128, R=32; a prior's block, PB up to 8, stays in
    device memory and takes no shared memory), the cooperative grid at the
    pcg session's K=4096 and the row-range threshold's K=8192."""
    assert tk.solve_cluster_smem(512, 32, 128) <= H100_SMEM_PER_BLOCK
    assert tk.solve_shape(512, 32, 128, H100_SMEM_PER_BLOCK) == "cluster"
    for K, L in ((4096, 1024), (8192, 2048)):
        assert tk.solve_shape(K, 32, L, H100_SMEM_PER_BLOCK) == "grid"
    # the card-only tests' graphs on both sides of the boundary
    assert tk.solve_shape(1024, 16, 256, H100_SMEM_PER_BLOCK) == "cluster"
    assert tk.solve_shape(2048, 16, 512, H100_SMEM_PER_BLOCK) == "grid"
    assert tk.solve_shape(1000, 5, 250, H100_SMEM_PER_BLOCK) == "cluster"
    assert tk.solve_shape(4999, 5, 1250, H100_SMEM_PER_BLOCK) == "grid"
    # a card with less shared memory takes the grid at the session's graph
    assert tk.solve_shape(512, 32, 128, 100 * 1024) == "grid"


H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def test_lin_split_rule():
    """K1's, K3's, K6's and K10's launch split: a block takes 32 poses and a
    chunk of RB slots in G slot groups; the chunks cover R with none empty; a
    grid of G-warp blocks fits one wave at 16 // G blocks on each of an
    H100's SMs; RB is min(8, R) doubled (capped at R), the smallest whose grid
    (with the pair's ceil(K / 32) chain blocks where K2 or K7 shares the
    launch) fits one wave at G = min(RB, 8), and R where none does; G is
    min(RB, 8), or 4 where 8 spills a wave and 4 fits one."""
    for K, R in ((512, 32), (4096, 32), (1000, 5), (4999, 5), (300, 16), (40, 3), (8192, 32), (1, 1), (16384, 32),
                 (1000, 12), (16384, 4), (6000, 32)):
        for chain in (True, False):
            RB, G = tk.lin_split(K, R, H100_SMS, chain)
            ranges, chunks = -(-K // 32), -(-R // RB)
            assert (chunks - 1) * RB < R <= chunks * RB
            steps = [min(8, R)]
            while steps[-1] < R:
                steps.append(min(2 * steps[-1], R))
            assert RB in steps

            def fits(rb, g):
                return ranges * -(-R // rb) + (ranges if chain else 0) <= 16 // g * H100_SMS

            first = [rb for rb in steps if fits(rb, min(rb, 8))]
            assert RB == (first[0] if first else R), (K, R, chain)
            G8 = min(RB, 8)
            assert G == (4 if G8 == 8 and not fits(RB, 8) and fits(RB, 4) else G8), (K, R, chain)
    # the sessions' graphs, swept (PERF.md): the fixed-lag pcg session's K1 + K2 (16 pose ranges x 4 chunks
    # beside 16 chain blocks) and K3
    assert tk.lin_split(512, 32, H100_SMS) == tk.lin_split(512, 32, H100_SMS, chain=False) == (8, 8)
    # the pcg session's K1 + K2: 128 pose ranges x 1 chunk beside 128 chain blocks; its K3: 2 chunks of 16
    assert tk.lin_split(4096, 32, H100_SMS) == (32, 8)
    assert tk.lin_split(4096, 32, H100_SMS, chain=False) == (16, 8)
    # the tiled session's K6 + K7 on all 8192 rows (256 ranges x 1 chunk beside 256 chain blocks: 512 blocks
    # spill a wave of 2 an SM at 8 groups and fit one of 4 an SM at 4) and on half of them (128 x 1 beside
    # 128: one wave at 8 groups), K6 alone taking the pair's split
    assert tk.lin_split(8192, 32, H100_SMS) == (32, 4)
    assert tk.lin_split(4096, 32, H100_SMS) == (32, 8)
    # its K10 on the same rows, without chain blocks
    assert tk.lin_split(8192, 32, H100_SMS, chain=False) == (32, 8)
    assert tk.lin_split(4096, 32, H100_SMS, chain=False) == (16, 8)
    # past one wave at 4 groups too (1024 blocks at K=16384), G stays 8; the bench's R=4 keeps G = R
    assert tk.lin_split(16384, 32, H100_SMS) == (32, 8)
    assert tk.lin_split(16384, 4, H100_SMS) == (4, 4)
