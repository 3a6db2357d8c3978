"""The port's fixed-lag smoothing against the JAX package, on the CPU: the
modules (``solver/fixed_lag.py`` and the prior in the dense LM, the two PCG
loops, K4 and the matrix-free marginals). The engine sessions are in
``test_torch_fixed_lag_engine.py``.

Inputs are seeded numpy arrays handed to both packages: a
``__graft_entry__._build_graph`` graph (K=32 pose capacity, 30 live poses)
marginalized twice by 4 keyframes, its priors carried across as numpy arrays
(``fixed_lag.prior_from_numpy`` / ``prior_to_numpy``). On the CPU the kernel
wrappers run their plain versions, so K4 with a prior is the plain
``soa_schur_step``, held against the TPU kernel in Pallas interpret mode.
The JAX package's results are stored (``REF``, ``tests/jax_golden.py``).

Tolerances:
  * f64 against the JAX package: 1e-8 of each quantity's scale (summation
    order only: ``index_add_`` against ``.at[].add``, the marginalization's
    pose blocks built over the dropped and boundary poses against the dense
    [K,K,6,6] array); the compaction indices and counts exactly;
  * K4 with a prior against the interpret-mode Pallas kernel, f32: 5e-2
    relative norm of dp and db (the repo's kernel-vs-XLA CG bound); with the
    block moved onto free poses, at those poses 1e-3 of the block's own
    effect on the step;
  * ``_pose_local`` in f32 2 km from the origin: 1e-5 against f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_graph, _ell_rows_for
import jax_golden
from semantic_slam_tpu.solver import ellk_soa as jsoa
from semantic_slam_tpu.solver import fixed_lag as jfl
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu.solver.lm import _free_masks as jfree
from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.solver import ellk_soa as tsoa
from semantic_slam_tpu_torch.solver import fixed_lag as tfl
from semantic_slam_tpu_torch.solver import kernels as tk
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from semantic_slam_tpu_torch.solver.lm import _free_masks as tfree
from semantic_slam_tpu_torch.solver.pcg import _edge_args, apply_prior_blocks
from torch_cases import moved_prior, one_torch_thread, row_err  # noqa: F401 (a fixture)

K, L, E2 = 32, 16, 128
ROWS = _ell_rows_for(K, E2)
FIXED = dict(max_iterations=5, rel_tol=0.0, min_edges=0)
# the JAX package's results, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_fixed_lag", tol=1e-8)


def close(got, want, rtol, err_msg=""):
    """|got - want| <= rtol * max|want| (scale-relative)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, atol=rtol * max(float(np.abs(want).max()), 1e-300), rtol=0, err_msg=err_msg)


def to_torch(jg):
    return tgs.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})


def prior_to_torch(jp):
    return tfl.prior_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})


def prior_to_jax(tp):
    return jfl.MarginalPrior(**{k: jnp.asarray(v) for k, v in tfl.prior_to_numpy(tp).items()})


def _perturbed(jg, seed):
    """The graph with every live pose after the first moved by ~3 cm and
    every landmark by ~3 cm (seeded): an LM start that is not converged."""
    rng = np.random.default_rng(seed)
    p, lm = np.asarray(jg.poses).copy(), np.asarray(jg.landmarks).copy()
    n, m = int(jg.num_poses), int(jg.num_landmarks)
    p[1:n, :3] += rng.normal(scale=0.03, size=(n - 1, 3))
    lm[:m] += rng.normal(scale=0.03, size=(m, 3))
    return jg._replace(poses=jnp.asarray(p), landmarks=jnp.asarray(lm))


def _count_i32(jp):
    """The JAX prior with its boundary count as int32. In x64 the JAX
    ``marginalize`` returns ``num_p`` as int64 where ``empty_prior`` and the
    port's priors hold int32; one dtype lets each JAX program of this file
    compile once for every prior it is given (the values are the same)."""
    return jp._replace(num_p=jp.num_p.astype(jnp.int32))


@pytest.fixture(scope="module")
def marg():
    """The graph, once and twice marginalized by 4 keyframes in both
    packages: (graphs, priors, boundary counts) per package."""
    jg = _build_graph(K=K, L=L, E2=E2, dtype=jnp.float64, noise=0.02, seed=7)
    jg1, jp1, jb1 = REF(jfl.marginalize, jg, jfl.empty_prior(L, Pl=0, dtype=jnp.float64), drop=4)
    jp1 = _count_i32(jp1)
    jg2, jp2, jb2 = REF(jfl.marginalize, jg1, jp1, drop=4)
    jp2 = _count_i32(jp2)
    tg = to_torch(jg)
    tg1, tp1, tb1 = tfl.marginalize(tg, tfl.empty_prior(L, dtype=torch.float64), 4)
    tg2, tp2, tb2 = tfl.marginalize(tg1, tp1, 4)
    return dict(jax=((jg, jg1, jg2), (jp1, jp2), (jb1, jb2)), torch=((tg, tg1, tg2), (tp1, tp2), (tb1, tb2)))


@pytest.fixture(scope="module")
def window(marg):
    """The twice-marginalized window at a perturbed state, with its prior,
    in both packages (f64)."""
    jg = _perturbed(marg["jax"][0][2], seed=1)
    return jg, to_torch(jg), marg["jax"][1][1], marg["torch"][1][1]


@pytest.fixture(scope="module", params=["marginalized", "moved"])
def prior_window(request, window):
    """``window`` with the marginalized prior, whose boundary block sits on
    the gauge-fixed pose 0, and with that block moved onto free poses
    (``torch_cases.moved_prior``), where a wrong Hp product shows."""
    jg, tg, jp, tp = window
    if request.param == "moved":
        tp = moved_prior(tp, tg.poses, int(tg.num_poses))
        jp = prior_to_jax(tp)
    return jg, tg, jp, tp


# ---------------------------------------------------------------------------
# marginalization and the prior factor
# ---------------------------------------------------------------------------


def test_marginalize_matches_f64(marg):
    """Two marginalizations that compose: the same compacted graphs (indices
    and counts exactly) and the same priors."""
    (jgs, jps, jbs), (tgs_, tps, tbs) = marg["jax"], marg["torch"]
    for step in (0, 1):
        assert int(tbs[step]) == int(jbs[step]) >= 1
        jg, tg = jgs[step + 1], tgs_[step + 1]
        for f in tgs.FIELDS:  # compacted: moved, not computed
            np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
        for f in tfl.MarginalPrior._fields:
            want, got = np.asarray(getattr(jps[step], f)), getattr(tps[step], f).numpy()
            if f in ("p_idx", "num_p", "p_ref", "l_ref") or want.size == 0:  # (the empty plane part)
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                close(got, want, 1e-8, f"step {step}: {f}")
    assert int(tgs_[2].num_poses) == int(tgs_[0].num_poses) - 8
    assert int(tps[1].num_p) >= 1 and float(tps[1].Hp.abs().sum()) > 0 and float(tps[1].Hl.abs().sum()) > 0


def test_prior_chi2_and_fold_terms_f64(window):
    jg, tg, jp, tp = window
    close(tfl.prior_chi2(tp, tg.poses, tg.landmarks).numpy(), REF(jfl.prior_chi2, jp, jg.poses, jg.landmarks), 1e-8)
    got = tfl.prior_fold_terms(tp, tg.poses, tg.landmarks, torch.float64)
    want = REF(jfl.prior_fold_terms, jp, jg.poses, jg.landmarks, jnp.float64)
    for name, a, b in zip(("gp_add", "gl_add", "chi2"), got, want):
        close(a.numpy(), b, 1e-8, name)
    close(tfl.prior_pose_diag(tp).numpy(), REF(jfl.prior_pose_diag, jp, tol=1e-12), 1e-12)
    assert float(tfl.prior_chi2(tp, tg.poses, tg.landmarks)) >= 0.0


def test_prior_numpy_round_trip(marg):
    jp = marg["jax"][1][1]
    tp = prior_to_torch(jp)
    back = prior_to_jax(tp)
    for f in jfl.MarginalPrior._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(jp, f)), err_msg=f)
    # a plane part crosses too (plane landmarks)
    planar = {k: np.asarray(v) for k, v in jfl.empty_prior(L, Pl=2, dtype=jnp.float64)._asdict().items()}
    planar["Hpl"] = planar["Hpl"] + np.eye(3)
    planar["gpl0"] = planar["gpl0"] + 0.5
    back = tfl.prior_to_numpy(tfl.prior_from_numpy(planar))
    for f in jfl.MarginalPrior._fields:
        np.testing.assert_array_equal(back[f], planar[f], err_msg=f)


def test_grow_prior_pads_landmarks(marg):
    tp = marg["torch"][1][1]
    grown = tfl.grow_prior(tp, 2 * L)
    assert grown.Hl.shape == (2 * L, 3, 3) and grown.l_ref.shape == grown.gl0.shape == (2 * L, 3)
    for f in ("Hl", "l_ref", "gl0"):
        assert torch.equal(getattr(grown, f)[:L], getattr(tp, f)) and not getattr(grown, f)[L:].any()
    assert tfl.grow_prior(tp, L) is tp


def test_pose_local_f32_far_from_origin():
    """At the bench graph's positions (~2 km from the origin) the local
    coordinate must survive f32: the port forms R_ref^T (t_x - t_ref); the
    JAX package's pose_inv(ref) * x cancels two 2 km vectors."""
    rng = np.random.default_rng(0)
    n = 256
    ref = np.concatenate([rng.uniform(-2000.0, 2000.0, size=(n, 3)), rng.normal(size=(n, 4))], 1)
    ref[:, 3:] /= np.linalg.norm(ref[:, 3:], axis=1, keepdims=True)
    x = ref + np.concatenate([0.05 * rng.normal(size=(n, 3)), 0.01 * rng.normal(size=(n, 4))], 1)
    x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=1, keepdims=True)
    ref32, x32 = ref.astype(np.float32), x.astype(np.float32)
    want = tfl._pose_local(torch.tensor(x32, dtype=torch.float64), torch.tensor(ref32, dtype=torch.float64)).numpy()
    got = tfl._pose_local(torch.tensor(x32), torch.tensor(ref32)).numpy()
    assert np.abs(got - want).max() < 1e-5
    # the JAX package's form, pose_inv(ref) * x, in f32: the fault avoided
    cancelling = geo.se3_log(geo.pose_mul(geo.pose_inv(torch.tensor(ref32)), torch.tensor(x32))).numpy()
    assert np.abs(cancelling - want).max() > 1e-5


# ---------------------------------------------------------------------------
# the three LMs with the prior, at fixed work
# ---------------------------------------------------------------------------


def _check_lm(tout, jout, n, m):
    (tg2, ts, tm), (jg2, js, jm) = tout, jout
    assert ts.iterations == int(js.iterations) == FIXED["max_iterations"]
    close(tg2.poses[:n].numpy(), jg2.poses[:n], 1e-8, "poses")
    close(tg2.landmarks[:m].numpy(), jg2.landmarks[:m], 1e-8, "landmarks")
    for name in ("chi2_initial", "chi2_final"):
        close(getattr(ts, name).numpy(), getattr(js, name), 1e-8, name)
    assert float(ts.chi2_final) < float(ts.chi2_initial)
    close(tm.numpy(), jm, 1e-8, "marginals")


def test_lm_optimize_prior_f64(prior_window):
    """The dense Schur LM with the prior folded into every linearization."""
    jg, tg, jp, tp = prior_window
    jout = REF(jfl.lm_optimize_prior, jg, jp, with_marginals=True, **FIXED)
    tout = tfl.lm_optimize_prior(tg, tp, with_marginals=True, **FIXED)
    _check_lm(tout, jout, int(jg.num_poses), int(jg.num_landmarks))
    close(tfl.landmark_marginals_prior(tg, tp).numpy(), REF(jfl.landmark_marginals_prior, jg, jp), 1e-8, "marginals")


def test_lm_optimize_soa_prior_f64(prior_window):
    """Both PCG loops with the prior (the resident loop's K4 takes ``Hp``;
    the row-range loop adds it after K9's reduction), with the prior-aware
    matrix-free marginals: the resident loop against the JAX package's XLA
    path, the row-range loop against the resident one (the JAX package's
    row-range loop compiles for half a minute on the CPU; the sessions of
    ``test_torch_fixed_lag_engine.py`` hold it to the JAX engine)."""
    jg, tg, jp, tp = prior_window
    kw = dict(ell_rows=ROWS, max_cg_iters=32, with_marginals=True, cg_tol=0.0, **FIXED)
    n, m = int(jg.num_poses), int(jg.num_landmarks)
    resident = tsoa.lm_optimize_soa(tg, prior=tp, **kw)
    _check_lm(resident, REF(jsoa.lm_optimize_soa, jg, prior=jp, use_pallas=False, **kw), n, m)
    tiled = tsd.lm_optimize_soa_tiled(tg, prior=tp, **kw)
    _check_lm(tiled, (resident[0], resident[1], resident[2]), n, m)


def test_marginals_graph_with_prior_f64(prior_window):
    """``landmark_marginals_mf_ellk(prior=)`` through the on-demand recovery:
    the Woodbury fold of the boundary coupling."""
    jg, tg, jp, tp = prior_window
    want = REF(jpcg.landmark_marginals_graph, jg, prior=jp, ell_rows=ROWS)
    close(tsoa.landmark_marginals_graph(tg, ROWS, tp).numpy(), want, 1e-8)


def test_plain_k4_prior_matches_pallas_interpret_f32(prior_window):
    """K4's plain version with the prior's boundary block against the TPU
    kernel's prior branch in Pallas interpret mode, f32: the marginalized
    prior, and the same prior moved onto free poses. At the moved block's
    poses the error must also be within 1e-3 of the block's own effect on
    the step there (a product 10% off gives ~3e-2)."""
    jg64, tg64, jp64, tp64 = prior_window
    jg = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, jg64)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, jp64)
    tg, tp = to_torch(jg), prior_to_torch(jp)
    jse = jsoa.build_soa_edges(jpcg._edge_args(jg), K, ROWS[2], L)
    tse = tsoa.build_soa_edges(_edge_args(tg), K, ROWS[2], L)
    lin_j = REF(jpcg.apply_prior_blocks, REF(jsoa.soa_linearize, jg.poses, jg.landmarks, jse, tol=1e-4), jp, jg.poses,
                jg.landmarks, tol=1e-4)
    lin_t = apply_prior_blocks(tsoa.soa_linearize(tg.poses, tg.landmarks, tse), tp, tg.poses, tg.landmarks)
    dp_j, db_j = REF(jsoa.soa_schur_step, lin_j, jse, jnp.float32(1e-3), *jfree(jg), 64, prior=jp, cg_tol=1e-6,
                     use_pallas=True, pallas_interpret=True, tol=1e-4)
    dp_t, db_t = tk.resident_solve(lin_t, tse, torch.tensor(1e-3), *tfree(tg), 64, 1e-6, tp.Hp, tp.p_idx)
    for name, got, want in (("dp", dp_t, dp_j), ("db", db_t, db_j)):
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got.numpy() - want) <= 5e-2 * np.linalg.norm(want), name
    dp_0, _ = tk.resident_solve(lin_t, tse, torch.tensor(1e-3), *tfree(tg), 64, 1e-6)
    n = int(tp.num_p)
    err, effect = row_err(dp_t, torch.tensor(np.array(dp_j)), dp_0, tp.p_idx, n)
    if set(tp.p_idx.tolist()) == {0}:  # marginalized: the block meets only the gauge-fixed pose 0
        assert err == effect == 0.0 and torch.equal(dp_0, dp_t)
    else:  # moved: the block moves the step at its poses by about its size
        assert effect > 0.1 * float(torch.linalg.norm(dp_t[tp.p_idx[:n].long()].double()))
        assert err <= 1e-3 * effect, (err, effect)
