"""Port of the dense Schur LM (solver/lm.py) against the JAX package on one
seeded graph from ``__graft_entry__._build_graph``, handed to both through
the state converters.

Work is fixed (rel_tol=0: the loop runs max_iterations unless damping
explodes), so both sides take the same steps. Tolerances: f64 to 1e-9
relative to each quantity's scale (summation order differs between
index_add_ and XLA's scatter); f32 to 1e-3 on poses and landmarks and 1e-3
relative on chi2 (f32 rounding compounds over the iterations). The JAX
package's results are stored (``REF``, ``tests/jax_golden.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from __graft_entry__ import _build_graph
from semantic_slam_tpu.solver import lm as jlm
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.solver import lm as tlm

K, L, E2 = 16, 8, 48
REF = jax_golden.Recorded("torch_lm", tol=1e-9)


def graphs(dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jg = _build_graph(K, L, E2, jdt, seed=0, noise=0.05)
    tg = tgs.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    assert tg.poses.dtype == dtype
    return jg, tg


def assert_scaled_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def test_converters_round_trip():
    jg, tg = graphs(torch.float64)
    back = tgs.graph_to_numpy(tg)
    for name, leaf in jg._asdict().items():
        np.testing.assert_array_equal(back[name], np.asarray(leaf))
        assert back[name].dtype == np.asarray(leaf).dtype


def test_graph_mutators_match():
    """make_graph, the add_* appends (one past capacity, which both drop) and
    grow_graph leave the same leaves in both packages."""
    from semantic_slam_tpu.graph import state as jgs

    rng = np.random.default_rng(1)
    jg, tg = jgs.make_graph(2, 2, 2, 2, dtype=jnp.float64), tgs.make_graph(2, 2, 2, 2, dtype=torch.float64)
    for _ in range(3):
        pose = np.concatenate([rng.normal(size=3), [1.0, 0, 0, 0]])
        xyz, m3, info = rng.normal(size=3), rng.normal(size=3), np.diag(rng.uniform(1, 2, size=6))
        jg, ji = jgs.add_se3_node(jg, jnp.asarray(pose))
        tg, ti = tgs.add_se3_node(tg, torch.as_tensor(pose))
        jg, _ = jgs.add_point_node(jg, jnp.asarray(xyz))
        tg, _ = tgs.add_point_node(tg, torch.as_tensor(xyz))
        jg = jgs.add_se3_edge(jg, ji - 1, ji, jnp.asarray(pose), jnp.asarray(info))
        tg = tgs.add_se3_edge(tg, ti - 1, ti, torch.as_tensor(pose), torch.as_tensor(info))
        jg = jgs.add_se3_point_edge(jg, ji, 0, jnp.asarray(m3), jnp.asarray(info[:3, :3]))
        tg = tgs.add_se3_point_edge(tg, ti, 0, torch.as_tensor(m3), torch.as_tensor(info[:3, :3]))
    jg, tg = jgs.grow_graph(jg), tgs.grow_graph(tg)
    got = tgs.graph_to_numpy(tg)
    assert got["poses"].shape == (4, 7)
    for name, leaf in jg._asdict().items():
        np.testing.assert_array_equal(got[name], np.asarray(leaf), err_msg=name)


def test_block_inverses_match():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(32, 6, 6))
    M = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6)
    assert_scaled_close(tlm.inv66(torch.as_tensor(M)).numpy(), jlm.inv66(jnp.asarray(M)), 1e-12)
    assert_scaled_close(tlm.inv33(torch.as_tensor(M[:, :3, :3])).numpy(), jlm.inv33(jnp.asarray(M[:, :3, :3])), 1e-12)


@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
def test_linearize_matches(robust):
    jg, tg = graphs(torch.float64)
    want = REF(jlm.linearize_arrays, jg.poses, jg.landmarks, *jlm._edge_args(jg), robust_kind=robust,
               robust_delta=1.0, tol=1e-12)
    got = tlm.linearize_arrays(tg.poses, tg.landmarks, *tlm._edge_args(tg), robust_kind=robust, robust_delta=1.0)
    for name in ("Hpp", "W", "Hll", "gp", "gl", "chi2"):
        assert_scaled_close(getattr(got, name).numpy(), getattr(want, name), 1e-12)


def test_schur_solve_matches():
    jg, tg = graphs(torch.float64)
    jlin = REF(jlm.linearize, jg)
    tlin = tlm.linearize(tg)
    jfree = jlm._free_masks(jg)
    tfree = tlm._free_masks(tg)
    for lam in (1e-4, 10.0):
        jdp, jdl = REF(jlm.schur_solve, jlin, *jfree, jnp.float64(lam))
        tdp, tdl = tlm.schur_solve(tlin, *tfree, torch.tensor(lam, dtype=torch.float64))
        assert_scaled_close(tdp.numpy(), jdp, 1e-9)
        assert_scaled_close(tdl.numpy(), jdl, 1e-9)
    assert_scaled_close(
        tlm.marginals_from_lin(tlin, *tfree).numpy(), REF(jlm.marginals_from_lin, jlin, *jfree), 1e-9
    )


@pytest.mark.parametrize(
    "dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-3)], ids=["f64", "f32"]
)
def test_lm_optimize_fixed_work(dtype, tol):
    jg, tg = graphs(dtype)
    kw = dict(max_iterations=8, min_edges=10, rel_tol=0.0, with_marginals=True)
    jg2, jstats, jmarg = REF(jlm.lm_optimize, jg, tol=tol, **kw)
    tg2, tstats, tmarg = tlm.lm_optimize(tg, **kw)

    assert tstats.iterations == int(jstats.iterations) == 8
    n, m = int(jg.num_poses), int(jg.num_landmarks)
    np.testing.assert_allclose(tg2.poses[:n].numpy(), np.asarray(jg2.poses[:n]), atol=tol, rtol=0)
    np.testing.assert_allclose(tg2.landmarks[:m].numpy(), np.asarray(jg2.landmarks[:m]), atol=tol, rtol=0)
    for name in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(float(getattr(tstats, name)), float(getattr(jstats, name)), rtol=tol)
    assert float(tstats.chi2_final) < float(tstats.chi2_initial)
    assert_scaled_close(tmarg[:m].numpy(), np.asarray(jmarg[:m]), tol)


def test_skip_below_min_edges():
    jg, tg = graphs(torch.float64)
    tg2, stats = tlm.lm_optimize(tg, min_edges=10_000)
    _, jstats = REF(jlm.lm_optimize, jg, min_edges=10_000, tol=1e-12)
    assert stats.iterations == int(jstats.iterations) == 0
    assert torch.equal(tg2.poses, tg.poses)
    np.testing.assert_allclose(float(stats.chi2_final), float(jstats.chi2_final), rtol=1e-12)
