"""The block-tridiagonal PCG preconditioner (``pcg_precond="tridiag"``) on
both of the port's PCG loops, against the JAX package, on the CPU in f64.

  * the resident loop's solve, ``ellk_soa.soa_schur_step_tridiag``, against
    the JAX ``ellk_soa.soa_schur_step(precond_kind="tridiag")`` (its XLA
    branch: neither K4 nor the TPU kernel has this preconditioner), at fixed
    work and with the early exit, and the LM around it against the JAX
    ``lm_optimize_soa(precond_kind="tridiag")``;
  * the row-range loop, ``soa_dist.lm_optimize_soa_tiled`` with the chain
    factored over all rows, against ``pcg.lm_optimize_pcg(precond_kind=
    "tridiag")`` (the JAX engine's route off the TPU) with the marginals,
    and its plane half against ``pcg.lm_optimize_pcg_planes(precond_kind=
    "tridiag")``;
  (the sessions through both CLIs are in ``tests/test_torch_breadth_cli.py``).

Inputs are the seeded chain and plane graphs of ``tests/test_torch_soa.py``
and ``tests/test_torch_planes.py``; the JAX package's results are stored
(``REF``, ``tests/jax_golden.py``). Tolerances: the Schur step and the
resident LM 1e-10 of scale (summation order); the row-range LM 1e-8, its
plane half 1e-6, as the jacobi tests of the same loops.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.solver import ellk_soa as jsoa
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu.solver.lm import _free_masks as jfree
from semantic_slam_tpu_torch.solver import ellk_soa as tsoa
from semantic_slam_tpu_torch.solver import pcg as tpcg
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from semantic_slam_tpu_torch.solver.lm import _free_masks as tfree
from test_torch_planes import _port, _two_party_allreduce, plane_graph  # noqa: F401 (a module fixture)
from test_torch_soa import close, f64  # noqa: F401 (a module fixture)
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

KW = dict(max_iterations=8, rel_tol=0.0, max_cg_iters=16, cg_tol=0.0)
# compiled once, the lambdas traced (an eager call compiles every primitive)
j_schur_step = jax.jit(jsoa.soa_schur_step, static_argnames=("max_cg_iters", "precond_kind", "cg_tol"))
# the JAX package's results, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_tridiag", tol=1e-10)


@pytest.mark.parametrize("cg_tol", [0.0, 1e-6], ids=["fixed-work", "early-exit"])
def test_schur_step_tridiag_matches_xla(f64, cg_tol):
    g, tg, _, jse, tse = f64
    lin_j = REF(jsoa.soa_linearize, g.poses, g.landmarks, jse)
    lin_t = tsoa.soa_linearize(tg.poses, tg.landmarks, tse)
    for lam in (1e-3, 10.0):
        dp_j, db_j = REF(j_schur_step, lin_j, jse, jnp.float64(lam), *jfree(g), max_cg_iters=16,
                         precond_kind="tridiag", cg_tol=cg_tol)
        dp_t, db_t = tsoa.soa_schur_step_tridiag(lin_t, tse, torch.tensor(lam, dtype=torch.float64), *tfree(tg), 16,
                                                 cg_tol)
        close(dp_t.numpy(), dp_j, 1e-10, "dp")
        close(db_t.numpy(), db_j, 1e-10, "db")


def test_tridiag_converges_in_fewer_steps_than_jacobi(f64):
    """On the chain graph the chain preconditioner reaches the early-exit
    tolerance's residual in fewer steps: at 4 steps its step is nearer the
    converged one than block-Jacobi's."""
    _, tg, _, _, tse = f64
    lin = tsoa.soa_linearize(tg.poses, tg.landmarks, tse)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    exact = tsoa.soa_schur_step(lin, tse, lam, *tfree(tg), 200, 0.0)[0]
    err = {name: float(torch.linalg.norm(fn(lin, tse, lam, *tfree(tg), 4, 0.0)[0] - exact))
           for name, fn in (("jacobi", tsoa.soa_schur_step), ("tridiag", tsoa.soa_schur_step_tridiag))}
    assert err["tridiag"] < err["jacobi"], err


def test_lm_resident_tridiag_matches_xla(f64):
    g, tg, rows, _, _ = f64
    jg2, js = REF(jsoa.lm_optimize_soa, g, use_pallas=False, ell_rows=rows, precond_kind="tridiag", **KW)
    tg2, ts = tsoa.lm_optimize_soa(tg, ell_rows=rows, precond_kind="tridiag", **KW)
    assert ts.iterations == int(js.iterations) == KW["max_iterations"]
    close(tg2.poses.numpy(), jg2.poses, 1e-10, "poses")
    close(tg2.landmarks.numpy(), jg2.landmarks, 1e-10, "landmarks")
    close(ts.chi2_final.numpy(), js.chi2_final, 1e-10, "chi2")
    assert float(ts.chi2_final) < float(ts.chi2_initial)


def test_kernel_ops_tridiag_solve():
    """The resident loop's ops: K1 and K3's wrappers, the tridiag solve in
    K4's place (which then never launches)."""
    from semantic_slam_tpu_torch.solver import kernels as tk

    ops = tsoa.kernel_ops("tridiag")
    assert ops.solve is tsoa.soa_schur_step_tridiag
    assert ops.linearize is tk.resident_linearize and ops.chi2 is tk.resident_chi2
    assert tsoa.kernel_ops().solve is tk.resident_solve


def test_row_range_tridiag_matches_pcg(f64):
    """The row-range loop with the chain factored over all rows against the
    JAX per-pose PCG LM with ``precond_kind="tridiag"``, marginals too."""
    g, tg, rows, _, _ = f64
    jg2, js, jm = REF(jpcg.lm_optimize_pcg, g, precond_kind="tridiag", with_marginals=True, **KW)
    tg2, ts, tm = tsd.lm_optimize_soa_tiled(tg, ell_rows=rows, precond_kind="tridiag", with_marginals=True, **KW)
    assert ts.iterations == int(js.iterations) == KW["max_iterations"]
    np.testing.assert_allclose(tg2.poses.numpy(), np.asarray(jg2.poses), atol=1e-8, rtol=0)
    np.testing.assert_allclose(tg2.landmarks.numpy(), np.asarray(jg2.landmarks), atol=1e-8, rtol=0)
    np.testing.assert_allclose(float(ts.chi2_final), float(js.chi2_final), rtol=1e-8)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-12)


def test_row_range_two_ranges_equal_whole(f64):
    """The tridiag preconditioner over rows [0, K/2) and [K/2, K), the
    partials (the chain couplings among them) summed by an allreduce, gives
    the whole range's LM."""
    _, tg, rows, _, _ = f64
    K, L = tg.poses.shape[0], tg.landmarks.shape[0]
    pf, lf = tfree(tg)

    def run(off, Kl, allreduce=tsd._identity):
        de = tsd.build_dist_edges(tpcg._edge_args(tg), K, rows[2], L, off, Kl)
        return tsd.run_lm_loop_soa_dist(tg.poses, tg.landmarks, pf, lf, de, allreduce=allreduce, off=off,
                                        precond_kind="tridiag", **KW)

    whole = run(0, K)
    rank = _two_party_allreduce()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lo, up = pool.map(lambda r: run(r * (K // 2), K // 2, rank(r)), (0, 1))
    assert whole[2].iterations == lo[2].iterations == up[2].iterations == KW["max_iterations"]
    for i, name in enumerate(("poses", "landmarks")):
        close(lo[i].numpy(), whole[i].numpy(), 1e-10, name)
        assert torch.equal(lo[i], up[i]), name


def test_row_range_planes_tridiag_matches_pcg_planes(plane_graph):  # noqa: F811
    jg, jpn, rows = plane_graph
    tg, tpn = _port(jg, jpn)
    ja = REF(jpcg.lm_optimize_pcg_planes, jg, jpn, max_iterations=8, rel_tol=0.0, max_cg_iters=32,
             precond_kind="tridiag", with_marginals=True)
    tb = tsd.lm_optimize_soa_planes(tg, tpn, ell_rows=rows, max_iterations=8, rel_tol=0.0, max_cg_iters=32,
                                    precond_kind="tridiag", with_marginals=True)
    close(tb[0].poses.numpy(), ja[0].poses, 1e-6, "poses")
    close(tb[1].planes.numpy(), ja[1].planes, 1e-6, "planes")
    np.testing.assert_allclose(float(tb[2].chi2_final), float(ja[2].chi2_final), rtol=1e-6)
    np.testing.assert_allclose(tb[3].numpy(), np.asarray(ja[3]), atol=1e-5)
