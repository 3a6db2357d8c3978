"""The port's several-rank point solver on gloo CPU ranks against the JAX
package's sharded one on the conftest's virtual CPU mesh, and against the
port's own single-device loop; the mesh's failure handling and refusals.
The plane loop's counterparts are in ``test_torch_mesh_planes.py``: each file
compiles one JAX sharded loop (~40 s on an 8-core CPU), so that neither
runs long alone.

Inputs: ``tests/test_soa_dist.py``'s chain graph (``build_chain_graph``,
observations in the engine's order), in f64, handed to both packages; a
fixed-lag prior from ``fixed_lag.marginalize`` (drop 2) in the JAX package,
carried across. The JAX side runs its distributed loop's XLA channel math
(``use_tiled=False``) on ``make_mesh(4)``, its results stored (``REF``,
``tests/jax_golden.py``); the port's ranks run their kernels' plain
versions (CPU tensors).

Tolerances, at fixed work (``rel_tol=0``, ``cg_tol=0``):
  * against the JAX sharded loop (marginals, prior, huber): poses,
    landmarks and marginals within 1e-8, chi2 rtol 1e-8, the same LM
    iteration count;
  * 1, 2 and 4 ranks against the port's single-device loop: 1e-10.
Every test that starts ranks bounds its own wait: the mesh's timeout (30 s)
bounds each collective, each worker's start and each call's report.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.parallel import sharded as jsh
from semantic_slam_tpu.solver import fixed_lag as jfl
from semantic_slam_tpu.solver import soa_dist as jsd
from semantic_slam_tpu_torch.graph.synthetic import build_graph, ell_rows_for
from semantic_slam_tpu_torch.parallel import dist as tdist
from semantic_slam_tpu_torch.solver import fixed_lag as tfl
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph
from torch_cases import MeshCache, close_to, collectives, one_torch_thread, port_graph  # noqa: F401 (a module fixture)

KW = dict(max_iterations=12, rel_tol=0.0, max_cg_iters=8, cg_tol=0.0)
MESHES = MeshCache(timeout_s=30.0)
mesh = MESHES.get
REF = jax_golden.Recorded("torch_mesh", tol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


@pytest.fixture(scope="module")
def points():
    """The chain graph, and after a 2-pose marginalization with its prior."""
    g, rows = _sort_obs_edges(build_chain_graph(np.random.default_rng(0), noise=0.05)[0])
    L = g.landmarks.shape[0]
    g2, prior, _ = REF(jfl.marginalize, g, jfl.empty_prior(L, dtype=g.poses.dtype), drop=2)
    g2, rows2 = _sort_obs_edges(g2)
    tprior = tfl.prior_from_numpy({k: np.asarray(v) for k, v in prior._asdict().items()})
    return {"plain": (g, port_graph(g), rows, None, None), "prior": (g2, port_graph(g2), rows2, prior, tprior)}


def jax_sharded_points(g, prior, kw):
    """The JAX package's sharded point loop on its 4-device mesh, jitted as
    its engine's tick program jits it (its sharded entries are plain
    functions around ``shard_map``)."""
    m4 = jsh.make_mesh(4)
    return jax.jit(lambda g, p: jsd.sharded_lm_optimize_soa(g, m4, prior=p, use_tiled=False, **kw))(g, prior)


def test_sharded_points_match_jax(points):
    """The point loop with the prior, huber and the marginals."""
    g, tg, rows, prior, tprior = points["prior"]
    kw = dict(KW, ell_rows=rows, robust_kind="huber", robust_delta=1.0, with_marginals=True)
    ja = REF(jax_sharded_points, g, prior, kw)
    ta = tsd.sharded_lm_optimize_soa(tg, mesh(4), prior=tprior, ops=tsd.PLAIN_OPS, **kw)
    assert ta[1].iterations == int(ja[1].iterations) > 0
    close_to(ta[0].poses, ja[0].poses, 1e-8, "poses")
    close_to(ta[0].landmarks, ja[0].landmarks, 1e-8, "landmarks")
    np.testing.assert_allclose(float(ta[1].chi2_final), float(ja[1].chi2_final), rtol=1e-8)
    close_to(ta[2], ja[2], 1e-8, "marginals")


def test_rows_must_divide_the_mesh():
    g = build_graph(18, 8, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="K % n"):
        tsd.sharded_lm_optimize_soa(g, mesh(4), ell_rows=ell_rows_for(18, 64), **KW)


@pytest.mark.parametrize("n", [4, 2, 1])
def test_ranks_match_single_device(points, n):
    """The point loop with the prior, huber and marginals on n ranks
    against the port's single-device loop (only the reductions' order
    differs)."""
    _, tg, rows, _, tprior = points["prior"]
    kw = dict(KW, ell_rows=rows, with_marginals=True, prior=tprior, ops=tsd.PLAIN_OPS, robust_kind="huber")
    want = tsd.lm_optimize_soa_tiled(tg, **kw)
    got = tsd.sharded_lm_optimize_soa(tg, mesh(n), **kw)
    assert got[1].iterations == want[1].iterations
    for a, b, what in ((got[0].poses, want[0].poses, "poses"), (got[0].landmarks, want[0].landmarks, "landmarks"),
                       (got[2], want[2], "marginals")):
        close_to(a, b, 1e-10, what)


def test_collectives_per_cg_step_and_linearization(points):
    """The reductions of one LM iteration in order, the JAX package's
    budget (``tests/test_soa_dist.py``): one linearization (the gradient
    and diagonal with their j-sides, the landmark table, chi2), the
    right-hand side [6K], per CG step one [3L]-class (T) and one
    [12K]-class (u and vj), the back-substitution's table, the trial chi2;
    then the LM's 2-flag broadcast."""
    m = mesh(2)
    steps = 4
    kw = dict(max_iterations=1, rel_tol=0.0, cg_tol=0.0, max_cg_iters=steps, ops=tsd.PLAIN_OPS)
    _, tg, rows, _, _ = points["plain"]
    K, L = tg.poses.shape[0], tg.landmarks.shape[0]
    got = collectives(m, lambda: tsd.sharded_lm_optimize_soa(tg, m, ell_rows=rows, **kw))
    ar = "all_reduce"
    assert got == ([(ar, 12 * K + 72 * K + 12 * L + 1), (ar, 6 * K)] + [(ar, 3 * L), (ar, 12 * K)] * steps
                   + [(ar, 3 * L), (ar, 1), ("broadcast", 2)])


def test_killed_worker_raises_within_its_limit(points):
    """A worker killed before a call, and one killed during the solves:
    rank 0 raises a RuntimeError naming the rank, well within 60 s, and
    the mesh is closed."""
    MESHES.close()
    _, tg, rows, _, _ = points["plain"]
    kw = dict(ell_rows=rows, ops=tsd.PLAIN_OPS, max_iterations=50, rel_tol=0.0, max_cg_iters=64, cg_tol=0.0)
    m = tdist.make_mesh(2, device="cpu", timeout_s=20.0)
    m._procs[1].kill()
    m._procs[1].wait()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        tsd.sharded_lm_optimize_soa(tg, m, **kw)
    assert m.closed and time.monotonic() - t0 < 60

    m = tdist.make_mesh(2, device="cpu", timeout_s=20.0)
    killer = threading.Timer(1.0, m._procs[1].kill)
    killer.start()
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="rank 1"):
            while time.monotonic() - t0 < 60:
                tsd.sharded_lm_optimize_soa(tg, m, **kw)
    finally:
        killer.cancel()
        m.close()
    assert time.monotonic() - t0 < 60
    with pytest.raises(RuntimeError, match="closed"):
        m.run(tdist._op_forbidden_modules, {})


def test_mesh_devices_refuses_what_is_not_there():
    with pytest.raises(ValueError, match=r"num_devices=64 ranks needs 64 GPUs"):
        tdist.mesh_devices(64, "cuda")
    with pytest.raises(ValueError, match="cores"):
        tdist.mesh_devices(100000, "cpu")
    with pytest.raises(ValueError, match="NCCL takes one GPU per rank"):
        tdist.mesh_devices(2, backend="nccl", devices=["cuda:0", "cuda:0"])
    assert tdist.mesh_devices(2, backend="gloo", devices=["cuda:0", "cuda:0"])[1] == "gloo"

