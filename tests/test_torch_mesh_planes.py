"""The port's several-rank plane solver (``sharded_lm_optimize_soa_planes``)
on gloo CPU ranks against the JAX package's on the conftest's virtual CPU
mesh, and against the port's own single-device plane loop (the point
loop's counterparts are in ``test_torch_mesh.py``).

Inputs: ``tests/test_soa_dist.py``'s plane graph (the chain graph, two
planes seen from every pose), in f64, handed to both packages; a fixed-lag
prior with a plane part from ``fixed_lag.marginalize_planes`` (drop 2) in
the JAX package, carried across. The JAX side runs its distributed loop's
XLA channel math (``use_tiled=False``) on ``make_mesh(4)``, its results
stored (``REF``, ``tests/jax_golden.py``); the port's ranks run their
kernels' plain versions (CPU tensors).

Tolerances, at fixed work (``rel_tol=0``, ``cg_tol=0``):
  * against the JAX sharded loop (marginals, prior, dcs): poses, planes and
    marginals within 1e-8, chi2 rtol 1e-8, the same LM iteration count;
  * 1, 2 and 4 ranks against the port's single-device loop: 1e-10;
  * every rank's result bit-equal, with the same iteration count.
Every test that starts ranks bounds its own wait: the mesh's timeout (30 s)
bounds each collective, each worker's start and each call's report.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.graph import planes as jgp
from semantic_slam_tpu.parallel import sharded as jsh
from semantic_slam_tpu.solver import fixed_lag as jfl
from semantic_slam_tpu.solver import plane_ba as jpba
from semantic_slam_tpu.solver import soa_dist as jsd
from semantic_slam_tpu_torch.graph import planes as tgp
from semantic_slam_tpu_torch.parallel import dist as tdist
from semantic_slam_tpu_torch.solver import fixed_lag as tfl
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph
from torch_cases import MeshCache, close_to, collectives, one_torch_thread, port_graph  # noqa: F401 (a module fixture)

KW = dict(max_iterations=12, rel_tol=0.0, max_cg_iters=8, cg_tol=0.0)
MESHES = MeshCache(timeout_s=30.0)
mesh = MESHES.get
REF = jax_golden.Recorded("torch_mesh_planes", tol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


@pytest.fixture(scope="module")
def planes():
    """``tests/test_soa_dist.py``'s plane graph (two planes seen from every
    pose), and after ``marginalize_planes`` (drop 2) with its prior."""
    rng = np.random.default_rng(0)
    g, gt_poses, _ = build_chain_graph(rng, noise=0.05)
    pn = jgp.make_planes(8, 64, dtype=jnp.float64)
    info3 = jnp.eye(3, dtype=jnp.float64) * 100.0
    pids = []
    for pw in ([1.0, 0.0, 0.0, -6.0], [0.0, 0.0, 1.0, -1.2]):
        pn, pid = jgp.add_plane_node(pn, jnp.asarray(pw, jnp.float64))
        pids.append((pid, pw))
    for k in range(gt_poses.shape[0]):
        for pid, pw in pids:
            z = jpba.observe_plane(gt_poses[k], jnp.asarray(pw, jnp.float64)) + jnp.asarray(
                rng.normal(size=4) * 0.005, jnp.float64)
            pn = jgp.add_se3_plane_edge(pn, k, pid, z, info3)
    g, rows = _sort_obs_edges(g)
    L, Pl = g.landmarks.shape[0], pn.planes.shape[0]
    g2, pn2, prior, _ = REF(jfl.marginalize_planes, g, pn, jfl.empty_prior(L, Pl=Pl, dtype=jnp.float64), drop=2)
    g2, rows2 = _sort_obs_edges(g2)

    def port_pn(p):
        return tgp.plane_nodes_from_numpy({k: np.asarray(v) for k, v in p._asdict().items()})

    tprior = tfl.prior_from_numpy({k: np.asarray(v) for k, v in prior._asdict().items()})
    return {"plain": (g, pn, port_graph(g), port_pn(pn), rows + (4,), None, None),
            "prior": (g2, pn2, port_graph(g2), port_pn(pn2), rows2 + (4,), prior, tprior)}


def jax_sharded_planes(g, pn, prior, kw):
    """The JAX package's sharded plane loop on its 4-device mesh, jitted as
    its engine's tick program jits it (its sharded entries are plain
    functions around ``shard_map``)."""
    m4 = jsh.make_mesh(4)
    return jax.jit(lambda g, pn, p: jsd.sharded_lm_optimize_soa_planes(g, pn, m4, prior=p, use_tiled=False, **kw))(
        g, pn, prior)


def test_sharded_planes_match_jax(planes):
    """The plane loop with the prior, dcs and the marginals."""
    g, pn, tg, tpn, rows, prior, tprior = planes["prior"]
    kw = dict(KW, ell_rows=rows, robust_kind="dcs", robust_delta=1.0, with_marginals=True)
    ja = REF(jax_sharded_planes, g, pn, prior, kw)
    ta = tsd.sharded_lm_optimize_soa_planes(tg, tpn, mesh(4), prior=tprior, ops=tsd.PLAIN_OPS, **kw)
    assert ta[2].iterations == int(ja[2].iterations) > 0
    close_to(ta[0].poses, ja[0].poses, 1e-8, "poses")
    close_to(ta[1].planes, ja[1].planes, 1e-8, "planes")
    np.testing.assert_allclose(float(ta[2].chi2_final), float(ja[2].chi2_final), rtol=1e-8)
    close_to(ta[3], ja[3], 1e-8, "marginals")


@pytest.mark.parametrize("n", [4, 2, 1])
def test_plane_ranks_match_single_device(planes, n):
    """The plane loop with the prior, huber and marginals on n ranks
    against the port's single-device plane loop (only the reductions'
    order differs)."""
    _, _, tg, tpn, rows, _, tprior = planes["prior"]
    kw = dict(KW, ell_rows=rows, with_marginals=True, prior=tprior, ops=tsd.PLAIN_OPS, robust_kind="huber")
    want = tsd.lm_optimize_soa_planes(tg, tpn, **kw)
    got = tsd.sharded_lm_optimize_soa_planes(tg, tpn, mesh(n), **kw)
    assert got[2].iterations == want[2].iterations
    for a, b, what in ((got[0].poses, want[0].poses, "poses"), (got[1].planes, want[1].planes, "planes"),
                       (got[3], want[3], "marginals")):
        close_to(a, b, 1e-10, what)


def test_every_rank_ends_alike(planes):
    """Each rank's result of the plane loop (state replicated): the same
    iteration count and bit-equal poses, landmarks, planes and stats."""
    _, _, tg, tpn, rows, _, tprior = planes["prior"]
    m = mesh(2)
    payload = {**tdist.pack("g", tg), **tdist.pack("pn", tpn), **tdist.pack("prior", tprior)}
    outs = m.run(tsd._sharded_soa_body, payload, gather=True, R=rows[2], R4=rows[3], max_iterations=8, rel_tol=1e-6,
                 max_cg_iters=16, robust_kind="dcs", robust_delta=1.0, init_lambda=0.0, with_marginals=False,
                 cg_tol=1e-8, plain=True, precond_kind="tridiag")
    assert len(outs) == 2
    for o in outs[1:]:
        assert o[3].iterations == outs[0][3].iterations > 0
        for a, b in zip(o[:3] + tuple(o[3][1:]), outs[0][:3] + tuple(outs[0][3][1:])):
            assert torch.equal(a, b)


def test_plane_collectives_per_cg_step_and_linearization(planes):
    """The plane loop's reductions of one LM iteration in order, the JAX
    package's budget (``tests/test_soa_dist.py``): the linearization's
    reduction carries the plane tables too, and each CG step's [3L]-class
    reduction is T and the plane table [3Pl] in one; with tridiag one more
    [6, 6, K] reduction a solve (the chain couplings)."""
    m = mesh(2)
    steps = 4
    kw = dict(max_iterations=1, rel_tol=0.0, cg_tol=0.0, max_cg_iters=steps, ops=tsd.PLAIN_OPS)
    _, _, tg, tpn, rows, _, _ = planes["plain"]
    K, L, Pl = tg.poses.shape[0], tg.landmarks.shape[0], tpn.planes.shape[0]
    ar = "all_reduce"
    got = collectives(m, lambda: tsd.sharded_lm_optimize_soa_planes(tg, tpn, m, ell_rows=rows, **kw))
    T = 3 * L + 3 * Pl
    assert got == ([(ar, 12 * K + 72 * K + 12 * L + 1 + 12 * Pl), (ar, 6 * K)] + [(ar, T), (ar, 12 * K)] * steps
                   + [(ar, T), (ar, 1), ("broadcast", 2)])
    got = collectives(m, lambda: tsd.sharded_lm_optimize_soa_planes(tg, tpn, m, ell_rows=rows,
                                                                    precond_kind="tridiag", **kw))
    assert got[1] == (ar, 36 * K) and got.count(("broadcast", 1)) == 1
