"""The port's edge-sharded dense LM, the sharded window step and the
tridiagonal preconditioner over ranks, on gloo CPU ranks, against the JAX
package's on the conftest's virtual CPU mesh (f64).

Tolerances: the dense LM (``tests/test_sharded.py``'s chain graph) against
the JAX package's on 2 devices, 1e-8, with its min-edges gate; the window
step (``parallel/window_inputs.py``, 2 ranks, ``tests/test_sharded_window.py``)
1e-6 on poses and landmarks (the JAX step solves with its edge-sharded ELL
PCG, the port with the row-range loop, both to ``cg_tol`` 1e-8), with a
padding row masked; ``--precond tridiag`` at fixed work on 2 ranks against
``pcg.sharded_lm_optimize_pcg(precond_kind="tridiag")``, 1e-6; the merge's
joint BA on 4 ranks against the JAX package's (``tests/test_multisession.py``):
points 1e-8 with the same iterations, planes 1e-6 (the JAX package solves
them with its edge-sharded ELL PCG). The JAX package's results are stored
(``REF``, ``tests/jax_golden.py``). Each mesh's timeout (30 s) bounds every
wait on its ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.parallel import sharded as jsh
from semantic_slam_tpu.runtime import multisession as jms
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu_torch.graph import planes as tgp
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.parallel import sharded as tsh
from semantic_slam_tpu_torch.runtime import multisession as tms
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph
from torch_cases import MeshCache, close_to, one_torch_thread, port_graph  # noqa: F401 (a module fixture)

KW = dict(max_iterations=12, rel_tol=0.0, max_cg_iters=16, cg_tol=0.0)
MESHES = MeshCache(timeout_s=30.0)
mesh = MESHES.get
REF = jax_golden.Recorded("torch_mesh_window", tol=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


def jax_tridiag(g, kw):
    m2 = jsh.make_mesh(2)
    return jax.jit(lambda g: jpcg.sharded_lm_optimize_pcg(g, m2, precond_kind="tridiag", **kw))(g)


def jax_window_step(B, n, valid):
    """The JAX package's sharded window step on ``make_window_inputs``'
    run of ``B`` rows (``valid`` of them), on ``n`` devices."""
    from semantic_slam_tpu.parallel.window_inputs import make_window_inputs as jinputs

    jgraph, jtable, jargs, jstat = jinputs(B, n, jnp.float64)
    return jsh.sharded_window_step(jgraph, jtable, jargs[0], jnp.asarray(valid), *jargs[2:], jsh.make_mesh(n),
                                   **jstat)


def jax_dense_sharded(g):
    """The JAX package's edge-sharded dense LM on 2 devices."""
    return jsh.sharded_lm_optimize(jsh.shard_graph_edges(g, jsh.make_mesh(2)), jsh.make_mesh(2))


def jax_joint_ba(merged, mp, pn):
    """The JAX package's joint BA of merged sessions on 4 devices: points,
    then planes."""
    m4 = jsh.make_mesh(4)
    jg, js = jms.joint_bundle_adjust(merged, mesh=m4)
    return jg, js, *jax.jit(lambda g, p: jms.joint_bundle_adjust_planes(g, p, mesh=m4, max_iterations=20))(mp, pn)


def test_tridiag_matches_jax():
    g, rows = _sort_obs_edges(build_chain_graph(np.random.default_rng(0), noise=0.05)[0])
    tg = port_graph(g)
    kw = dict(KW, ell_rows=rows)
    ja = REF(jax_tridiag, g, kw, tol=1e-6)
    ta = tsd.sharded_lm_optimize_soa(tg, mesh(2), precond_kind="tridiag", ops=tsd.PLAIN_OPS, **kw)
    assert ta[1].iterations == int(ja[1].iterations)
    close_to(ta[0].poses, ja[0].poses, 1e-6, "poses")
    close_to(ta[0].landmarks, ja[0].landmarks, 1e-6, "landmarks")


def test_sharded_window_step_matches_jax():
    """``tests/test_sharded_window.py`` on 2 ranks: the window's frontend
    over the ranks' rows, the association, the sharded solve, against the
    JAX package's step on 2 devices; a padding row creates nothing."""
    from semantic_slam_tpu.parallel.window_inputs import make_window_inputs as jinputs
    from semantic_slam_tpu_torch.parallel.window_inputs import make_window_inputs as tinputs

    B, n = 4, 2
    jstat = jinputs(B, n, jnp.float64)[3]
    solve = {k: jstat[k] for k in ("max_iterations", "min_edges", "rel_tol", "max_cg_iters")}
    tgraph, ttable, targs, tstat = tinputs(B, torch.float64, device="cpu")
    for k in ("cam_intr", "depth_scale"):
        targs.pop(k)
    tstat.pop("depth_input")
    m = mesh(n)
    for valid in ([True] * B, [True, True, True, False]):
        jg, jt, js = REF(jax_window_step, B, n, valid, tol=1e-6)
        odoms = targs.pop("odoms")
        tg, tt, ts = tsh.sharded_window_step(tgraph, ttable, odoms, torch.tensor(valid), **targs, mesh=m, **tstat,
                                             **solve)
        targs["odoms"] = odoms
        assert int(tg.num_poses) == int(jg.num_poses) == sum(valid)
        assert int(tt.count) == int(jt.count) > 0
        assert int(tg.num_lme) == int(jg.num_lme)
        close_to(tg.poses, jg.poses, 1e-6, "poses")
        close_to(tt.world[:int(tt.count)], jt.world[:int(jt.count)], 1e-6, "landmarks")
    with pytest.raises(ValueError, match="divide the mesh"):
        tsh.sharded_window_step(tgraph, ttable, targs["odoms"][:3], torch.ones(3, dtype=torch.bool),
                                **{k: v for k, v in targs.items() if k != "odoms"}, mesh=m, **tstat)


@pytest.mark.parametrize("n", [2, 4])
def test_dense_sharded_matches_jax(n):
    """``tests/test_sharded.py``'s graph: the edge-sharded dense LM on n
    ranks against the JAX package's on 2 devices, and the min-edges gate."""
    g = build_chain_graph(np.random.default_rng(0), noise=0.05)[0]
    jg, js = REF(jax_dense_sharded, g)
    m = mesh(n)
    tg, ts = tsh.sharded_lm_optimize(tsh.shard_graph_edges(port_graph(g), m), m)
    assert ts.iterations == int(js.iterations)
    close_to(tg.poses, jg.poses, 1e-8, "poses")
    close_to(tg.landmarks, jg.landmarks, 1e-8, "landmarks")
    np.testing.assert_allclose(float(ts.chi2_final), float(js.chi2_final), rtol=1e-9)
    empty = tgs.make_graph(8, 8, 8, 8, dtype=torch.float64)
    g0, s0 = tsh.sharded_lm_optimize(tsh.shard_graph_edges(empty, m), m)
    assert s0.iterations == 0 and torch.equal(g0.poses, empty.poses)
    odd = tgs.make_graph(8, 8, 6, 10, dtype=torch.float64)
    if n == 4:
        with pytest.raises(ValueError, match="divide the mesh"):
            tsh.sharded_lm_optimize(odd, m)
    assert tsh.shard_graph_edges(odd, m).lme_k.shape[0] % n == 0


def _merge_inputs():
    """``tests/test_multisession.py``'s two sessions (points) and its two
    plane sessions."""
    from tests.test_multisession import TestMergePlanes, make_session

    rng = np.random.default_rng(0)
    lms = [[1.0, 1.0, 0.5], [3.0, -1.0, 0.2]]
    g1, t1, _ = make_session(rng, 0.0, lms, [0, 1], noise=0.05)
    g2, t2, _ = make_session(rng, 0.3, lms, [0, 1], noise=0.05)
    merged, _ = jms.merge_graphs([g1, g2], [t1, t2], merge_radius=0.8)
    maker = TestMergePlanes()
    s1, s2 = maker._plane_session(rng, 0.0), maker._plane_session(rng, 0.5)
    mp, pn, _ = jms.merge_graphs_planes([s1[0], s2[0]], [s1[1], s2[1]], [s1[2], s2[2]], merge_radius=0.8)
    return merged, mp, pn


def test_joint_bundle_adjust_on_a_mesh_matches_jax():
    """The merge's joint BA on 4 ranks, points (the edge-sharded dense LM)
    and planes (the row-range loop), against the JAX package's on 4
    devices (``tests/test_multisession.py``'s sessions)."""
    merged, mp, pn = _merge_inputs()
    jg, js, jgp_, jpn, jps = REF(jax_joint_ba, merged, mp, pn, tol=1e-6)

    m = mesh(4)
    tg, ts = tms.joint_bundle_adjust(port_graph(merged), mesh=m)
    assert ts.iterations == int(js.iterations) > 0
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses), atol=1e-8)
    tpn = tgp.plane_nodes_from_numpy({k: np.asarray(v) for k, v in pn._asdict().items()})
    tgp_, tpn2, tps = tms.joint_bundle_adjust_planes(port_graph(mp), tpn, mesh=m, max_iterations=20)
    # the JAX package solves with its edge-sharded ELL PCG, the port with
    # the row-range loop (CG to cg_tol 1e-8 in both): the same optimum
    np.testing.assert_allclose(tgp_.poses.numpy(), np.asarray(jgp_.poses), atol=1e-6)
    np.testing.assert_allclose(tpn2.planes.numpy(), np.asarray(jpn.planes), atol=1e-6)
    np.testing.assert_allclose(float(tps.chi2_final), float(jps.chi2_final), rtol=1e-6)
