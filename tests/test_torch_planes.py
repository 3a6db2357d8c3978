"""The port's plane landmarks against the JAX package, module by module, on
the CPU, in f64.

Inputs are seeded numpy data handed to both packages: random poses, planes
and measurements for the geometry (both sides of each branch of the
residual: the hemisphere sign flip and the tangent reference picked by
|n_z| < 0.9), and for the solvers ``tests/test_soa_dist.py``'s plane graph
(``TestDistPlanes.plane_graph``: the chain graph of
``tests/test_solver.build_chain_graph``, 6 poses, with 2 world planes seen
from every pose, k-major), its state carried across by ``graph_from_numpy``
and ``plane_nodes_from_numpy``. The solvers' JAX references are stored
(``REF``, ``tests/jax_golden.py``); the geometry's run live.

Tolerances:
  * geometry: 1e-12 for values, 1e-9 for Jacobians (the port's edge
    Jacobian is the closed form of JAX's forward-mode one);
  * dense planes (linearization, chi2, the joint LM plain, huber, dcs and
    with a prior from ``marginalize_planes``), the prior's plane part and
    the marginalization: 1e-9 of each output's scale, with equal LM
    iterations;
  * the row-range loop's plane half against the JAX loop's XLA branch
    (``use_tiled=False``) at fixed work: 1e-8, with ``with_marginals`` and
    ``prior``; against ``pcg.lm_optimize_pcg_planes``: 1e-6, the JAX tests'
    own bound (``tests/test_soa_dist.py``).
"""

import concurrent.futures
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.frontend import hull as jhull
from semantic_slam_tpu.graph import planes as jgp
from semantic_slam_tpu.graph import residuals as jres
from semantic_slam_tpu.solver import fixed_lag as jfl
from semantic_slam_tpu.solver import pcg as jpcg
from semantic_slam_tpu.solver import plane_ba as jpba
from semantic_slam_tpu.solver import soa_dist as jsd
from semantic_slam_tpu_torch.frontend import hull as thull
from semantic_slam_tpu_torch.graph import planes as tgp
from semantic_slam_tpu_torch.graph import residuals as tres
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.solver import fixed_lag as tfl
from semantic_slam_tpu_torch.solver import lm as tlm
from semantic_slam_tpu_torch.solver import pcg as tpcg
from semantic_slam_tpu_torch.solver import plane_ba as tpba
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from tests.test_pcg import _sort_obs_edges
from tests.test_solver import build_chain_graph
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

ROBUST = ["none", "huber", "dcs"]
KWP = dict(max_iterations=12, rel_tol=0.0, max_cg_iters=32)
# the JAX functions these tests call eagerly, compiled once each (an eager
# call compiles every primitive on its own)
j_linearize_with_planes = jax.jit(jgp.linearize_with_planes, static_argnames=("robust_kind", "robust_delta",
                                                                             "assembly"))
j_ell_linearize_planes = jax.jit(jpcg.ell_linearize_planes, static_argnames=("robust_kind", "robust_delta"))
j_apply_prior_planes = jax.jit(jfl.apply_prior_planes)
# the JAX package's results, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_planes", tol=1e-9)


def close(got, want, rtol, err_msg=""):
    """|got - want| <= rtol * max|want| (scale-relative)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, atol=rtol * max(float(np.abs(want).max()), 1e-300), rtol=0, err_msg=err_msg)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _unit(rng, n, z_big=None):
    v = rng.normal(size=(n, 3))
    if z_big is not None:
        v[:, 2] = np.where(z_big, 8.0 * np.sign(v[:, 2] + 1e-9), 0.1 * v[:, 2])
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _geometry_case(branch: str):
    """Poses, world planes and measurements with each edge on the named side
    of the residual's branches: ``ref z`` / ``ref x`` (the measurement's
    |n_z| below or above 0.9), ``same`` / ``flipped`` (the measurement in
    the prediction's hemisphere or the opposite one)."""
    rng = np.random.default_rng({"ref z": 1, "ref x": 2, "same": 3, "flipped": 4}[branch])
    n = 48
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose = np.concatenate([rng.normal(size=(n, 3)), q], 1)
    plane = np.concatenate([_unit(rng, n), rng.normal(size=(n, 1))], 1)
    obs = np.asarray(jpba.observe_plane(jnp.asarray(pose), jnp.asarray(plane)))
    m = obs[:, :3] + 0.05 * rng.normal(size=(n, 3))
    if branch == "ref z":
        m[:, 2] *= 0.3
    elif branch == "ref x":
        m[:, 2] = np.where(np.abs(m[:, 2]) > 0.3, m[:, 2], 0.4) * 20.0
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    sign = -1.0 if branch == "flipped" else 1.0
    meas = np.concatenate([m, obs[:, 3:] + 0.05 * rng.normal(size=(n, 1))], 1) * sign
    return pose, plane, meas


BRANCHES = ["ref z", "ref x", "same", "flipped"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_plane_residual_and_jacobians(branch):
    pose, plane, meas = _geometry_case(branch)
    n_meas_z = np.abs(meas[:, 2])
    if branch == "ref z":
        assert (n_meas_z < 0.9).all()
    if branch == "ref x":
        assert (n_meas_z >= 0.9).all()
    n_pred = np.einsum("kji,kj->ki", np.stack([np.asarray(jres.geo.quat_to_rotmat(jnp.asarray(p[3:]))) for p in pose]),
                       plane[:, :3])
    dots = np.sum(n_pred * meas[:, :3], axis=1)
    if branch == "same":
        assert (dots > 0).all()
    if branch == "flipped":
        assert (dots < 0).all()
    jr = jres.se3_plane_residual(jnp.asarray(pose), jnp.asarray(plane), jnp.asarray(meas))
    close(tres.se3_plane_residual(t64(pose), t64(plane), t64(meas)).numpy(), jr, 1e-12)
    r, Jk, Jp = tgp.plane_edge_jac(t64(pose), t64(plane), t64(meas))
    jr2, jJk, jJp = jax.vmap(jgp._plane_edge_jac)(jnp.asarray(pose), jnp.asarray(plane), jnp.asarray(meas))
    close(r.numpy(), jr2, 1e-12)
    close(Jk.numpy(), jJk, 1e-9, "J_pose")
    close(Jp.numpy(), jJp, 1e-9, "J_plane")


@pytest.mark.parametrize("branch", ["ref z", "ref x"])
def test_plane_basis_retract_observe(branch):
    rng = np.random.default_rng(5)
    n = _unit(rng, 32, z_big=np.full(32, branch == "ref x"))
    plane = np.concatenate([n, rng.normal(size=(32, 1))], 1)
    delta = 0.1 * rng.normal(size=(32, 3))
    q = rng.normal(size=(32, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pose = np.concatenate([rng.normal(size=(32, 3)), q], 1)
    u, v = thull.plane_basis(t64(n))
    ju, jv = zip(*(jhull.plane_basis(jnp.asarray(x)) for x in n))
    close(u.numpy(), np.stack(ju), 1e-12, "u")
    close(v.numpy(), np.stack(jv), 1e-12, "v")
    close(tpba.plane_retract(t64(plane), t64(delta)).numpy(),
          jax.vmap(jpba.plane_retract)(jnp.asarray(plane), jnp.asarray(delta)), 1e-12)
    close(tpba.observe_plane(t64(pose), t64(plane)).numpy(), jpba.observe_plane(jnp.asarray(pose), jnp.asarray(plane)),
          1e-12)
    # plane_local inverts plane_retract where the normals agree
    moved = tpba.plane_retract(t64(plane), t64(delta))
    close(tfl.plane_local(moved, t64(plane)).numpy(), delta, 1e-9)
    close(tfl.plane_local(moved, t64(plane)).numpy(),
          jax.vmap(jfl.plane_local)(jnp.asarray(moved.numpy()), jnp.asarray(plane)), 1e-12)


# ---------------------------------------------------------------------------
# the plane graph, both packages
# ---------------------------------------------------------------------------


def _port(g, pn):
    return (tgs.graph_from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}),
            tgp.plane_nodes_from_numpy({k: np.asarray(v) for k, v in pn._asdict().items()}))


def _prior_to_port(jp):
    return tfl.prior_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()})


@pytest.fixture(scope="module")
def plane_graph():
    """``tests/test_soa_dist.py``'s plane graph, observations in the
    engine's order, and its ell_rows (R, R4 = 4)."""
    rng = np.random.default_rng(0)
    g, gt_poses, _ = build_chain_graph(rng, noise=0.05)
    planes = [[1.0, 0.0, 0.0, -6.0], [0.0, 0.0, 1.0, -1.2]]
    pn = jgp.make_planes(8, 64, dtype=jnp.float64)
    info3 = jnp.eye(3, dtype=jnp.float64) * 100.0
    pids = []
    for pw in planes:
        pn, pid = jgp.add_plane_node(pn, jnp.asarray(pw, jnp.float64))
        pids.append(pid)
    for k in range(gt_poses.shape[0]):
        for pw, pid in zip(planes, pids):
            z = jpba.observe_plane(gt_poses[k], jnp.asarray(pw, jnp.float64)) + jnp.asarray(
                rng.normal(size=4) * 0.005, jnp.float64)
            pn = jgp.add_se3_plane_edge(pn, k, pid, z, info3)
    g, rows3 = _sort_obs_edges(g)
    return g, pn, rows3 + (4,)


@pytest.fixture(scope="module")
def marg(plane_graph):
    """``marginalize_planes`` (drop 2) in both packages, and the JAX graph
    re-sorted for the ELL layout."""
    g, pn, _ = plane_graph
    L, Pl = g.landmarks.shape[0], pn.planes.shape[0]
    jg2, jpn2, jprior, jnb = REF(jfl.marginalize_planes, g, pn, jfl.empty_prior(L, Pl=Pl, dtype=jnp.float64), drop=2)
    tg, tpn = _port(g, pn)
    tg2, tpn2, tprior, tnb = tfl.marginalize_planes(tg, tpn, tfl.empty_prior(L, Pl=Pl, dtype=torch.float64), 2)
    jg2s, rows3 = _sort_obs_edges(jg2)
    return {"jax": (jg2, jpn2, jprior, jnb), "port": (tg2, tpn2, tprior, tnb), "sorted": (jg2s, rows3 + (4,))}


def test_plane_nodes_numpy_round_trip_and_growth(plane_graph):
    _, pn, _ = plane_graph
    _, tpn = _port(*plane_graph[:2])
    back = tgp.plane_nodes_to_numpy(tpn)
    for f in jgp.PlaneNodes._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(pn, f)), err_msg=f)
    fresh = tgp.make_planes(8, 64, dtype=torch.float64)
    want = jgp.make_planes(8, 64, dtype=jnp.float64)
    for f in jgp.PlaneNodes._fields:
        np.testing.assert_array_equal(tgp.plane_nodes_to_numpy(fresh)[f], np.asarray(getattr(want, f)), err_msg=f)
    p2, idx = tgp.add_plane_node(fresh, t64([0.0, 1.0, 0.0, 2.0]))
    p2 = tgp.add_se3_plane_edge(p2, 3, idx, t64([0.0, 1.0, 0.0, 1.0]), torch.eye(3, dtype=torch.float64))
    assert int(p2.num_planes) == int(p2.num_pe) == 1 and int(p2.pe_k[0]) == 3 and int(p2.pe_p[0]) == 0
    big = tgp.grow_planes(tpn)
    assert big.max_planes == 16 and big.max_edges == 128
    assert torch.equal(big.planes[:8], tpn.planes) and torch.equal(big.pe_info[:64], tpn.pe_info)
    assert torch.equal(big.planes[8:], tgp.make_planes(8, 8, dtype=torch.float64).planes)


@pytest.mark.parametrize("kind", ROBUST)
def test_linearize_and_chi2_with_planes(plane_graph, kind):
    g, pn, _ = plane_graph
    tg, tpn = _port(g, pn)
    jl = REF(j_linearize_with_planes, g, pn, robust_kind=kind, assembly="scatter")
    tl = tgp.linearize_with_planes(tg, tpn, robust_kind=kind)
    for name, a, b in zip(tlm.Linearization._fields, tl, jl):
        close(a.numpy(), b, 1e-9, name)
    close(tgp.chi2_with_planes(tg, tpn, kind).numpy(), REF(jgp.chi2_with_planes, g, pn, kind), 1e-9)
    close(tl.chi2.numpy(), tgp.chi2_with_planes(tg, tpn, kind).numpy(), 1e-12)


@pytest.fixture(scope="module", params=ROBUST + ["prior"])
def dense_lm(request, plane_graph, marg):
    if request.param == "prior":
        jg, jpn, jprior, _ = marg["jax"]
        tg, tpn, tprior, _ = marg["port"]
        kw = {}
        jout = REF(jgp.lm_optimize_with_planes, jg, jpn, prior=jprior)
        tout = tgp.lm_optimize_with_planes(tg, tpn, prior=tprior)
    else:
        g, pn, _ = plane_graph
        tg, tpn = _port(g, pn)
        kw = dict(robust_kind=request.param)
        jout = REF(jgp.lm_optimize_with_planes, g, pn, **kw)
        tout = tgp.lm_optimize_with_planes(tg, tpn, **kw)
    return jout, tout


def test_lm_optimize_with_planes(dense_lm):
    (jg, jpn, js), (tg, tpn, ts) = dense_lm
    assert ts.iterations == int(js.iterations) > 0
    close(tg.poses.numpy(), jg.poses, 1e-9, "poses")
    close(tg.landmarks.numpy(), jg.landmarks, 1e-9, "landmarks")
    close(tpn.planes.numpy(), jpn.planes, 1e-9, "planes")
    for name in ("chi2_initial", "chi2_final", "lambda_final"):
        close(getattr(ts, name).numpy(), getattr(js, name), 1e-9, name)
    assert float(ts.chi2_final) < float(ts.chi2_initial)
    norms = torch.linalg.vector_norm(tpn.planes[: int(tpn.num_planes), :3], dim=-1)
    close(norms.numpy(), np.ones(int(tpn.num_planes)), 1e-12)


def test_lm_with_planes_below_min_edges(plane_graph):
    g, pn, _ = plane_graph
    tg, tpn = _port(g, pn)
    n = int(tg.num_edges() + tpn.num_pe)
    g2, pn2, st = tgp.lm_optimize_with_planes(tg, tpn, min_edges=n + 1)
    assert st.iterations == 0 and g2 is tg and pn2 is tpn
    close(st.chi2_final.numpy(), REF(jgp.chi2_with_planes, g, pn), 1e-12)
    assert tgp.lm_optimize_with_planes(tg, tpn, min_edges=n, max_iterations=1)[2].iterations == 1


def test_empty_planes_match_point_solver(plane_graph):
    g, _, _ = plane_graph
    tg, _ = _port(g, jgp.make_planes(8, 64, dtype=jnp.float64))
    g1, s1 = tlm.lm_optimize(tg)
    g2, _, s2 = tgp.lm_optimize_with_planes(tg, tgp.make_planes(8, 64, dtype=torch.float64))
    assert s1.iterations == s2.iterations
    close(g2.poses.numpy(), g1.poses.numpy(), 1e-10)
    close(s2.chi2_final.numpy(), s1.chi2_final.numpy(), 1e-9)


# ---------------------------------------------------------------------------
# the prior's plane part
# ---------------------------------------------------------------------------


def test_marginalize_planes(marg):
    jg, jpn, jp, jnb = marg["jax"]
    tg, tpn, tp, tnb = marg["port"]
    assert int(tnb) == int(jnb)
    for f in tgs.FIELDS:
        close(getattr(tg, f).numpy(), getattr(jg, f), 1e-9, f)
    for f in tgp.FIELDS:
        close(getattr(tpn, f).numpy(), getattr(jpn, f), 1e-9, f)
    for f in jfl.MarginalPrior._fields:
        close(getattr(tp, f).numpy(), getattr(jp, f), 1e-9, f)
    assert float(torch.abs(tp.Hpl).sum()) > 0 and float(torch.abs(tp.gpl0).sum()) > 0
    # the plane part round-trips to the JAX layout
    back = tfl.prior_to_numpy(tp)
    for f in jfl.MarginalPrior._fields:
        assert back[f].shape == np.asarray(getattr(jp, f)).shape, f


def test_prior_plane_terms(marg, plane_graph):
    jg, jpn, jp, _ = marg["jax"]
    tg, tpn, tp, _ = marg["port"]
    rng = np.random.default_rng(9)
    # away from the reference: planes moved in their tangent spaces
    delta = 0.05 * rng.normal(size=(tpn.planes.shape[0], 3))
    tpl = tpba.plane_retract(tpn.planes, t64(delta))
    jpl = jnp.asarray(tpl.numpy())
    close(tfl.prior_chi2_planes(tp, tg.poses, tg.landmarks, tpl).numpy(),
          REF(jfl.prior_chi2_planes, jp, jg.poses, jg.landmarks, jpl), 1e-9)
    jl = REF(j_apply_prior_planes, REF(j_linearize_with_planes, jg, jpn._replace(planes=jpl), assembly="scatter"),
             jp, jg.poses, jg.landmarks, jpl)
    tl = tfl.apply_prior_planes(tgp.linearize_with_planes(tg, tpn.replace(planes=tpl)), tp, tg.poses, tg.landmarks,
                                tpl)
    for name, a, b in zip(tlm.Linearization._fields, tl, jl):
        close(a.numpy(), b, 1e-9, name)
    # grow_prior pads the plane part with the landmark part
    L = tp.Hl.shape[0]
    grown = tfl.grow_prior(tp, 2 * L)
    assert grown.Hpl.shape == (2 * L, 3, 3) and grown.pl_ref.shape == (2 * L, 4)
    assert torch.equal(grown.Hpl[:L], tp.Hpl) and not grown.Hpl[L:].any() and not grown.gpl0[L:].any()
    assert torch.equal(grown.pl_ref[L:], tgp.make_planes(L, 1, dtype=torch.float64).planes)
    assert tfl.grow_prior(tfl.empty_prior(L, dtype=torch.float64), 2 * L).Hpl.shape == (0, 3, 3)


# ---------------------------------------------------------------------------
# the plane ELL blocks and the row-range loop's plane half
# ---------------------------------------------------------------------------


def test_ell_linearize_planes(plane_graph):
    g, pn, rows = plane_graph
    tg, tpn = _port(g, pn)
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    jargs = (pn.pe_k, pn.pe_p, pn.pe_meas, pn.pe_info, pn.pe_mask())
    jeep = REF(jpcg.build_ell_edges_planes, jpcg._edge_args(g), jargs, K, rows[2], rows[3])
    jeb = REF(j_ell_linearize_planes, g.poses, g.landmarks, pn.planes, jeep, robust_kind="huber")
    teep = tpcg.build_ell_edges_planes(tsd.plane_args(tpn), K, rows[3])
    for name, a in zip(("pl", "pmeas", "pinfo"), teep):
        close(a.numpy(), getattr(jeep, name), 0.0, name)
    from semantic_slam_tpu_torch.solver import ellk_soa as tsoa

    se = tsoa.build_soa_edges(tpcg._edge_args(tg), K, rows[2], L)
    eb = tsoa.soa_to_ell_blocks(tsoa.soa_linearize(tg.poses, tg.landmarks, se, "huber"), se)
    teb = tpcg.ell_linearize_planes(eb, tg.poses, tpn.planes, teep, "huber")
    for name in ("ll", "H_ij", "W_kl", "Hll", "diag"):
        close(getattr(teb, name).numpy(), getattr(jeb, name), 1e-9, name)


def test_lm_optimize_soa_planes_matches_xla(marg):
    """The row-range loop with planes, a prior with a plane part and the
    marginals, against the JAX loop's XLA branch at fixed work (cg_tol 0).
    One JAX program: the plain case is held to the pcg plane LM below."""
    kw = dict(KWP, cg_tol=0.0, with_marginals=True)
    jg, rows = marg["sorted"]
    jpn, jprior = marg["jax"][1], marg["jax"][2]
    tg, tpn = _port(jg, jpn)
    jout = REF(jsd.lm_optimize_soa_planes, jg, jpn, use_tiled=False, ell_rows=rows, prior=jprior, tol=1e-8, **kw)
    tout = tsd.lm_optimize_soa_planes(tg, tpn, ell_rows=rows, prior=_prior_to_port(jprior), **kw)
    (jg, jpn, js), (tg, tpn, ts) = jout[:3], tout[:3]
    assert ts.iterations == int(js.iterations) == KWP["max_iterations"]
    close(tg.poses.numpy(), jg.poses, 1e-8, "poses")
    close(tg.landmarks.numpy(), jg.landmarks, 1e-8, "landmarks")
    close(tpn.planes.numpy(), jpn.planes, 1e-8, "planes")
    close(ts.chi2_final.numpy(), js.chi2_final, 1e-8, "chi2")
    assert float(ts.chi2_final) < float(ts.chi2_initial)
    close(tout[3].numpy(), jout[3], 1e-8, "marginals")


def _two_party_allreduce():
    """A summing allreduce for two ranges run in threads of their own."""
    barrier, slots = threading.Barrier(2, timeout=120), [None, None]

    def for_rank(rank):
        def allreduce(x):
            slots[rank] = x
            barrier.wait()
            a, b = slots
            out = tuple(u + v for u, v in zip(a, b)) if isinstance(x, tuple) else a + b
            barrier.wait()
            return out

        return allreduce

    return for_rank


def test_soa_planes_two_ranges_equal_whole(marg):
    """The plane half over rows [0, K/2) and [K/2, K) (``build_plane_dist``
    and ``build_dist_edges`` with ``off``/``Kl``), the partials summed by an
    allreduce, gives the whole range's LM with a prior that has a plane part."""
    jg, rows = marg["sorted"]
    tg, tpn = _port(jg, marg["jax"][1])
    tprior = _prior_to_port(marg["jax"][2])
    K, L = tg.poses.shape[0], tg.landmarks.shape[0]
    pf, lf = tlm._free_masks(tg)
    kw = dict(max_iterations=4, rel_tol=0.0, max_cg_iters=32, cg_tol=0.0, prior=tprior, planes=tpn.planes,
              plane_free=tpn.plane_mask())

    def run(off, Kl, allreduce=tsd._identity):
        de = tsd.build_dist_edges(tpcg._edge_args(tg), K, rows[2], L, off, Kl)
        pe = tsd.build_plane_dist(tsd.plane_args(tpn), K, rows[3], off, Kl)
        return tsd.run_lm_loop_soa_dist(tg.poses, tg.landmarks, pf, lf, de, pe=pe, allreduce=allreduce, off=off,
                                        **kw)

    whole = run(0, K)
    rank = _two_party_allreduce()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lo, up = pool.map(lambda r: run(r * (K // 2), K // 2, rank(r)), (0, 1))
    assert whole[3].iterations == lo[3].iterations == up[3].iterations == 4
    for i, name in enumerate(("poses", "landmarks", "planes")):
        close(lo[i].numpy(), whole[i].numpy(), 1e-10, name)
        assert torch.equal(lo[i], up[i]), name
    assert float(whole[3].chi2_final) < float(whole[3].chi2_initial)


@pytest.mark.parametrize("case", ["marginals", "prior"])
def test_lm_optimize_soa_planes_matches_pcg_planes(case, plane_graph, marg):
    """Against the JAX package's per-pose PCG plane LM (the route its engine
    takes off the TPU), within the JAX tests' own 1e-6."""
    if case == "prior":
        jg, rows = marg["sorted"]
        jpn, jprior = marg["jax"][1], marg["jax"][2]
    else:
        (jg, jpn, rows), jprior = plane_graph, None
    tg, tpn = _port(jg, jpn)
    tprior = None if jprior is None else _prior_to_port(jprior)
    wm = case == "marginals"
    ja = REF(jpcg.lm_optimize_pcg_planes, jg, jpn, max_iterations=12, rel_tol=0.0, max_cg_iters=32, prior=jprior,
             with_marginals=wm, tol=1e-6)
    tb = tsd.lm_optimize_soa_planes(tg, tpn, ell_rows=rows, prior=tprior, with_marginals=wm, **KWP)
    close(tb[0].poses.numpy(), ja[0].poses, 1e-6, "poses")
    close(tb[1].planes.numpy(), ja[1].planes, 1e-6, "planes")
    np.testing.assert_allclose(float(tb[2].chi2_final), float(ja[2].chi2_final), rtol=1e-6)
    if wm:
        np.testing.assert_allclose(tb[3].numpy(), np.asarray(ja[3]), atol=1e-5)


def test_soa_planes_without_plane_edges_match_point_loop(plane_graph):
    g, _, rows = plane_graph
    tg, _ = _port(g, jgp.make_planes(8, 64, dtype=jnp.float64))
    empty = tgp.make_planes(8, 64, dtype=torch.float64)
    ga, sa = tsd.lm_optimize_soa_tiled(tg, ell_rows=rows[:3], cg_tol=0.0, **KWP)
    gb, pb, sb = tsd.lm_optimize_soa_planes(tg, empty, ell_rows=rows, cg_tol=0.0, **KWP)
    assert sa.iterations == sb.iterations
    close(gb.poses.numpy(), ga.poses.numpy(), 1e-10)
    assert torch.equal(pb.planes, empty.planes)


def test_soa_planes_below_min_edges(plane_graph):
    """Below the gate the state comes back unchanged, its chi2 from the
    loop's own trial objective (K10's step, called once) and the plane slots."""
    g, pn, rows = plane_graph
    tg, tpn = _port(g, pn)
    n = int(tg.num_edges() + tpn.num_pe)
    calls = []

    def chi2(*a):
        calls.append(1)
        return tsd.PLAIN_OPS.chi2(*a)

    ops = tsd.PLAIN_OPS._replace(chi2=chi2)
    g2, pn2, st, m = tsd.lm_optimize_soa_planes(tg, tpn, ell_rows=rows, min_edges=n + 1, with_marginals=True,
                                                ops=ops)
    assert st.iterations == 0 and m is None and g2 is tg and pn2 is tpn and len(calls) == 1
    close(st.chi2_initial.numpy(), jgp.chi2_with_planes(g, pn), 1e-12)


def test_row_range_plane_half_args():
    g = tgs.make_graph(8, 4, 8, 8, dtype=torch.float64)
    de = tsd.build_dist_edges(tpcg._edge_args(g), 8, 2, 4)
    pf, lf = tlm._free_masks(g)
    with pytest.raises(ValueError, match="come together"):
        tsd.run_lm_loop_soa_dist(g.poses, g.landmarks, pf, lf, de, 1, 0.0, planes=g.landmarks)
    with pytest.raises(ValueError, match="not inside"):
        tsd.build_plane_dist(tsd.plane_args(tgp.make_planes(4, 8, dtype=torch.float64)), 8, 2, off=4, Kl=8)
