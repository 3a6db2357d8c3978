"""The port on the card: the CUDA kernels against their plain versions (K5,
the RANSAC scoring kernel; K1-K4, the resident SoA Schur-PCG solver's
kernels, K1 + K2 in their one call and K1 alone also at the sessions' and
ragged graphs, K1 and K3 with empty parts, K4 also with a fixed-lag prior and
in both of its launch shapes; K6-K10, the row-range solver's, K6 + K7 in
their one call and K10 also at the tiled session's and ragged graphs on each
row range, K6 alone also at the tiled session's graph; K1 + K2, K1, K3, K4,
K6, K6 + K7, K9 and K10 also bit for bit on a repeat),
and small sessions on the card (dense, ``--solver pcg`` and ``--solver pcg``
on the row-range loop; dense and pcg with fixed-lag smoothing; plane
landmarks dense, and pcg with fixed-lag smoothing on the row-range loop's
plane half; a ``.bag`` session) against the same sessions on the CPU, and
``segment_keyframe`` and the voxel map on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker
and skips without a GPU. The file imports no JAX, because the machine with
the card has none. Run it there with ``--noconftest``, since the test
package's conftest configures JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from semantic_slam_tpu_torch.frontend import kernels as tk

DIST, COS = 0.5, 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def inputs(seed, D, N, S, device):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(D, N, 3))
    hn = rng.normal(size=(D, S, 3))
    arrays = (
        rng.normal(size=(D, N, 3)),
        nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
        rng.random((D, N)) > 0.3,
        hn / np.linalg.norm(hn, axis=-1, keepdims=True),
        rng.normal(size=(D, S)),
    )
    return [torch.as_tensor(a, device=device).to(torch.float32 if a.dtype != bool else torch.bool) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65536, 4133, 1], ids=["path-shape", "ragged", "single-point"])
def test_kernel_matches_plain(cuda, N):
    t = inputs(3, 8, N, 128, cuda)
    before = tk.score_hypotheses.launches
    got = tk.score_hypotheses(*t, DIST, COS)
    ref = tk.score_hypotheses_ref(*t, DIST, COS)
    torch.cuda.synchronize()
    assert tk.score_hypotheses.launches == before + 1
    # with these seeded inputs no pair lies within f32 rounding of a
    # threshold, so the FMA kernel and the cuBLAS plain version agree exactly
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_no_candidates(cuda):
    t = inputs(4, 8, 65536, 128, cuda)
    t[2] = torch.zeros_like(t[2])
    assert float(tk.score_hypotheses(*t, DIST, COS).abs().max()) == 0.0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    t = inputs(5, 2, 256, 16, cuda)
    with pytest.raises(TypeError, match="bool"):
        tk.score_hypotheses(t[0], t[1], t[2].float(), t[3], t[4], DIST, COS)
    with pytest.raises(ValueError, match="shape"):
        tk.score_hypotheses(t[0], t[1], t[2], t[3][:, :8], t[4], DIST, COS)
    with pytest.raises(ValueError, match="is on"):
        tk.score_hypotheses(t[0], t[1], t[2].cpu(), t[3], t[4], DIST, COS)


# ---------------------------------------------------------------------------
# K1-K4: the SoA Schur-PCG kernels
# ---------------------------------------------------------------------------


def soa_case(device, K=300, L=64, E2=2400, R=None):
    """A seeded ``graph/synthetic.py`` graph in f32 with its poses moved by
    ~5 cm / ~0.02 rad (numpy-seeded), so that no output is rounding noise."""
    from semantic_slam_tpu_torch.graph import synthetic as syn
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g = syn.build_graph(K, L, E2, torch.float32, seed=2, noise=0.05, device=device)
    rng = np.random.default_rng(7)
    dp = torch.as_tensor(np.concatenate([rng.normal(size=(K, 3)) * 0.05, rng.normal(size=(K, 4)) * 0.01], 1),
                         dtype=torch.float32, device=device)
    poses = g.poses + dp
    poses = torch.cat([poses[:, :3], torch.nn.functional.normalize(poses[:, 3:], dim=-1)], 1)
    g = g.replace(poses=poses)
    se = soa.build_soa_edges(_edge_args(g), K, R or syn.ell_rows_for(K, E2)[2], L)
    return g, se, _free_masks(g)


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("R", [None, 16], ids=["R-own", "R-16"])
def test_soa_linearize_and_chi2_match_plain(cuda, robust, R):
    """K1 + K2 (one call), K1 alone and K3 against their plain versions on
    the card: each output within 1e-4 of its own scale (f32, summation order
    only)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se, _ = soa_case(cuda, R=R)
    counts = (sk.fused_linearize.launches, sk.obs_linearize.launches, sk.resident_chi2.launches)
    (lk, ck), cp = sk.fused_linearize(g.poses, g.landmarks, se, robust, 1.0), soa.soa_chain_linearize(g.poses, se)
    for name, a, b in zip(cp._fields, ck, cp):
        assert rel_err(a, b) <= 1e-4, name
    lp = soa.soa_obs_linearize(g.poses, g.landmarks, se, cp, robust, 1.0)
    la = sk.obs_linearize(g.poses, g.landmarks, se, cp, robust, 1.0)
    for name in ("v", "Ow", "Rt", "gp", "diag", "gl", "Hll", "chi2"):
        assert rel_err(getattr(lk, name), getattr(lp, name)) <= 1e-4, name
        assert rel_err(getattr(la, name), getattr(lp, name)) <= 1e-4, name
    xk = sk.resident_chi2(g.poses, g.landmarks, se, robust, 1.0)
    assert rel_err(xk, soa.soa_chi2(g.poses, g.landmarks, se, robust, 1.0)) <= 1e-4
    assert rel_err(xk, lk.chi2) <= 1e-4
    torch.cuda.synchronize()
    assert (sk.fused_linearize.launches, sk.obs_linearize.launches, sk.resident_chi2.launches) == tuple(
        c + 1 for c in counts)


# K1 + K2, K1 alone and K3 (their pose's slots spread over the grid by
# ``lin_split``) at the fixed-lag pcg and pcg sessions' graphs, the bench graph
# and ragged ones: id -> (K, L, E2, R)
LIN_CASES = {
    "fixed-lag-K512-R32": (512, 128, 2048, 32),
    "pcg-K4096-R32": (4096, 1024, 16384, 32),
    "bench-K4096-R4": (4096, 1024, 16384, 4),
    "ragged-K1000-R5": (1000, 250, 8 + 998 * 5, 5),
    "ragged-K4999-R5": (4999, 1250, 8 + 4997 * 5, 5),
}
LIN_OUTPUTS = ("v", "Ow", "Rt", "gp", "diag", "gl", "Hll", "chi2")


def lin_case(device, case, variant="graph"):
    """The case's graph; ``idle-landmarks`` adds 7 landmarks that no slot
    observes, ``no-slots`` leaves every slot empty."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    K, L, E2, R = LIN_CASES[case]
    g, se, _ = soa_case(device, K=K, L=L, E2=E2, R=R)
    if variant == "idle-landmarks":
        extra = torch.as_tensor(np.random.default_rng(3).normal(size=(7, 3)), dtype=torch.float32, device=device)
        g = g.replace(landmarks=torch.cat([g.landmarks, extra]))
        se = soa.build_soa_edges(_edge_args(g), K, R, L + 7)
    elif variant == "no-slots":
        args = list(_edge_args(g))
        args[9] = torch.zeros_like(args[9])  # the landmark-edge mask
        se = soa.build_soa_edges(tuple(args), K, R, L)
    return g, se


def check_lin_chi2(g, se, robust):
    """K1 on the plain chain blocks and K3 against their plain versions: each
    output within 1e-4 of its own scale (f32, summation order only); returns
    the kernels' outputs."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    cp = soa.soa_chain_linearize(g.poses, se)
    counts = (sk.obs_linearize.launches, sk.resident_chi2.launches)
    lk = sk.obs_linearize(g.poses, g.landmarks, se, cp, robust, 1.0)
    lp = soa.soa_obs_linearize(g.poses, g.landmarks, se, cp, robust, 1.0)
    xk = sk.resident_chi2(g.poses, g.landmarks, se, robust, 1.0)
    xp = soa.soa_chi2(g.poses, g.landmarks, se, robust, 1.0)
    torch.cuda.synchronize()
    assert (sk.obs_linearize.launches, sk.resident_chi2.launches) == tuple(c + 1 for c in counts)
    for name in LIN_OUTPUTS:
        got, want = getattr(lk, name), getattr(lp, name)
        assert bool(torch.isfinite(got).all()), name
        assert rel_err(got, want) <= 1e-4, name
    assert rel_err(xk, xp) <= 1e-4
    return lk, xk


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_lin_chi2_match_plain(cuda, case, robust):
    """K1 and K3 against their plain versions at the sessions' graphs and at
    ragged K and R, under each robust kernel."""
    check_lin_chi2(*lin_case(cuda, case), robust)


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_fused_linearize_matches_plain(cuda, case, robust):
    """K1 + K2 in their one call (the chain as blocks of K1's first launch)
    against the plain versions: the chain's own blocks, gradients and chi2,
    and the linearization that folds them in, each within 1e-4 of its scale;
    one call counted."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se = lin_case(cuda, case)
    before = sk.fused_linearize.launches
    lk, ck = sk.fused_linearize(g.poses, g.landmarks, se, robust, 1.0)
    cp = soa.soa_chain_linearize(g.poses, se)
    lp = soa.soa_obs_linearize(g.poses, g.landmarks, se, cp, robust, 1.0)
    torch.cuda.synchronize()
    assert sk.fused_linearize.launches == before + 1
    for name, got, want in zip(cp._fields, ck, cp):
        assert bool(torch.isfinite(got).all()) and rel_err(got, want) <= 1e-4, name
    for name in LIN_OUTPUTS + ("Hii", "Hij", "Hjj"):
        got, want = getattr(lk, name), getattr(lp, name)
        assert bool(torch.isfinite(got).all()) and rel_err(got, want) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("variant", ["idle-landmarks", "no-slots"])
def test_lin_chi2_empty_parts_match_plain(cuda, variant, robust):
    """K1 and K3 with landmarks that no slot observes, and with every slot
    empty: those landmarks' gl and Hll, and everything empty slots add, are
    exactly 0."""
    g, se = lin_case(cuda, "ragged-K1000-R5", variant)
    lk, xk = check_lin_chi2(g, se, robust)
    idle = slice(LIN_CASES["ragged-K1000-R5"][1], None) if variant == "idle-landmarks" else slice(None)
    assert float(lk.gl[idle].abs().max()) == 0.0 and float(lk.Hll[idle].abs().max()) == 0.0
    if variant == "no-slots":
        from semantic_slam_tpu_torch.solver import ellk_soa as soa

        assert float(lk.Ow.abs().max()) == 0.0
        assert rel_err(xk, soa.soa_chain_linearize(g.poses, se).chi2) <= 1e-4  # the chain's alone


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixed-lag-K512-R32", "ragged-K4999-R5"])
def test_lin_chi2_repeat_bit_for_bit(cuda, case):
    """K1 + K2, K1 alone and K3 give the same bits on two launches (fixed
    summation orders, no float atomics)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se = lin_case(cuda, case)
    cp = soa.soa_chain_linearize(g.poses, se)
    a = sk.obs_linearize(g.poses, g.landmarks, se, cp, "huber", 1.0)
    b = sk.obs_linearize(g.poses, g.landmarks, se, cp, "huber", 1.0)
    for name in LIN_OUTPUTS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    (la, ca), (lb, cb) = (sk.fused_linearize(g.poses, g.landmarks, se, "huber", 1.0) for _ in range(2))
    for name, x, y in zip(la._fields + ca._fields, la + ca, lb + cb):
        assert torch.equal(x, y), name
    xs = [sk.resident_chi2(g.poses, g.landmarks, se, "huber", 1.0) for _ in range(3)]
    assert torch.equal(xs[0], xs[1]) and torch.equal(xs[1], xs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("cg_tol", [1e-8, 0.0], ids=["early-exit", "fixed-work"])
@pytest.mark.parametrize("lam", [1e-2, 1e2])
def test_soa_solve_matches_plain(cuda, cg_tol, lam):
    """K4 against its plain version on the card: dp and db within a relative
    norm error of 5e-2 (the repo's kernel-vs-XLA CG bound), and exactly 0
    on the fixed pose and the inactive landmarks."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se, (pf, lf) = soa_case(cuda)
    lin = soa.soa_linearize(g.poses, g.landmarks, se)
    lam_t = torch.tensor(lam, device=cuda)
    before = sk.resident_solve.launches
    dk, bk = sk.resident_solve(lin, se, lam_t, pf, lf, 128, cg_tol)
    dp, bp = soa.soa_schur_step(lin, se, lam_t, pf, lf, 128, cg_tol)
    torch.cuda.synchronize()
    assert sk.resident_solve.launches == before + 1
    for got, want in ((dk, dp), (bk, bp)):
        assert bool(torch.isfinite(got).all())
        assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 5e-2
    assert float(dk[~pf].abs().max()) == 0.0 and float(bk[~lf].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["marginalized", "moved"])
def test_soa_solve_with_prior_matches_plain(cuda, which):
    """K4 with a fixed-lag prior against its plain version on the card (5e-2
    relative norm): the prior of ``fixed_lag.marginalize`` (drop 16), whose
    boundary block sits on the gauge-fixed pose 0, and the same prior with a
    dense block moved onto three free poses (``torch_cases.moved_prior``),
    which the kernel's prior branch must apply: at those poses the error
    must also be within 1e-3 of the block's own effect on the step. One
    launch, counted with the prior too."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import fixed_lag as fl
    from semantic_slam_tpu_torch.solver import kernels as sk
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args, apply_prior_blocks
    from torch_cases import moved_prior, row_err

    g, se, _ = soa_case(cuda)
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    g, prior, _ = fl.marginalize(g, fl.empty_prior(L, device=cuda), 16)
    if which == "moved":
        prior = moved_prior(prior, g.poses, int(g.num_poses))
    se = soa.build_soa_edges(_edge_args(g), K, se.ll_rk.shape[0], L)
    pf, lf = _free_masks(g)
    lin = apply_prior_blocks(soa.soa_linearize(g.poses, g.landmarks, se), prior, g.poses, g.landmarks)
    lam = torch.tensor(1e-2, device=cuda)
    before = sk.resident_solve.launches, sk.resident_solve.prior_launches
    dk, bk = sk.resident_solve(lin, se, lam, pf, lf, 128, 1e-8, prior.Hp, prior.p_idx)
    dp, bp = soa.soa_schur_step(lin, se, lam, pf, lf, 128, 1e-8, prior.Hp, prior.p_idx)
    torch.cuda.synchronize()
    assert (sk.resident_solve.launches, sk.resident_solve.prior_launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((dk, dp), (bk, bp)):
        assert bool(torch.isfinite(got).all())
        assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 5e-2
    d0, _ = soa.soa_schur_step(lin, se, lam, pf, lf, 128, 1e-8)
    err, effect = row_err(dk, dp, d0, prior.p_idx, int(prior.num_p))
    if which == "moved":
        assert effect > 0.1 * float(torch.linalg.norm(dp[prior.p_idx[:3].long()].double()))
        assert err <= 1e-3 * effect, (err, effect)
    else:  # the marginalized block meets only the gauge-fixed pose 0
        assert set(prior.p_idx.tolist()) == {0} and err == effect == 0.0


# K4's two launch shapes on graphs on both sides of the boundary, and with
# ragged pose ranges: id -> (K, L, R); E2 fills R slots a pose
# (``build_graph`` spreads E2 - 8 observations over K - 2 poses)
SHAPE_CASES = {
    "cluster-K1024-R16": (1024, 256, 16),
    "grid-K2048-R16": (2048, 512, 16),
    "cluster-ragged-K1000-R5": (1000, 250, 5),
    "grid-ragged-K4999-R5": (4999, 1250, 5),
}


def shape_case(device, case):
    K, L, R = SHAPE_CASES[case]
    return soa_case(device, K=K, L=L, E2=8 + (K - 2) * R, R=R)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
@pytest.mark.parametrize("prior", ["none", "moved"])
@pytest.mark.parametrize("cg_tol", [1e-8, 0.0], ids=["early-exit", "fixed-work"])
def test_soa_solve_shapes_match_plain(cuda, case, prior, cg_tol):
    """K4 in the shape ``solve_shape`` picks for the graph (named in the case
    id) against its plain version: dp and db within 5e-2 relative norm, and
    with a dense prior block moved onto three free poses, within 1e-3 of the
    block's own effect at those poses."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import fixed_lag as fl
    from semantic_slam_tpu_torch.solver import kernels as sk
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args, apply_prior_blocks
    from torch_cases import moved_prior, row_err

    g, se, (pf, lf) = shape_case(cuda, case)
    K, L, R = SHAPE_CASES[case]
    assert sk.solve_shape(K, R, L, 232448) == case.split("-")[0]
    Hp = idx = None
    if prior == "moved":
        g, pr, _ = fl.marginalize(g, fl.empty_prior(L, device=cuda), 16)
        pr = moved_prior(pr, g.poses, int(g.num_poses))
        se = soa.build_soa_edges(_edge_args(g), K, R, L)
        pf, lf = _free_masks(g)
        Hp, idx = pr.Hp, pr.p_idx
    lin = soa.soa_linearize(g.poses, g.landmarks, se)
    if prior == "moved":
        lin = apply_prior_blocks(lin, pr, g.poses, g.landmarks)
    lam = torch.tensor(1e-2, device=cuda)
    shapes = dict(sk.resident_solve.shapes)
    dk, bk = sk.resident_solve(lin, se, lam, pf, lf, 128, cg_tol, Hp, idx)
    dp, bp = soa.soa_schur_step(lin, se, lam, pf, lf, 128, cg_tol, Hp, idx)
    torch.cuda.synchronize()
    want = case.split("-")[0]
    assert sk.resident_solve.shapes[want] == shapes[want] + 1
    for got, ref in ((dk, dp), (bk, bp)):
        assert bool(torch.isfinite(got).all())
        assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 5e-2
    assert float(dk[~pf].abs().max()) == 0.0 and float(bk[~lf].abs().max()) == 0.0
    if prior == "moved":
        d0, _ = soa.soa_schur_step(lin, se, lam, pf, lf, 128, cg_tol)
        err, effect = row_err(dk, dp, d0, idx, int(pr.num_p))
        assert effect > 0.1 * float(torch.linalg.norm(dp[idx[:3].long()].double()))
        assert err <= 1e-3 * effect, (err, effect)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cluster-ragged-K1000-R5", "grid-ragged-K4999-R5"])
def test_soa_solve_repeats_bit_for_bit(cuda, case):
    """K4 gives the same bits on two launches in either shape (fixed
    reduction trees, no atomics)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se, (pf, lf) = shape_case(cuda, case)
    lin = soa.soa_linearize(g.poses, g.landmarks, se)
    lam = torch.tensor(1e-2, device=cuda)
    a = sk.resident_solve(lin, se, lam, pf, lf, 128, 0.0)
    b = sk.resident_solve(lin, se, lam, pf, lf, 128, 0.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_solve_shape_smem_matches_kernel(cuda):
    """The shape rule's shared-memory count is the kernel's own."""
    from semantic_slam_tpu_torch import _build
    from semantic_slam_tpu_torch.solver import kernels as sk

    lib = _build.library("soa_solve")
    for K, R, L in [(512, 32, 128), (1000, 5, 250), (4096, 32, 1024), (300, 16, 64), (2048, 16, 512)]:
        assert sk.solve_cluster_smem(K, R, L) == lib.soa_solve_cluster_smem(K, R, L)
    assert lib.soa_solve_smem_optin() > 0


@pytest.mark.cuda
def test_soa_wrappers_reject_bad_inputs(cuda):
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels as sk

    g, se, (pf, lf) = soa_case(cuda, K=40, L=8, E2=200)
    with pytest.raises(TypeError, match="int32"):
        sk.resident_chi2(g.poses, g.landmarks, se._replace(ll_rk=se.ll_rk.long()))
    with pytest.raises(ValueError, match="shape"):
        sk.resident_chi2(g.poses, g.landmarks[:-1], se)
    with pytest.raises(ValueError, match="is on"):
        sk.fused_linearize(g.poses, g.landmarks, se._replace(o_info_ch=se.o_info_ch.cpu()))
    with pytest.raises(ValueError, match="unknown robust"):
        sk.obs_linearize(g.poses, g.landmarks, se, soa.soa_chain_linearize(g.poses, se), "cauchy")
    lin = soa.soa_linearize(g.poses, g.landmarks, se)
    with pytest.raises(ValueError, match="shape"):
        sk.resident_solve(lin, se, torch.tensor(1.0, device=cuda), pf[:-1], lf, 8)
    Hp, idx = torch.eye(48, device=cuda), torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        sk.resident_solve(lin, se, torch.tensor(1.0, device=cuda), pf, lf, 8, 1e-8, Hp.cpu(), idx)
    with pytest.raises(ValueError, match="shape"):
        sk.resident_solve(lin, se, torch.tensor(1.0, device=cuda), pf, lf, 8, 1e-8, Hp, idx[:-1])
    # the launch refuses a prior wider than its block's threads (6 PB > 256)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk.resident_solve(lin, se, torch.tensor(1.0, device=cuda), pf, lf, 8, 1e-8, torch.eye(6 * 43, device=cuda),
                          torch.zeros(43, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("rows", ["whole", "upper-half"])
def test_tiled_kernels_match_plain(cuda, robust, rows):
    """K6 + K7 (one call), K6 alone, K8, K9 and K10 against their plain
    versions on the card, on all rows and on rows [K/2, K): each output
    within 1e-4 of its own scale; one call each."""
    from semantic_slam_tpu_torch.solver import chain_soa as chs
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g, se, _ = soa_case(cuda, R=16)
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    off = 0 if rows == "whole" else K // 2
    de = sd.build_dist_edges(_edge_args(g), K, 16, L, off)
    pc_all = g.poses.T
    pc, pj = pc_all[:, off:].contiguous(), chs.roll_up_pose_ch(pc_all)[:, off:].contiguous()
    wrappers = (tk.tiled_fused_linearize, tk.tiled_obs_linearize, tk.tiled_mv_fwd, tk.tiled_mv_bwd, tk.tiled_chi2)
    counts = [w.launches for w in wrappers]
    cp = sd.chain_plain(pc, pj, de)
    lf, cf = tk.tiled_fused_linearize(pc, pj, g.landmarks, de, robust)
    for a, b in zip(cf, cp):
        assert rel_err(a, b) <= 1e-4
    lk, lp = tk.tiled_obs_linearize(pc, g.landmarks, de, cp, robust), sd.obs_plain(pc, g.landmarks, de, cp, robust)
    for name in lp._fields:
        assert rel_err(getattr(lk, name), getattr(lp, name)) <= 1e-4, name
        assert rel_err(getattr(lf, name), getattr(lp, name)) <= 1e-4, name
    rng = np.random.default_rng(4)
    x, xj = (torch.as_tensor(rng.normal(size=(6, K - off)), dtype=torch.float32, device=cuda) for _ in range(2))
    (Ok, Tk), (Op, Tp) = tk.tiled_mv_fwd(lp, de, x), sd.mv_fwd_plain(lp, de, x)
    assert rel_err(Ok, Op) <= 1e-4 and rel_err(Tk, Tp) <= 1e-4
    for a, b in zip(tk.tiled_mv_bwd(lp, de, Op, Tp, x, xj), sd.mv_bwd_plain(lp, de, Op, Tp, x, xj)):
        assert rel_err(a, b) <= 1e-4
    xk, xp = tk.tiled_chi2(pc, pj, g.landmarks, de, robust), sd.chi2_plain(pc, pj, g.landmarks, de, robust)
    assert rel_err(xk, xp) <= 1e-4
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [c + 1 for c in counts]


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("rows", ["whole", "upper-half"])
def test_tiled_obs_linearize_session_graph(cuda, robust, rows):
    """K6 (K1's two launches on the rows' arrays) at the tiled session's
    graph (K=8192, L=2048, R=32), on all rows and on rows [K/2, K), against
    its plain version within 1e-4 of scale, and the same bits on a repeat."""
    from semantic_slam_tpu_torch.solver import chain_soa as chs
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    K, L, R = 8192, 2048, 32
    g, _, _ = soa_case(cuda, K=K, L=L, E2=32768, R=R)
    off = 0 if rows == "whole" else K // 2
    de = sd.build_dist_edges(_edge_args(g), K, R, L, off)
    pc_all = g.poses.T
    pc, pj = pc_all[:, off:].contiguous(), chs.roll_up_pose_ch(pc_all)[:, off:].contiguous()
    cp = sd.chain_plain(pc, pj, de)
    lk, again = (tk.tiled_obs_linearize(pc, g.landmarks, de, cp, robust) for _ in range(2))
    lp = sd.obs_plain(pc, g.landmarks, de, cp, robust)
    for name in lp._fields:
        assert rel_err(getattr(lk, name), getattr(lp, name)) <= 1e-4, name
        assert torch.equal(getattr(lk, name), getattr(again, name)), name


# K6 + K7 and K10 (the chain as blocks of K6's first launch; K3's slot-group
# objective) at the tiled session's graph and at ragged ones: id -> (K, L, E2, R)
TILED_CASES = {
    "session-K8192-R32": (8192, 2048, 32768, 32),
    "ragged-K1000-R5": (1000, 250, 8 + 998 * 5, 5),
    "ragged-K4999-R5": (4999, 1250, 8 + 4997 * 5, 5),
}
# row ranges of a case: (off, Kl) of K rows
TILED_ROWS = {"whole": lambda K: (0, K), "lower-half": lambda K: (0, K // 2),
              "upper-half": lambda K: (K // 2, K - K // 2)}


def tiled_case(device, case, rows):
    """The case's graph and the row range's pose channels, successors and
    edge store."""
    from semantic_slam_tpu_torch.solver import chain_soa as chs
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    K, L, E2, R = TILED_CASES[case]
    g, _, _ = soa_case(device, K=K, L=L, E2=E2, R=R)
    off, Kl = TILED_ROWS[rows](K)
    de = sd.build_dist_edges(_edge_args(g), K, R, L, off, Kl)
    pc_all = g.poses.T
    pc = pc_all[:, off:off + Kl].contiguous()
    pj = chs.roll_up_pose_ch(pc_all)[:, off:off + Kl].contiguous()
    return g, pc, pj, de


@pytest.mark.cuda
@pytest.mark.parametrize("robust", ["none", "huber", "dcs"])
@pytest.mark.parametrize("rows", sorted(TILED_ROWS))
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_pair_and_chi2_match_plain(cuda, case, rows, robust):
    """K6 + K7 in their one call and K10 against the plain versions on each
    row range: the chain's own blocks, gradients and chi2, the linearization
    that folds its i-side in, the objective, and K10's chain sum alone (the
    observations' information zeroed: in the whole objective it is below
    1e-4 of the observations' terms), each finite and within 1e-4 of its
    scale; one call each counted."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    g, pc, pj, de = tiled_case(cuda, case, rows)
    counts = (tk.tiled_fused_linearize.launches, tk.tiled_chi2.launches)
    lk, ck = tk.tiled_fused_linearize(pc, pj, g.landmarks, de, robust)
    xk = tk.tiled_chi2(pc, pj, g.landmarks, de, robust)
    cp = sd.chain_plain(pc, pj, de)
    lp = sd.obs_plain(pc, g.landmarks, de, cp, robust)
    xp = sd.chi2_plain(pc, pj, g.landmarks, de, robust)
    torch.cuda.synchronize()
    assert (tk.tiled_fused_linearize.launches, tk.tiled_chi2.launches) == tuple(c + 1 for c in counts)
    no_obs = de._replace(info=torch.zeros_like(de.info))
    xk_chain = tk.tiled_chi2(pc, pj, g.landmarks, no_obs, robust)
    xp_chain = sd.chi2_plain(pc, pj, g.landmarks, no_obs, robust)
    assert float(xp_chain) > 0
    for name, got, want in zip(cp._fields + lp._fields + ("objective", "chain objective"), ck + lk + (xk, xk_chain),
                               cp + lp + (xp, xp_chain)):
        assert bool(torch.isfinite(got).all()) and rel_err(got, want) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged-K1000-R5", "session-K8192-R32"])
def test_tiled_range_last_row_chain(cuda, case):
    """The lower half's last row: its chain edge meets the upper half's first
    pose (the host's successor) with real information. K7's outputs of that
    row match the plain version within 1e-4 of their own scale; K10's chain
    sum (the observations' information zeroed, so that its objective is the
    chain's alone: the observations' chi2 is ~1e5 times the row's) matches
    the plain version's within 1e-4 with and without that row's
    information; and K7's and K10's chain chi2 move as the plain version's
    when it is zeroed."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    g, pc, pj, de = tiled_case(cuda, case, "lower-half")
    assert float(de.o_info_ch[..., -1].abs().max()) > 0
    ck = tk.tiled_fused_linearize(pc, pj, g.landmarks, de)[1]
    cp = sd.chain_plain(pc, pj, de)
    for name, got, want in zip(cp._fields[:5], ck[:5], cp[:5]):
        assert float(want[..., -1].abs().max()) > 0, name
        assert rel_err(got[..., -1], want[..., -1]) <= 1e-4, name
    info = de.o_info_ch.clone()
    info[..., -1] = 0.0
    cut = de._replace(o_info_ch=info)
    row_plain = float(cp.chi2 - sd.chain_plain(pc, pj, cut).chi2)
    assert row_plain > 0
    row_k7 = float(ck.chi2 - tk.tiled_fused_linearize(pc, pj, g.landmarks, cut)[1].chi2)
    no_obs = {"info": torch.zeros_like(de.info)}
    chain_k10 = [tk.tiled_chi2(pc, pj, g.landmarks, e._replace(**no_obs)) for e in (de, cut)]
    for got, e in zip(chain_k10, (de, cut)):
        assert rel_err(got, sd.chi2_plain(pc, pj, g.landmarks, e._replace(**no_obs))) <= 1e-4
    row_k10 = float(chain_k10[0] - chain_k10[1])
    # 1e-4 of the chain chi2's scale, and at most a tenth of the row's term, so that a row left out fails
    # (the rounding of two f32 sums of Kl terms is ~1e-6 of the scale)
    tol = min(1e-4 * float(cp.chi2), 0.1 * row_plain)
    assert abs(row_k7 - row_plain) <= tol and abs(row_k10 - row_plain) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["whole", "lower-half"])
@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_pair_and_chi2_repeat_bit_for_bit(cuda, case, rows):
    """K6 + K7 and K10 give the same bits on repeated calls (fixed summation
    orders, no float atomics)."""
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    g, pc, pj, de = tiled_case(cuda, case, rows)
    (la, ca), (lb, cb) = (tk.tiled_fused_linearize(pc, pj, g.landmarks, de, "huber") for _ in range(2))
    for name, x, y in zip(la._fields + ca._fields, la + ca, lb + cb):
        assert torch.equal(x, y), name
    xs = [tk.tiled_chi2(pc, pj, g.landmarks, de, "dcs") for _ in range(3)]
    assert torch.equal(xs[0], xs[1]) and torch.equal(xs[1], xs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["whole", "upper-half"])
def test_tiled_mv_bwd_ragged_repeats(cuda, rows):
    """K9 at a ragged row count and R (K=1000, R=5: rows [500, 1000) are not a
    multiple of its 32-row blocks, R not of its 8 slot groups) against its
    plain version within 1e-4 of scale, and the same bits on two launches."""
    from semantic_slam_tpu_torch.solver import chain_soa as chs
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    K, L, R = 1000, 250, 5
    g, _, _ = soa_case(cuda, K=K, L=L, E2=8 + (K - 2) * R, R=R)
    off = 0 if rows == "whole" else K // 2
    de = sd.build_dist_edges(_edge_args(g), K, R, L, off)
    pc_all = g.poses.T
    pc, pj = pc_all[:, off:].contiguous(), chs.roll_up_pose_ch(pc_all)[:, off:].contiguous()
    lp = sd.obs_plain(pc, g.landmarks, de, sd.chain_plain(pc, pj, de))
    rng = np.random.default_rng(6)
    x, xj = (torch.as_tensor(rng.normal(size=(6, K - off)), dtype=torch.float32, device=cuda) for _ in range(2))
    Op, Tp = sd.mv_fwd_plain(lp, de, x)
    got = tk.tiled_mv_bwd(lp, de, Op, Tp, x, xj)
    again = tk.tiled_mv_bwd(lp, de, Op, Tp, x, xj)
    for a, b, c in zip(got, sd.mv_bwd_plain(lp, de, Op, Tp, x, xj), again):
        assert rel_err(a, b) <= 1e-4
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_tiled_wrappers_reject_bad_inputs(cuda):
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g, _, _ = soa_case(cuda, K=40, L=8, E2=200)
    de = sd.build_dist_edges(_edge_args(g), 40, 8, 8)
    pc = g.poses.T.contiguous()
    with pytest.raises(ValueError, match="is on"):
        tk.tiled_chi2(pc, pc.cpu(), g.landmarks, de)
    with pytest.raises(ValueError, match="is on"):
        tk.tiled_fused_linearize(pc, pc.cpu(), g.landmarks, de)
    lin = sd.obs_plain(pc, g.landmarks, de, sd.chain_plain(pc, pc, de))
    with pytest.raises(ValueError, match="is on"):
        tk.tiled_mv_fwd(lin._replace(Rt=lin.Rt.cpu()), de, torch.zeros((6, 40), device=cuda))


MAHA = dict(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4)
SMALL_SESSIONS = {
    # gating, capacities: (max_keyframes, max_landmark_edges), LM iteration cap, linear solver, fixed-lag
    # window (chunk 8)
    "euclid": (dict(use_maha_dist=False, use_eq_dist=True, eq_dist_thres=1.0, land_noise_low=0.1), (8, 32), 64,
               "dense", 0),
    "maha": (MAHA, (16, 64), 32, "dense", 0),
    "maha-pcg": (MAHA, (16, 64), 32, "pcg", 0),
    "maha-pcg-tiled": (MAHA, (16, 64), 32, "pcg", 0),
    "maha-fixed-lag": (MAHA, (8, 64), 32, "dense", 8),
    "maha-pcg-fixed-lag": (MAHA, (8, 64), 32, "pcg", 8),
}


def small_config(assoc, caps, max_iterations, solver, window, planes=False):
    from semantic_slam_tpu_torch.config import (
        AssociationConfig, CapacityConfig, KeyframeConfig, SegmentationConfig, SlamConfig, SolverConfig,
    )

    kf_cap, lme_cap = caps
    return SlamConfig(
        keyframe=KeyframeConfig(delta_trans=0.4, delta_angle=0.4, delta_time=2.0),
        segmentation=SegmentationConfig(
            num_point_seg=100, norm_point_thres=400, planar_area=0.01, crop_height=64, crop_width=64,
            max_planes_per_detection=2, num_hypotheses=64, normal_smoothing_size=10,
        ),
        association=AssociationConfig(**assoc),
        solver=SolverConfig(max_iterations=max_iterations, linear_solver=solver, fixed_lag_window=window,
                            fixed_lag_chunk=8),
        capacity=CapacityConfig(max_keyframes=kf_cap, max_landmarks=16, max_odom_edges=kf_cap,
                                max_landmark_edges=lme_cap, max_detections_per_frame=4),
        use_plane_landmarks=planes,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("gating", sorted(SMALL_SESSIONS))
def test_small_session_card_matches_cpu(cuda, gating, monkeypatch):
    """Same log, same config (f32) on the card and on the CPU: the same map,
    and trajectories within the f32 tolerance 1e-3 (index_add_, cuBLAS and
    the kernels sum in other orders than the CPU). With ``pcg`` every LM
    iteration on the card runs K1-K4, or K6-K10 where the crossover is
    lowered below the session's capacity (``-tiled``). The fixed-lag sessions
    marginalize (the window and the keyframes' archive agree too), and their
    K4 launches all carry the prior."""
    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.solver import kernels as sk
    from semantic_slam_tpu_torch.solver import soa_dist
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    if gating.endswith("tiled"):
        monkeypatch.setattr(soa_dist, "TILED_FROM_K", 0)
    assoc, (kf_cap, lme_cap), max_iterations, solver, window = SMALL_SESSIONS[gating]
    cfg = small_config(assoc, (kf_cap, lme_cap), max_iterations, solver, window)
    log = cli.make_synthetic_log(seed=3, n_steps=240 if window else 120, sensor_every=5, drift_noise=0.008, H=120,
                                 W=160)
    before = sk.resident_solve.launches, tk.tiled_mv_bwd.launches, sk.resident_solve.prior_launches
    gpu, cpu = cli.run_session(log, cfg, "cuda"), cli.run_session(log, cfg, "cpu")
    resident = solver == "pcg" and not gating.endswith("tiled")
    assert (sk.resident_solve.launches > before[0]) == resident
    assert (tk.tiled_mv_bwd.launches > before[1]) == gating.endswith("tiled")
    assert sk.resident_solve.prior_launches - before[2] == (
        sk.resident_solve.launches - before[0] if window else 0)
    if window:
        assert gpu._kf_base == cpu._kf_base > 0 and gpu._n_poses == cpu._n_poses < window + 8
        assert len(gpu.get_keyframe_poses()) == len(gpu.keyframes)
    assert gpu.graph.poses.device.type == "cuda" and gpu.graph.max_poses > kf_cap  # grew on the card
    for e in (gpu, cpu):
        assert int(e.table.count) > 0
    assert (len(gpu.keyframes), int(gpu.table.count), int(gpu.graph.num_edges())) == (
        len(cpu.keyframes), int(cpu.table.count), int(cpu.graph.num_edges())
    )
    n = int(cpu.graph.num_lme)
    np.testing.assert_array_equal(gpu.graph.lme_l[:n].cpu().numpy(), cpu.graph.lme_l[:n].numpy())
    np.testing.assert_allclose(gpu.get_keyframe_poses(), cpu.get_keyframe_poses(), atol=1e-3)


PLANE_SESSIONS = {
    # chip_smoke.py's plane sessions A (dense) and C (pcg with fixed-lag smoothing: the row-range loop's plane
    # half, K6-K10, with a prior that has a plane part), at a small size
    "maha-planes": (MAHA, (16, 64), 32, "dense", 0),
    "maha-pcg-planes-fixed-lag": (MAHA, (8, 64), 32, "pcg", 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLANE_SESSIONS))
def test_small_plane_session_card_matches_cpu(cuda, case):
    """Plane landmarks on the card and on the CPU, same log and config (f32):
    the same map (keyframes, landmarks, planes, plane edges), trajectories
    and planes within 1e-3. With ``pcg`` every LM iteration on the card runs
    K6-K10 (the plane LM takes the row-range loop at every K) and no K4; the
    fixed-lag session marginalizes into a prior with a plane part."""
    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.solver import kernels as sk
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    assoc, caps, max_iterations, solver, window = PLANE_SESSIONS[case]
    cfg = small_config(assoc, caps, max_iterations, solver, window, planes=True)
    log = cli.make_synthetic_log(seed=3, n_steps=240 if window else 120, sensor_every=5, drift_noise=0.008, H=120,
                                 W=160)
    before = sk.resident_solve.launches, tk.tiled_mv_bwd.launches, tk.tiled_chi2.launches
    gpu, cpu = cli.run_session(log, cfg, "cuda"), cli.run_session(log, cfg, "cpu")
    assert sk.resident_solve.launches == before[0]
    assert (tk.tiled_mv_bwd.launches > before[1]) == (solver == "pcg")
    assert (tk.tiled_chi2.launches > before[2]) == (solver == "pcg")
    if window:
        assert gpu._kf_base == cpu._kf_base > 0 and gpu._n_poses == cpu._n_poses < window + 8
        assert float(gpu.prior.Hpl.abs().sum()) > 0
    assert gpu.graph.poses.device.type == gpu.plane_nodes.planes.device.type == "cuda"
    assert gpu.graph.max_poses > caps[0] and gpu.plane_nodes.max_planes == gpu.graph.max_landmarks  # grew
    pg, pc = gpu.plane_nodes, cpu.plane_nodes
    assert int(cpu.table.count) > 0
    assert (len(gpu.keyframes), int(gpu.table.count), int(pg.num_planes), int(pg.num_pe)) == (
        len(cpu.keyframes), int(cpu.table.count), int(pc.num_planes), int(pc.num_pe))
    assert int(pc.num_planes) == int(cpu.table.count) and int(pc.num_pe) == int(cpu.graph.num_lme)
    P, E3 = int(pc.num_planes), int(pc.num_pe)
    np.testing.assert_array_equal(pg.pe_p[:E3].cpu().numpy(), pc.pe_p[:E3].numpy())
    np.testing.assert_allclose(gpu.get_keyframe_poses(), cpu.get_keyframe_poses(), atol=1e-3)
    np.testing.assert_allclose(pg.planes[:P].cpu().numpy(), pc.planes[:P].numpy(), atol=1e-3)


BREADTH_SESSIONS = {
    # window ingest: each run of detection keyframes one frontend call (K5 over B*D detections a round)
    "window": dict(solver_kw=dict(ingest_window=4)),
    # the tridiagonal preconditioner: the resident loop (K1-K3, no K4) and the row-range loop (K6-K10)
    "tridiag-resident": dict(solver_kw=dict(linear_solver="pcg", pcg_precond="tridiag")),
    "tridiag-tiled": dict(solver_kw=dict(linear_solver="pcg", pcg_precond="tridiag"), tiled=True),
    "adaptive-normals": dict(seg_kw=dict(adaptive_normals=True)),
    "fitness": dict(info_kw=dict(use_const_inf_matrix=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BREADTH_SESSIONS))
def test_breadth_session_card_matches_cpu(cuda, case, monkeypatch):
    """Window ingest, the tridiagonal preconditioner on both PCG loops,
    adaptive normals and fitness information on the card and on the CPU,
    same log and config (f32): the same map (keyframes, landmarks, edges,
    landmark ids) and trajectories within 1e-3. The window session's K5
    launches are two rounds a frontend call (a window's call holds its
    rows' detections); tridiag sessions launch no K4."""
    import dataclasses

    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.frontend import kernels as fk
    from semantic_slam_tpu_torch.runtime import engine as eng_mod
    from semantic_slam_tpu_torch.solver import kernels as sk
    from semantic_slam_tpu_torch.solver import soa_dist
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    spec = BREADTH_SESSIONS[case]
    if spec.get("tiled"):
        monkeypatch.setattr(soa_dist, "TILED_FROM_K", 0)
    cfg = small_config(MAHA, (16, 64), 32, "dense", 0)
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **spec.get("solver_kw", {})),
                      segmentation=dataclasses.replace(cfg.segmentation, **spec.get("seg_kw", {})),
                      information=dataclasses.replace(cfg.information, **spec.get("info_kw", {})))
    log = cli.make_synthetic_log(seed=3, n_steps=120, sensor_every=5, drift_noise=0.008, H=120, W=160)
    rows = []
    orig = eng_mod._process_keyframes_window

    def window(*a, **kw):
        rows.append(int(kw["odoms"].shape[0]))
        return orig(*a, **kw)

    monkeypatch.setattr(eng_mod, "_process_keyframes_window", window)
    before = (fk.score_hypotheses.launches, sk.resident_solve.launches, sk.fused_linearize.launches,
              tk.tiled_mv_bwd.launches)
    gpu = cli.run_session(log, cfg, "cuda", finalize=True)
    k5, k4, k12, k9 = (fk.score_hypotheses.launches - before[0], sk.resident_solve.launches - before[1],
                       sk.fused_linearize.launches - before[2], tk.tiled_mv_bwd.launches - before[3])
    card_rows = list(rows)
    cpu = cli.run_session(log, cfg, "cpu", finalize=True)
    n_det = sum(1 for kf in gpu.keyframes if eng_mod._is_det(kf))
    assert k5 == 2 * (n_det - sum(card_rows) + len(card_rows)) > 0
    if case == "window":
        assert card_rows and max(card_rows) >= 2
    if case.startswith("tridiag"):
        assert k4 == 0 and (k9 > 0) == bool(spec.get("tiled")) and k12 > 0
    assert gpu.graph.poses.device.type == "cuda"
    assert int(cpu.table.count) > 0
    assert (len(gpu.keyframes), int(gpu.table.count), int(gpu.graph.num_edges())) == (
        len(cpu.keyframes), int(cpu.table.count), int(cpu.graph.num_edges()))
    n = int(cpu.graph.num_lme)
    np.testing.assert_array_equal(gpu.graph.lme_l[:n].cpu().numpy(), cpu.graph.lme_l[:n].numpy())
    # two sessions are more sensitive to rounding than the others: adaptive
    # windows threshold z differences (a depth edge at |dz| = 0.03 |z| +
    # 0.02), so a rounding moves a window's scale; fitness information weighs
    # the odometry 10^2-10^5 times less than the constant matrix, so the
    # frontend's rounding moves the poses more. On the CPU alone their f32
    # and f64 poses differ by 2.8e-3 and 2.8e-4 (the constant-information,
    # fixed-window session's by 3.0e-5); the card against the CPU, 1e-2
    atol = 1e-2 if case in ("adaptive-normals", "fitness") else 1e-3
    np.testing.assert_allclose(gpu.get_keyframe_poses(), cpu.get_keyframe_poses(), atol=atol)
    if case == "fitness":
        m = int(cpu.graph.num_odom)
        np.testing.assert_allclose(gpu.graph.odom_info[:m].cpu().numpy(), cpu.graph.odom_info[:m].numpy(),
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# the ROS surface on the card: a .bag session, segment_keyframe, the voxel map
# ---------------------------------------------------------------------------


@pytest.fixture
def bag_sessions(cuda, tmp_path, monkeypatch):
    """The small maha-pcg session read from a ``.bag`` (NaN at invalid
    pixels, whole-pixel boxes) on the card, with each detection keyframe's
    processing-time detections recorded, and on the CPU: (card engine, CPU
    engine, the card's detections in keyframe order)."""
    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.io.rosbag_write import write_bag
    from semantic_slam_tpu_torch.runtime import engine as eng_mod
    from semantic_slam_tpu_torch.solver import kernels as sk

    cfg = small_config(*SMALL_SESSIONS["maha-pcg"])
    path = str(tmp_path / "s.bag")
    write_bag(path, cli.make_synthetic_log(seed=3, n_steps=120, sensor_every=5, drift_noise=0.008, H=120, W=160))
    log = cli.load_replay_log(path)
    assert any(np.isnan(c.points).any() for c in log.clouds)
    seen = []
    orig = eng_mod._segment_only

    def recording(*a, **kw):
        out = orig(*a, **kw)
        # a window's call returns [B, M] fields: one keyframe's detections a row
        seen.extend([out] if out.valid.dim() == 1 else
                    [type(out)(*(f[b] for f in out)) for b in range(out.valid.shape[0])])
        return out

    before = sk.resident_solve.launches
    with monkeypatch.context() as mp:
        mp.setattr(eng_mod, "_segment_only", recording)
        gpu = cli.run_session(log, cfg, "cuda")
    assert sk.resident_solve.launches > before
    return gpu, cli.run_session(log, cfg, "cpu"), seen


@pytest.mark.cuda
def test_bag_session_card_matches_cpu(bag_sessions):
    """A ``.bag`` session on the card and on the CPU: the same map, poses
    within the f32 tolerance 1e-3."""
    gpu, cpu, _ = bag_sessions
    assert int(cpu.table.count) > 0
    assert (len(gpu.keyframes), int(gpu.table.count), int(gpu.graph.num_edges())) == (
        len(cpu.keyframes), int(cpu.table.count), int(cpu.graph.num_edges()))
    np.testing.assert_allclose(gpu.get_keyframe_poses(), cpu.get_keyframe_poses(), atol=1e-3)


@pytest.mark.cuda
def test_segment_keyframe_card_matches_cpu(bag_sessions):
    """``segment_keyframe`` on the card (K5 launches, one a plane round of a
    detection keyframe): equal to the card's processing-time detections of
    each keyframe, and against the CPU on the same stored keyframes the
    same valid detections and types, world poses (plane centroids) within
    1 cm: K5 compares in f32, so points at the distance gate may fall on
    the other side on the card and move a centroid by millimetres (2.6 mm
    seen on an H100)."""
    from semantic_slam_tpu_torch.frontend import kernels as fk
    from semantic_slam_tpu_torch.runtime.engine import _is_det

    gpu, cpu, seen = bag_sessions
    det = [(g, c) for g, c in zip(gpu.keyframes, cpu.keyframes) if _is_det(c)]
    assert len(det) == len(seen) > 0
    before = fk.score_hypotheses.launches
    n_valid = 0
    for (kg, kc), dets in zip(det, seen):
        dg, dc = gpu.segment_keyframe(kg), cpu.segment_keyframe(kc)
        np.testing.assert_array_equal(dg["valid"], dets.valid.cpu().numpy())
        np.testing.assert_array_equal(dg["world_pose"], dets.world_pose.cpu().numpy())
        v = dc["valid"]
        np.testing.assert_array_equal(dg["valid"], v)
        np.testing.assert_array_equal(dg["plane_type"][v], dc["plane_type"][v])
        np.testing.assert_allclose(dg["world_pose"][v], dc["world_pose"][v], atol=1e-2)
        n_valid += int(v.sum())
    assert n_valid > 0
    assert fk.score_hypotheses.launches - before == len(det) * gpu.cfg.segmentation.max_planes_per_detection


@pytest.mark.cuda
@pytest.mark.parametrize("carve", [False, True])
def test_voxel_map_card_matches_cpu(bag_sessions, carve):
    """The chunked voxel map of the card session's keyframe clouds at its
    poses, built on the card (``cli.build_voxel_map``) and on the CPU from
    the same inserts: the same chunks; voxels whose counts differ at most
    0.1% of the occupied ones; the card's hits are its valid points inside
    its chunks."""
    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.mapping import voxel as vox

    gpu, _, _ = bag_sessions
    g = cli.build_voxel_map(gpu, carve=carve)
    cpu_map = vox.ChunkedVoxelMap(carve=carve, dtype=gpu.dtype)
    inside = 0  # valid points inside the card's chunks, counted by masks
    for kf in gpu.keyframes:
        ins = cli.voxel_inputs(gpu, kf)
        cpu_map.insert_keyframe_cloud(*(t.cpu() for t in ins))
        w, v = vox._world_points_aabb(*ins)[:2]
        for c in g.chunks.values():
            idx = vox._indices(c, torch.where(v[:, None], w, c.origin).unbind(-1))
            inside += int((vox._in_bounds(c, idx) & v).sum())
    assert list(g.chunks) == list(cpu_map.chunks) and g.chunks
    occupied = sum(int((c.hits >= 2).sum()) for c in cpu_map.chunks.values())
    differ = sum(int((g.chunks[cc].hits.cpu() != c.hits).sum() + (g.chunks[cc].misses.cpu() != c.misses).sum())
                 for cc, c in cpu_map.chunks.items())
    assert occupied > 0 and differ <= 1e-3 * occupied
    assert (sum(int(c.misses.sum()) for c in g.chunks.values()) > 0) == carve
    assert g.total_hits() == inside > 0
    assert all(c.hits.device.type == "cuda" for c in g.chunks.values())


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", ["nccl-1", "gloo-2-sharing-cuda0"])
def test_sharded_lm_on_the_card_matches_one_device(cuda, ranks):
    """``soa_dist.sharded_lm_optimize_soa`` on a mesh on the card (NCCL at
    world size 1; two gloo ranks sharing ``cuda:0``, rows [K/2, K) at
    off > 0) against ``lm_optimize_soa_tiled`` at fixed work, f32, K=512:
    poses within 1e-4 of scale, the same iterations, and the workers' K6
    launches as the iterations imply."""
    from semantic_slam_tpu_torch.graph import synthetic as syn
    from semantic_slam_tpu_torch.parallel import dist
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.utils.profiling import mesh_kernel_launches

    K, L, E2 = 512, 128, 2048
    g = syn.build_graph(K, L, E2, torch.float32, seed=0, noise=0.05, device=cuda)
    kw = dict(max_iterations=4, min_edges=0, rel_tol=0.0, max_cg_iters=32, cg_tol=0.0,
              ell_rows=syn.ell_rows_for(K, E2))
    ref, ref_stats = sd.lm_optimize_soa_tiled(g, **kw)
    mesh = (dist.make_mesh(1, device="cuda") if ranks == "nccl-1"
            else dist.make_mesh(2, backend="gloo", devices=["cuda:0", "cuda:0"]))
    try:
        assert mesh.backend == ranks.split("-")[0]
        mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
        got, stats = sd.sharded_lm_optimize_soa(g, mesh, **kw)
        launches = mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
        assert mesh.forbidden_modules() == [[]] * mesh.size
    finally:
        mesh.close()
    assert stats.iterations == ref_stats.iterations == 4
    err = float((got.poses - ref.poses).abs().max() / ref.poses.abs().max())
    assert err <= 1e-4, err
    assert [r["tiled_fused_linearize"] for r in launches] == [4] * mesh.size
    assert [r["tiled_mv_bwd"] for r in launches] == [4 * 33] * mesh.size
