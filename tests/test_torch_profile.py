"""The port's profiling replay on the CPU, at a tiny size: every layer of the
slice is timed once per call and unwrapped afterwards, and the timed run
makes the same ticks as the plain one; with ``--solver pcg`` the solver's
layers (the resident loop's, or the row-range loop's above the crossover)
are called as often as the LM's iterations imply."""

import dataclasses
import importlib

from semantic_slam_tpu_torch import cli
from semantic_slam_tpu_torch import profile_slice as ps


# the layers only the SoA Schur-PCG solver runs: the resident loop's, then
# the row-range loop's
PCG_LAYERS = ("lm_optimize_soa", "build_soa_edges", "resident_linearize", "resident_solve", "resident_chi2",
              "landmark_marginals_mf")
TILED_LAYERS = ("lm_optimize_soa_tiled", "build_dist_edges", "tiled_fused_linearize", "tiled_mv_fwd",
                "tiled_mv_bwd", "tiled_chi2")
# the layers only fixed-lag smoothing runs
PRIOR_LAYERS = ("marginalize", "lm_optimize_prior", "prior_fold", "prior_matvec", "prior_marginals")
# the layers only plane landmarks run (their ticks share the point ticks' labels)
PLANE_LAYERS = ("lm_optimize_with_planes", "linearize_with_planes", "lm_optimize_soa_planes", "plane_lin",
                "plane_matvec", "ell_linearize_planes")


def _small(solver: str, max_iterations: int, n_steps: int = 42, **solver_kw):
    log = cli.make_synthetic_log(seed=0, n_steps=n_steps, sensor_every=6, loops=1, H=60, W=80)
    cfg = cli.make_config(cli.build_parser().parse_args(
        ["run", "--log", "in-process", "--device", "cpu", "--max-keyframes", "8", "--crop-size", "32",
         "--solver", solver]
    ))
    return log, cfg.replace(solver=dataclasses.replace(cfg.solver, max_iterations=max_iterations, **solver_kw))


def test_profile_session_times_every_layer_and_unwraps():
    originals = {(m, a): getattr(importlib.import_module(m), a) for m, a, _ in ps.LAYERS}
    # two LM iterations a tick keep the trace, and parsing it, small
    log, cfg = _small("dense", 2)
    report = ps.profile_session(log, cfg, "cpu")

    for (m, a), fn in originals.items():
        assert getattr(importlib.import_module(m), a) is fn, f"{m}.{a} left wrapped"
    plain, traced = report["plain"], report["traced"]
    assert plain["lm_iterations"] == traced["lm_iterations"]
    rows = {r["layer"]: r for r in report["layers"]}
    assert all(rows.pop(label)["calls"] == 0 for label in PCG_LAYERS + TILED_LAYERS + PRIOR_LAYERS + PLANE_LAYERS)
    assert all(r["calls"] > 0 and r["host_ms_total"] > 0 and r["device_ms_total"] is None for r in rows.values())
    assert rows["_optimize_tick"]["calls"] == len(traced["tick_ms"])
    assert rows["score_hypotheses"]["calls"] == cfg.segmentation.max_planes_per_detection * rows["extract_planes"]["calls"]
    n_opt = sum(1 for it in traced["lm_iterations"] if it > 0)
    # one linearization per LM iteration, plus the first of each optimizing tick
    assert rows["linearize_arrays"]["calls"] == sum(traced["lm_iterations"]) + n_opt
    assert traced["busy_share"] is None


def test_profile_session_pcg_counts_the_solver_layers():
    """The pcg session: per optimizing tick, K1 + K2 (one wrapper call) once
    per LM iteration plus twice (the first and the final linearization), K4 once per
    iteration, K3 once per iteration and once per solve skipped below the
    edge gate; the dense LM's layers never run."""
    log, cfg = _small("pcg", 1, pcg_iters=2)
    report = ps.profile_session(log, cfg, "cpu")
    traced = report["traced"]
    rows = {r["layer"]: r["calls"] for r in report["layers"]}
    ran = [it for it in traced["lm_iterations"] if it > 0]
    assert ran and rows["lm_optimize_soa"] == rows["_optimize_tick"] == len(traced["tick_ms"])
    assert rows["resident_linearize"] == sum(it + 2 for it in ran)
    assert rows["resident_solve"] == sum(ran)
    assert rows["resident_chi2"] == sum(ran) + rows["lm_optimize_soa"] - len(ran)
    assert rows["landmark_marginals_mf"] == len(ran)
    assert rows["lm_optimize"] == rows["linearize_arrays"] == rows["schur_solve"] == 0
    assert all(rows[label] == 0 for label in TILED_LAYERS)


def test_profile_session_tiled_counts_the_solver_layers(monkeypatch):
    """The pcg session above the crossover (lowered here so that the tiny
    graph crosses it): per solve, K6 + K7 (one wrapper call) once per LM
    iteration, K8 and K9 (CG steps + 1) times per iteration, K10 once per
    iteration and once per solve skipped below the edge gate, and one K1 + K2
    linearization for the marginals; the resident loop's solve kernels never
    run."""
    from semantic_slam_tpu_torch.solver import soa_dist

    monkeypatch.setattr(soa_dist, "TILED_FROM_K", 4)
    log, cfg = _small("pcg", 1, pcg_iters=2)
    report = ps.profile_session(log, cfg, "cpu")
    traced = report["traced"]
    rows = {r["layer"]: r["calls"] for r in report["layers"]}
    ran = [it for it in traced["lm_iterations"] if it > 0]
    assert ran and rows["lm_optimize_soa_tiled"] == rows["_optimize_tick"] == rows["build_dist_edges"]
    assert rows["tiled_fused_linearize"] == sum(ran)
    assert rows["tiled_mv_fwd"] == rows["tiled_mv_bwd"] == sum(it * (2 + 1) for it in ran)
    assert rows["tiled_chi2"] == sum(ran) + rows["lm_optimize_soa_tiled"] - len(ran)
    assert rows["resident_linearize"] == rows["landmark_marginals_mf"] == len(ran)
    assert rows["lm_optimize_soa"] == rows["resident_solve"] == rows["resident_chi2"] == 0


def test_profile_session_fixed_lag_labels_the_prior_layers():
    """A fixed-lag session (window 8, chunk 4) on the dense LM and on the
    resident PCG loop: the graph is marginalized at least once, every
    linearization folds the prior (``prior_fold``), and on pcg every
    matrix-free marginal recovery folds the prior's boundary coupling
    (``prior_marginals``)."""
    for solver in ("dense", "pcg"):
        log, cfg = _small(solver, 2, n_steps=192, pcg_iters=2, fixed_lag_window=8, fixed_lag_chunk=4)
        report = ps.profile_session(log, cfg, "cpu")
        rows = {r["layer"]: r["calls"] for r in report["layers"]}
        assert rows["marginalize"] >= 1, solver
        if solver == "dense":
            assert rows["lm_optimize_prior"] == rows["_optimize_tick"] and rows["lm_optimize"] == 0
            assert rows["prior_fold"] == rows["linearize_arrays"] > 0
            assert rows["prior_marginals"] == 0
        else:
            assert rows["prior_fold"] == rows["resident_linearize"] > 0
            assert rows["prior_marginals"] == rows["landmark_marginals_mf"] > 0
            assert rows["lm_optimize_prior"] == rows["prior_matvec"] == 0


def test_profile_session_planes_counts_the_plane_layers():
    """Plane-landmark sessions: on the dense LM one plane linearization per
    LM iteration plus the first of each solve (and the point marginals' one
    linearization at its end); on pcg the row-range loop at
    this small K, with the plane half's linearization (``plane_lin``) once
    per LM iteration and its products (``plane_matvec``) twice per CG step
    plus once for the right-hand side and once for the back-substitution,
    K10 once per LM iteration and once per solve skipped below the edge
    gate, the plane blocks joining the marginals once per solve."""
    for solver in ("dense", "pcg"):
        log, cfg = _small(solver, 2, n_steps=60, pcg_iters=2)
        report = ps.profile_session(log, cfg.replace(use_plane_landmarks=True), "cpu")
        traced = report["traced"]
        rows = {r["layer"]: r["calls"] for r in report["layers"]}
        ran = [it for it in traced["lm_iterations"] if it > 0]
        assert ran, solver
        assert rows["lm_optimize"] == rows["lm_optimize_soa"] == rows["lm_optimize_soa_tiled"] == 0
        if solver == "dense":
            assert rows["lm_optimize_with_planes"] == rows["_optimize_tick"] == len(traced["tick_ms"])
            assert rows["linearize_with_planes"] == sum(ran) + len(ran)
            # and the point marginals' fresh linearization at the final state
            assert rows["linearize_arrays"] == rows["linearize_with_planes"] + len(ran)
            assert rows["lm_optimize_soa_planes"] == rows["plane_lin"] == 0
        else:
            assert rows["lm_optimize_soa_planes"] == rows["_optimize_tick"] == len(traced["tick_ms"])
            assert rows["plane_lin"] == rows["tiled_fused_linearize"] == sum(ran)
            # K10 once per LM iteration and once per solve skipped below the edge gate
            assert rows["tiled_chi2"] == sum(ran) + rows["lm_optimize_soa_planes"] - len(ran)
            assert rows["lm_optimize_soa_planes"] > len(ran)
            assert rows["plane_matvec"] == sum(it * (2 * 2 + 2) for it in ran)
            assert rows["ell_linearize_planes"] == rows["landmark_marginals_mf"] == len(ran)
            assert rows["lm_optimize_with_planes"] == 0
