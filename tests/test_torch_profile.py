"""The port's profiling replay on the CPU, at a tiny size: every layer of the
slice is timed once per call and unwrapped afterwards, and the timed run
makes the same ticks as the plain one."""

import dataclasses
import importlib

from semantic_slam_tpu_torch import cli
from semantic_slam_tpu_torch import profile_slice as ps


def test_profile_session_times_every_layer_and_unwraps():
    originals = {(m, a): getattr(importlib.import_module(m), a) for m, a, _ in ps.LAYERS}
    log = cli.make_synthetic_log(seed=0, n_steps=42, sensor_every=6, loops=1, H=60, W=80)
    cfg = cli.make_config(cli.build_parser().parse_args(
        ["run", "--log", "in-process", "--device", "cpu", "--max-keyframes", "8", "--crop-size", "32"]
    ))
    # two LM iterations a tick keep the trace, and parsing it, small
    cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, max_iterations=2))
    report = ps.profile_session(log, cfg, "cpu")

    for (m, a), fn in originals.items():
        assert getattr(importlib.import_module(m), a) is fn, f"{m}.{a} left wrapped"
    plain, traced = report["plain"], report["traced"]
    assert plain["lm_iterations"] == traced["lm_iterations"]
    rows = {r["layer"]: r for r in report["layers"]}
    assert all(r["calls"] > 0 and r["host_ms_total"] > 0 and r["device_ms_total"] is None for r in rows.values())
    assert rows["_optimize_tick"]["calls"] == len(traced["tick_ms"])
    assert rows["score_hypotheses"]["calls"] == cfg.segmentation.max_planes_per_detection * rows["extract_planes"]["calls"]
    n_opt = sum(1 for it in traced["lm_iterations"] if it > 0)
    # one linearization per LM iteration, plus the first of each optimizing tick
    assert rows["linearize_arrays"]["calls"] == sum(traced["lm_iterations"]) + n_opt
    assert traced["busy_share"] is None
