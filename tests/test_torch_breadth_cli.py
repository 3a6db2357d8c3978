"""The breadth flags through both CLIs on the same 120x160 log, on the CPU
in f64 (a profile registered in both packages' ``PROFILES``, as
``tests/test_torch_lifecycle.py`` does):

  * ``--solver pcg --precond tridiag`` (the JAX engine under
    ``SLAM_SOLVER_IMPL=soa``: its resident SoA loop's XLA branch; the port's
    resident loop with ``soa_schur_step_tridiag``);
  * ``--adaptive-normals``;
  * ``--ingest-window 4`` (the CLI's closing ``finalize()``);
  * a profile with ``use_const_inf_matrix=False`` (fitness information: a
    config field with no flag in either CLI).

The JAX package's output directories are stored (``REF``,
``tests/jax_golden.py``); the port's run live. Each pair of sessions gives
equal keyframes, landmarks, edges and per-tick
LM iterations, and trajectories and landmark positions within 1e-9.
``--xla-trace DIR`` runs the port's session under ``torch.profiler`` and
writes ``DIR/trace.json``.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

import jax_golden
from semantic_slam_tpu_torch import cli as tcli
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.utils.profiling import TRACE_FILE
from test_e2e import e2e_config
from test_torch_lifecycle import assert_same_session, to_port
from test_torch_lifecycle import run as run_cli
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

PROFILE = "torch_breadth"
PROFILE_FIT = "torch_breadth_fitness"


def fitness_config():
    cfg = e2e_config()
    return cfg.replace(information=dataclasses.replace(cfg.information, use_const_inf_matrix=False))


PROFILES = {PROFILE: e2e_config, PROFILE_FIT: fitness_config}
LOG = dict(seed=7, n_steps=150, sensor_every=6, H=120, W=160, loops=1.0)


@pytest.fixture(scope="module")
def profiles():
    with pytest.MonkeyPatch.context() as mp:
        for name, cfg in PROFILES.items():
            mp.setitem(tcfg.PROFILES, name, to_port(cfg()))
        yield


def save_log(out_dir, log) -> str:
    path = os.path.join(out_dir, "log.npz")
    treplay.save_log(path, log)
    return path


@pytest.fixture(scope="module")
def log_path(tmp_path_factory):
    log = tsynth.make_synthetic_log(**LOG)
    return save_log(str(tmp_path_factory.mktemp("breadth")), log), log


def run(pkg: str, out: str, log: str, profile: str, *flags: str) -> str:
    return run_cli(pkg, out, log, *flags, profile=profile)


FLAGS = {
    "precond tridiag": (PROFILE, ["--solver", "pcg", "--precond", "tridiag"]),
    "adaptive-normals": (PROFILE, ["--adaptive-normals"]),
    "ingest-window 4": (PROFILE, ["--ingest-window", "4"]),
    "fitness information": (PROFILE_FIT, []),
}


def jax_cli(configs: dict, log, profile: str, flags) -> dict:
    """The JAX CLI's output directory for ``log`` under the profile of
    ``configs`` named ``profile`` and ``flags``; a tridiag session under
    ``SLAM_SOLVER_IMPL=soa`` (the JAX engine's resident SoA loop off the TPU,
    where its default is the per-pose ELL PCG; the dispatch is read when a
    program traces)."""
    import jax

    from semantic_slam_tpu import config as jcfg

    tridiag = "tridiag" in flags
    with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
        for name, cfg in configs.items():
            mp.setitem(jcfg.PROFILES, name, cfg)
        if tridiag:
            mp.setenv("SLAM_SOLVER_IMPL", "soa")
            jax.clear_caches()
        out = os.path.join(tmp, "jax")
        run("jax", out, save_log(tmp, log), profile, *flags)
        files = jax_golden.read_dir(out, skip=(".ply", "vio_pose.txt", "gt_pose.txt"))
    if tridiag:
        jax.clear_caches()  # the programs traced under the soa route
    return files


# the JAX CLI's output directories, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_breadth_cli", tol=1e-9)


@pytest.fixture(scope="module", params=sorted(FLAGS))
def flagged(request, profiles, log_path, tmp_path_factory):
    (path, log), (profile, flags) = log_path, FLAGS[request.param]
    tmp = str(tmp_path_factory.mktemp("flags"))
    configs = {name: cfg() for name, cfg in PROFILES.items()}
    out = {"jax": jax_golden.write_dir(REF(jax_cli, configs, log, profile, flags), os.path.join(tmp, "jax")),
           "port": run("port", os.path.join(tmp, "port"), path, profile, *flags)}
    return out, request.param


def test_flag_sessions_equal_jax(flagged):
    out, name = flagged
    summary, stats = assert_same_session(out["jax"], out["port"])
    assert any(s["iterations"] > 0 for s in stats), name
    if name.startswith("ingest"):
        per_tick = sum(1 for _ in open(os.path.join(out["port"], "stats.jsonl")))
        assert per_tick < summary["keyframes"]  # one optimize a window


def test_flag_sessions_ate(flagged):
    """Both packages' ATE agree and are finite."""
    out, name = flagged
    j, t = (json.load(open(os.path.join(out[p], "summary.json"))) for p in ("jax", "port"))
    assert np.isfinite(t["ate_rmse_optimized"]), name
    np.testing.assert_allclose(t["ate_rmse_optimized"], j["ate_rmse_optimized"], rtol=1e-9, atol=1e-12)


def test_parser_takes_the_jax_flags():
    args = tcli.build_parser().parse_args(["run", "--log", "x.npz", "--precond", "tridiag", "--ingest-window", "8",
                                           "--adaptive-normals", "--xla-trace", "tr"])
    cfg = tcli.make_config(args)
    assert cfg.solver.pcg_precond == "tridiag" and cfg.solver.ingest_window == 8
    assert cfg.segmentation.adaptive_normals and args.xla_trace == "tr"
    d = tcli.make_config(tcli.build_parser().parse_args(["run", "--log", "x.npz"]))
    assert d.solver.pcg_precond == "jacobi" and d.solver.ingest_window == 1 and not d.segmentation.adaptive_normals


def test_xla_trace_writes_trace(profiles, log_path, tmp_path):
    out = run("port", str(tmp_path / "out"), log_path[0], PROFILE, "--xla-trace", str(tmp_path / "trace"),
              "--max-keyframes", "32")
    trace = json.load(open(tmp_path / "trace" / TRACE_FILE))
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("cumsum" in n for n in names)  # the frontend's integral images ran inside it
    assert os.path.exists(os.path.join(out, "summary.json"))
