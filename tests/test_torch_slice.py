"""The port's slice end to end against the JAX engine: one short synthetic
session replayed through both engines on the CPU, in f64.

Two configurations: ``tests/test_e2e.py``'s lowered-threshold config
(Euclidean gating) on the session's u16 depth images (backprojected on the
device), replayed without the tick grid so that every tick takes a batch of
up to 10 keyframes (in both engines a run of detection keyframes is one
window: its frontend in one call, association row by row); and its Mahalanobis variant on the XYZ clouds, one
keyframe per tick, at ``--max-keyframes 8``
capacities, which forces capacity growth, runs the marginal recovery every
optimizing tick, seeds the first pose and landmark (``add_first_lan``) and
makes a keyframe of every detection frame (``update_key_using_det``).
The Mahalanobis session runs twice: with the dense Schur LM and with
``linear_solver="pcg"``, where the port runs its SoA Schur-PCG solver (the
plain versions of kernels K1-K4 on the CPU) and the JAX engine on the CPU
its ELL PCG solver (``pcg.lm_optimize_pcg``): the same math up to summation
order. Each session ends with ``finalize()``. The JAX engine's sessions are
stored (``REF``, ``tests/jax_golden.py``); the port's run live. Counts,
landmark ids and per-tick LM iterations must be equal; keyframe poses agree
to 1e-6.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.config import AssociationConfig, CapacityConfig
from semantic_slam_tpu.io import replay as replay_mod
from semantic_slam_tpu.io import synthetic as synth_mod
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_e2e import e2e_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def maha_grow_config():
    return e2e_config().replace(
        add_first_lan=True,
        update_key_using_det=True,
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4),
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=16, max_odom_edges=8,
                                max_landmark_edges=32, max_detections_per_frame=4),
    )


def maha_grow_pcg_config():
    cfg = maha_grow_config()
    return cfg.replace(solver=dataclasses.replace(cfg.solver, linear_solver="pcg"))


CONFIGS = {"e2e-euclid-depth": e2e_config, "maha-grow": maha_grow_config, "maha-grow-pcg": maha_grow_pcg_config}
LOG = dict(seed=3, n_steps=120, sensor_every=5, drift_noise=0.008, H=120, W=160)


def session(name: str, engine, params=LOG):
    """``engine`` after the session ``name`` (on the log of ``params``) and
    its ``finalize()``."""
    log = synth_mod.make_synthetic_log(**params)
    if name.endswith("depth"):
        log = synth_mod.clouds_to_depth(log)
        assert log.depths and not log.clouds
    replay_mod.replay(log, engine, run_ticks=not name.endswith("depth"))
    assert engine.finalize()  # one forced optimize over the final graph
    return engine


def jax_session(name: str, cfg, params) -> dict:
    from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine

    return jax_golden.engine_outputs(session(name, JaxEngine(cfg), params))


# the JAX package's sessions, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_slice", tol=1e-6)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engines(request):
    """The JAX engine's stored session and the port's live one."""
    cfg = CONFIGS[request.param]()
    assert cfg.solver.dtype == "float64"
    je = jax_golden.EngineSnapshot(REF(jax_session, request.param, cfg, LOG))
    return request.param, je, session(request.param, TorchEngine(cfg, device="cpu"))


def test_same_map(engines):
    name, je, te = engines
    assert len(te.keyframes) == len(je.keyframes) > 8
    assert int(te.table.count) == int(je.table.count) > 0
    for f in ("num_poses", "num_landmarks", "num_odom", "num_lme"):
        assert int(getattr(te.graph, f)) == int(getattr(je.graph, f)), f
    n_lme = int(je.graph.num_lme)
    np.testing.assert_array_equal(te.graph.lme_l[:n_lme].numpy(), np.asarray(je.graph.lme_l[:n_lme]))
    np.testing.assert_array_equal(te.graph.lme_k[:n_lme].numpy(), np.asarray(je.graph.lme_k[:n_lme]))
    n = int(je.table.count)
    np.testing.assert_array_equal(te.table.class_id[:n].numpy(), np.asarray(je.table.class_id[:n]))
    if name.endswith("depth"):
        assert len(te.stats_history) < len(te.keyframes) // 2  # multi-keyframe ticks
    if name.startswith("maha-grow"):
        assert te.graph.max_poses == je.graph.max_poses > 8  # grew
        np.testing.assert_allclose(te.table.cov[:n].numpy(), np.asarray(je.table.cov[:n]), atol=1e-6)


def test_same_ticks(engines):
    _, je, te = engines
    assert [s["iterations"] for s in te.stats_history] == [s["iterations"] for s in je.stats_history]
    assert any(s["iterations"] > 0 for s in te.stats_history)
    for a, b in zip(te.stats_history, je.stats_history):
        np.testing.assert_allclose(a["chi2_final"], b["chi2_final"], rtol=1e-6, atol=1e-9)


def test_same_trajectory(engines):
    _, je, te = engines
    np.testing.assert_allclose(te.get_keyframe_poses(), je.get_keyframe_poses(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(te.robot_pose, je.robot_pose, atol=1e-6, rtol=0)
    lt, lj = te.get_mapped_landmarks(), je.get_mapped_landmarks()
    for k in ("pose", "covariance"):
        np.testing.assert_allclose(lt[k], lj[k], atol=1e-6, rtol=0)
    # the stored plane normal is up to sign: a plane facing the camera head-on
    # has cam-frame normal x = 0 (+-1e-30 after rounding), where the
    # reference's ``m[0] > 0`` flip rule is a tie that rounding decides
    sign = np.where(np.sum(lt["normal"] * lj["normal"], axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(lt["normal"] * sign, lj["normal"], atol=1e-6, rtol=0)


def test_cuda_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(e2e_config(), device="cuda")


def test_cli_run_never_imports_jax(tmp_path):
    """``cli run`` of the port on the CPU, in a fresh interpreter: it writes
    the JAX CLI's outputs and leaves ``jax`` out of ``sys.modules``."""
    small = synth_mod.make_synthetic_log(seed=1, n_steps=60, sensor_every=6, H=60, W=80)
    log_path = str(tmp_path / "log.npz")
    replay_mod.save_log(log_path, small)
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "from semantic_slam_tpu_torch.cli import main\n"
        f"main(['run', '--log', {log_path!r}, '--profile', 'yolo_detector', '--out', {str(out)!r},"
        " '--device', 'cpu', '--compute-ate', '--max-keyframes', '8', '--crop-size', '32'])\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["keyframes"] > 0 and np.isfinite(summary["ate_rmse_optimized"])
    for f in ("stats.jsonl", "robot_pose.txt", "vio_pose.txt", "gt_pose.txt", "landmarks.json", "keyframes.ply"):
        assert (out / f).exists(), f
