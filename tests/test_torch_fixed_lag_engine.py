"""Fixed-lag sessions of the port's engine against the JAX engine, on the CPU.

One short synthetic session (240 steps, seed 3, 96x128 clouds) replayed
through both engines in f64 with a fixed-lag window of 8 keyframes and a
chunk of 8 (so the graph marginalizes and compacts), Mahalanobis gating (the
prior-aware marginals run every optimizing tick), with the dense Schur LM and
with ``linear_solver="pcg"``: the port's resident loop, and its row-range
loop with the crossover lowered to 0 (``soa_dist.TILED_FROM_K``), against the
JAX engine's PCG (its sessions stored: ``REF``, ``tests/jax_golden.py``). Keyframes, ``_kf_base``, edge counts, landmark ids and LM
iterations must be equal; the trajectory (archived and active keyframes) and
the landmark covariances agree within 1e-6, chi2 within 1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest

import jax_golden
from semantic_slam_tpu.config import AssociationConfig, CapacityConfig
from semantic_slam_tpu.io import replay as jreplay
from semantic_slam_tpu.io import synthetic as jsynth
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from semantic_slam_tpu_torch.solver import soa_dist as tsd
from test_e2e import e2e_config
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)


WINDOW, CHUNK = 8, 8


def fixed_lag_config(solver: str):
    cfg = e2e_config().replace(
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0,
                                      land_noise_low=0.4),
        capacity=CapacityConfig(max_keyframes=16, max_landmarks=16, max_odom_edges=16, max_landmark_edges=128,
                                max_detections_per_frame=4),
    )
    return cfg.replace(solver=dataclasses.replace(cfg.solver, fixed_lag_window=WINDOW, fixed_lag_chunk=CHUNK,
                                                  linear_solver=solver))


LOG = dict(seed=3, n_steps=240, sensor_every=5, drift_noise=0.008, H=96, W=128)
SOLVERS = ("dense", "pcg")


def jax_session(cfg, log) -> dict:
    from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine

    je = JaxEngine(cfg)
    jreplay.replay(log, je)
    return jax_golden.engine_outputs(je)


# the JAX package's sessions, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_fixed_lag_engine", tol=1e-6)


@pytest.fixture(scope="module")
def session_log():
    return jsynth.make_synthetic_log(**LOG)


@pytest.fixture(scope="module", params=SOLVERS)
def sessions(request, session_log):
    """The JAX engine's stored session and the port's, on the CPU, f64; for
    pcg the port's resident loop and its row-range loop (the crossover
    lowered to 0)."""
    cfg = fixed_lag_config(request.param)
    je = jax_golden.EngineSnapshot(REF(jax_session, cfg, session_log))
    ports = {}
    for loop, tiled_from in (("resident", tsd.TILED_FROM_K), ("row-range", 0)):
        if request.param == "dense" and loop == "row-range":
            continue
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsd, "TILED_FROM_K", tiled_from)
            te = TorchEngine(cfg, device="cpu")
            jreplay.replay(session_log, te)
        ports[loop] = te
    return je, ports


def test_session_same_map(sessions):
    je, ports = sessions
    assert je._kf_base >= WINDOW and len(je.archived_poses) == je._kf_base
    for loop, te in ports.items():
        assert len(te.keyframes) == len(je.keyframes), loop
        assert te._kf_base == je._kf_base and te._n_poses == je._n_poses < WINDOW + CHUNK, loop
        for f in ("num_poses", "num_landmarks", "num_odom", "num_lme"):
            assert int(getattr(te.graph, f)) == int(getattr(je.graph, f)), (loop, f)
        n = int(je.graph.num_lme)
        np.testing.assert_array_equal(te.graph.lme_l[:n].numpy(), np.asarray(je.graph.lme_l[:n]))
        np.testing.assert_array_equal(te.graph.lme_k[:n].numpy(), np.asarray(je.graph.lme_k[:n]))
        assert int(te.table.count) == int(je.table.count) > 0
        assert [s["iterations"] for s in te.stats_history] == [s["iterations"] for s in je.stats_history], loop


def test_session_same_trajectory(sessions):
    je, ports = sessions
    want = je.get_keyframe_poses()
    assert want.shape == (len(je.keyframes), 7)
    for loop, te in ports.items():
        np.testing.assert_allclose(te.get_keyframe_poses(), want, atol=1e-6, rtol=0, err_msg=loop)
        for kf in (te.keyframes[0], te.keyframes[-1]):  # archived, active
            np.testing.assert_allclose(te.get_keyframe_pose(kf), want[kf.node_idx], atol=1e-6, rtol=0)
        n = int(je.table.count)
        np.testing.assert_allclose(te.table.cov[:n].numpy(), np.asarray(je.table.cov[:n]), atol=1e-6, rtol=0)
        for a, b in zip(te.stats_history, je.stats_history):
            np.testing.assert_allclose(a["chi2_final"], b["chi2_final"], rtol=1e-6, atol=1e-9)
