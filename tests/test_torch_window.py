"""Window ingest (``ingest_window > 1``) through the port's engine against
the JAX engine's window sessions, on the CPU in f64.

The engine pools W keyframes a tick; each run of detection keyframes that
share a sensor takes one frontend call (``segment_window``: one plane
extraction over B*D detections), association and landmark ingest stay
sequential, and ``finalize()`` flushes the last, partial window. Sessions
(120x160 clouds, ``tests/test_e2e.py``'s config):

  * ``w3-fitness-growth``: W=3, fitness-weighted odometry information
    (``use_const_inf_matrix=False``, one matrix a row), capacities that grow
    mid-window;
  * ``w8-maha-depth``: W=8 on the u16 depth images, Mahalanobis gating,
    the synthetic first landmark, detection-triggered keyframes and
    capacity growth; the session ends on a partial window;
  * ``w4-planes``: W=4 with plane landmarks (per keyframe inside the flush,
    as in the JAX engine).

Each is held to the JAX engine's session, stored (``REF``,
``tests/jax_golden.py``; the port's sessions run live): equal keyframes, landmarks,
edges, landmark ids and per-tick LM iterations, poses within 1e-9 (and
odometry information within 1e-12). The port's window sessions are also
held to its own per-tick sessions within the JAX tests' 5e-4 (the cadence
moves the optimum only by the solver's tolerance).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.config import AssociationConfig, CapacityConfig
from semantic_slam_tpu.io import replay as replay_mod
from semantic_slam_tpu.io import synthetic as synth_mod
from semantic_slam_tpu_torch.frontend import segmentation as tseg
from semantic_slam_tpu_torch.runtime import engine as teng
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_e2e import e2e_config
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)


def _solver(cfg, **kw):
    return cfg.replace(solver=dataclasses.replace(cfg.solver, **kw))


def w3_fitness_growth():
    cfg = e2e_config().replace(
        information=dataclasses.replace(e2e_config().information, use_const_inf_matrix=False),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16, max_odom_edges=64, max_landmark_edges=256,
                                max_detections_per_frame=4, initial_keyframes=8, initial_odom_edges=8,
                                initial_landmarks=8, initial_landmark_edges=16),
    )
    return _solver(cfg, ingest_window=3)


def w8_maha_depth():
    cfg = e2e_config().replace(
        add_first_lan=True, update_key_using_det=True,
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4),
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=16, max_odom_edges=8, max_landmark_edges=32,
                                max_detections_per_frame=4),
    )
    return _solver(cfg, ingest_window=8)


def w4_planes():
    return _solver(e2e_config().replace(use_plane_landmarks=True), ingest_window=4)


CONFIGS = {"w3-fitness-growth": w3_fitness_growth, "w8-maha-depth": w8_maha_depth, "w4-planes": w4_planes}
LOG = dict(seed=3, sensor_every=5, drift_noise=0.008, H=120, W=160)
PROGRAM_ROWS = (2, 5)


def _log(name, n_steps=120):
    log = synth_mod.make_synthetic_log(n_steps=n_steps, **LOG)
    return synth_mod.clouds_to_depth(log) if name.endswith("depth") else log


def _session(engine, log):
    replay_mod.replay(log, engine)
    engine.finalize()
    return engine


def jax_window_program(B: int):
    """The JAX engine's ``_process_keyframes_window`` (padded to its
    power-of-two bucket) on ``parallel/window_inputs.py``'s synthetic run of
    ``B`` rows, f64."""
    import jax.numpy as jnp

    from semantic_slam_tpu.parallel.window_inputs import make_window_inputs as jmake
    from semantic_slam_tpu.runtime import engine as jeng

    jg, jt, args, st = jmake(B, 1, jnp.float64)
    (odoms, row_valid, prev, has_prev, info6, points, valid, boxes, cids, probs, xyz, cam, *rest) = args
    return jeng._process_keyframes_window(
        jg, jt, odoms, row_valid, jnp.asarray(B - 1, jnp.int32), prev, has_prev, info6, points, valid,
        jnp.zeros((3, 3), points.dtype), jnp.asarray(1e-3, points.dtype), boxes, cids, probs, xyz, cam, *rest,
        samp_h=st["samp_h"], samp_w=st["samp_w"], max_planes=st["max_planes"], num_hypotheses=st["num_hypotheses"],
        smoothing_size=st["smoothing_size"], strict_frames=st["strict_frames"],
        use_rtabmap_offset=st["use_rtabmap_offset"], depth_input=False, adaptive_normals=False)


# what the tests read of the JAX engine's session
READ = ("graph.num_poses", "graph.num_landmarks", "graph.num_odom", "graph.num_lme", "graph.lme_k", "graph.lme_l",
        "graph.odom_info", "table.count", "plane_nodes.num_pe", "keyframe_poses", "robot_pose")


def jax_session(cfg, log, keep) -> dict:
    """The JAX engine's window session of ``log``: what the tests read of it."""
    from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine

    return jax_golden.engine_outputs(_session(JaxEngine(cfg), log), keep=keep)


def jax_program(B: int) -> dict:
    g, t, d = jax_window_program(B)
    return {**{f"graph.{k}": np.asarray(v) for k, v in g._asdict().items()}, "table.count": np.asarray(t.count),
            "dets.valid": np.asarray(d.valid), "dets.world_pose": np.asarray(d.world_pose)}


# the JAX package's results, stored (tests/jax_golden.py); the odometry
# information is held to 1e-12, the window program's outputs exactly
REF = jax_golden.Recorded("torch_window", tol=1e-9)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def sessions(request):
    """The JAX engine's stored window session; the port's window session
    (its window program's calls recorded) and its per-tick session."""
    cfg, log = CONFIGS[request.param](), _log(request.param)
    calls = []
    orig = teng._process_keyframes_window

    def recording(*a, **kw):
        calls.append(kw["odoms"].shape[0])
        return orig(*a, **kw)

    teng._process_keyframes_window = recording
    try:
        te = _session(TorchEngine(cfg, device="cpu"), log)
    finally:
        teng._process_keyframes_window = orig
    je = jax_golden.EngineSnapshot(REF(jax_session, cfg, log, READ, tol={"graph.odom_info": 1e-12}))
    per_tick = _session(TorchEngine(_solver(cfg, ingest_window=1), device="cpu"), log)
    return request.param, je, te, per_tick, calls


def test_same_map(sessions):
    name, je, te, _, calls = sessions
    assert len(te.keyframes) == len(je.keyframes) > 8
    assert int(te.table.count) == int(je.table.count) > 0
    for f in ("num_poses", "num_landmarks", "num_odom", "num_lme"):
        assert int(getattr(te.graph, f)) == int(getattr(je.graph, f)), f
    n = int(je.graph.num_lme)
    np.testing.assert_array_equal(te.graph.lme_l[:n].numpy(), np.asarray(je.graph.lme_l[:n]))
    np.testing.assert_array_equal(te.graph.lme_k[:n].numpy(), np.asarray(je.graph.lme_k[:n]))
    if name.endswith("planes"):
        assert not calls  # plane sessions take their keyframes one by one
        assert int(te.plane_nodes.num_pe) == int(je.plane_nodes.num_pe) > 0
    else:
        assert calls and max(calls) >= 2  # runs of detection keyframes shared a frontend call


def test_same_ticks(sessions):
    _, je, te, per_tick, _ = sessions
    assert [s["iterations"] for s in te.stats_history] == [s["iterations"] for s in je.stats_history]
    assert len(te.stats_history) < len(per_tick.stats_history)  # one optimize a window
    for a, b in zip(te.stats_history, je.stats_history):
        np.testing.assert_allclose(a["chi2_final"], b["chi2_final"], rtol=1e-9, atol=1e-9)


def test_same_trajectory(sessions):
    name, je, te, _, _ = sessions
    np.testing.assert_allclose(te.get_keyframe_poses(), je.get_keyframe_poses(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(te.robot_pose, je.robot_pose, atol=1e-9, rtol=0)
    n = int(je.graph.num_odom)
    np.testing.assert_allclose(te.graph.odom_info[:n].numpy(), np.asarray(je.graph.odom_info[:n]), rtol=1e-12,
                               atol=0)
    if name.startswith("w3-fitness"):
        diag = te.graph.odom_info[:n, 0, 0].numpy()
        assert len(np.unique(diag)) > 2  # one fitness matrix a row


def test_window_matches_per_tick(sessions):
    """The JAX window tests' bound: after ``finalize`` the window session's
    poses are the per-tick session's within 5e-4, with equal counts."""
    name, _, te, per_tick, _ = sessions
    assert len(te.keyframes) == len(per_tick.keyframes)
    assert int(te.table.count) == int(per_tick.table.count)
    if name.endswith("planes"):
        return  # plane BA is sensitive to the cadence (tests/test_ingest_window.py)
    np.testing.assert_allclose(te.get_keyframe_poses(), per_tick.get_keyframe_poses(), atol=5e-4, rtol=0)


def test_partial_window_needs_finalize():
    """A session shorter than one window pools every keyframe until
    ``finalize()`` flushes it (W=32; capacities that hold a window's
    worst-case landmarks, so that nothing grows)."""
    cfg = e2e_config().replace(capacity=CapacityConfig(max_keyframes=64, max_landmarks=256, max_odom_edges=64,
                                                       max_landmark_edges=2048, max_detections_per_frame=4))
    eng = TorchEngine(_solver(cfg, ingest_window=32), device="cpu")
    replay_mod.replay(_log("w", n_steps=70), eng)
    assert len(eng.keyframes) == 0 and len(eng.keyframe_queue) > 0
    assert eng.finalize()
    assert len(eng.keyframe_queue) == 0 and len(eng.keyframes) > 4 and int(eng.table.count) > 0


def test_window_wider_than_the_tick_cap():
    """W above ``max_keyframes_per_update`` wins over it: a flush takes the
    whole window (one stats entry for W keyframes)."""
    cfg = _solver(e2e_config(), ingest_window=12, max_iterations=1)
    assert cfg.capacity.max_keyframes_per_update < 12
    eng = TorchEngine(cfg, device="cpu")
    for i in range(12):
        eng.keyframe_queue.append(teng.KeyframeMeta(stamp=float(i), odom=np.array([0.1 * i, 0, 0, 1, 0, 0, 0]),
                                                    robot_pose=np.array([0.1 * i, 0, 0, 1, 0, 0, 0]),
                                                    accum_distance=0.0, cloud=None, boxes=None, class_ids=None,
                                                    probs=None))
    assert eng.run()
    assert len(eng.keyframes) == 12 and not eng.keyframe_queue and len(eng.stats_history) == 1


def test_window_rows_bound_k5_grid():
    """A window's frontend call holds at most 65535 // D rows, K5's grid
    limit on the detections a launch scores."""
    eng = TorchEngine(e2e_config(), device="cpu")
    D = e2e_config().capacity.max_detections_per_frame
    assert eng._max_window_rows == 65535 // D
    assert eng._max_window_rows * D <= 65535


def test_same_sensor_breaks_runs():
    kf = teng.KeyframeMeta
    base = dict(stamp=0.0, odom=np.zeros(7), robot_pose=np.zeros(7), accum_distance=0.0, boxes=np.zeros((1, 4)),
                class_ids=np.zeros(1, np.int32), probs=np.ones(1))
    xyz = kf(cloud=(np.zeros((4, 5, 3)), np.ones((4, 5), bool)), **base)
    xyz_big = kf(cloud=(np.zeros((6, 5, 3)), np.ones((6, 5), bool)), **base)
    dep = kf(cloud=(np.zeros((4, 5), np.uint16), None), depth_intr=np.array([1.0, 1, 2, 2]), **base)
    dep2 = kf(cloud=(np.zeros((4, 5), np.uint16), None), depth_intr=np.array([1.0, 1, 2, 3]), **base)
    assert teng._same_sensor(xyz, xyz) and teng._same_sensor(dep, dep)
    assert not teng._same_sensor(xyz, xyz_big)
    assert not teng._same_sensor(xyz, dep)
    assert not teng._same_sensor(dep, dep2)


def test_segment_window_batches_k5_once_a_round(monkeypatch):
    """One window's frontend scores all B*D detections in one K5 call a
    round (the wrapper's plain version here, counted)."""
    from semantic_slam_tpu_torch.frontend import planes as tpl

    shapes = []
    orig = tpl.score_hypotheses

    def counting(pts, *a):
        shapes.append(pts.shape[0])
        return orig(pts, *a)

    monkeypatch.setattr(tpl, "score_hypotheses", counting)
    B, D, H, W = 3, 4, 24, 32
    pts = torch.zeros((B, H, W, 3), dtype=torch.float64)
    pts[..., 2] = 2.0
    dets = tseg.segment_window(pts, torch.ones((B, H, W), dtype=torch.bool), torch.zeros((B, D, 4), dtype=torch.float64),
                               torch.full((B, D), -1, dtype=torch.int32), torch.zeros((B, D), dtype=torch.float64),
                               torch.zeros((B, 6), dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64),
                               100.0, 400.0, 0.01, 0.02, 0.99, samp_h=8, samp_w=8, max_planes=2, num_hypotheses=8,
                               smoothing_size=4)
    assert shapes == [B * D] * 2
    assert dets.valid.shape == (B, D * 2)


@pytest.mark.parametrize("B", PROGRAM_ROWS)
def test_window_program_on_window_inputs(B):
    """The window program alone on ``parallel/window_inputs.py``'s synthetic
    run (each package's ``make_window_inputs``, f64): the JAX engine's
    ``_process_keyframes_window`` (padded to its power-of-two bucket;
    stored) and the port's (B rows) give the same graph and table."""
    from semantic_slam_tpu_torch.parallel.window_inputs import make_window_inputs as tmake

    ref = REF(jax_program, B, tol=0.0)
    g1 = jax_golden.EngineSnapshot.state(ref, "graph")
    tg, tt, targs, tst = tmake(B, torch.float64, device="cpu")
    g2, t2, d2 = teng._process_keyframes_window(tg, tt, **targs, **tst)
    assert int(t2.count) == int(ref["table.count"]) > 0
    for f in ("num_poses", "num_landmarks", "num_odom", "num_lme"):
        assert int(getattr(g2, f)) == int(getattr(g1, f)), f
    n, m = int(g1.num_lme), int(g1.num_landmarks)
    np.testing.assert_array_equal(g2.lme_k[:n].numpy(), np.asarray(g1.lme_k[:n]))
    np.testing.assert_array_equal(g2.lme_l[:n].numpy(), np.asarray(g1.lme_l[:n]))
    np.testing.assert_allclose(g2.lme_meas[:n].numpy(), np.asarray(g1.lme_meas[:n]), atol=1e-9, rtol=0)
    np.testing.assert_allclose(g2.landmarks[:m].numpy(), np.asarray(g1.landmarks[:m]), atol=1e-9, rtol=0)
    np.testing.assert_allclose(g2.poses[:B].numpy(), np.asarray(g1.poses[:B]), atol=0, rtol=0)
    # the last row's detections
    np.testing.assert_array_equal(d2.valid.numpy(), ref["dets.valid"])
    np.testing.assert_allclose(d2.world_pose.numpy(), ref["dets.world_pose"], atol=1e-9, rtol=0)


def test_stored_reference_matches_live():
    """The smallest stored window program recomputed by the JAX package:
    the stored file is still what the package computes, in this run."""
    REF.check_live(jax_program, PROGRAM_ROWS[0], tol=0.0)
