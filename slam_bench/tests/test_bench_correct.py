"""``correct`` at a size the CPU runs: a sound run is correct; the control
(the reference at bfloat16 in the program's place) and each fault that a
cell can have, planted under the timed path, come out not correct against
the cell's own limits. The harness's look for a card is skipped
(``run_cell`` on the CPU, the kernels' plain versions)."""

import dataclasses
import functools

import torch

from semantic_slam_tpu_torch.runtime import engine as engine_mod
from semantic_slam_tpu_torch.solver import fixed_lag, lm
from slam_bench import check
from slam_bench.tests import tiny


def test_sound_run_is_correct():
    res = tiny.run_tiny("indoor7_160.live")
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = tiny.run_tiny("indoor7_160.live", judge_low=True)
    assert res["correct"]
    ok, shown = check.verdict(res["control"], check.load_limits("indoor7_160.live"))
    assert not ok, shown


def _with_solve(monkeypatch, alter):
    real = lm.lm_optimize

    @functools.wraps(real)
    def faulty(g, *a, **kw):
        out = real(g, *a, **kw)
        return (alter(g, out[0]),) + tuple(out[1:])

    monkeypatch.setattr(lm, "lm_optimize", faulty)


def test_step_that_returns_its_state_unchanged(monkeypatch):
    _with_solve(monkeypatch, lambda before, after: before)
    res = tiny.run_tiny("indoor7_160.live")
    assert not res["correct"], res["checks"]


def test_pose_altered_where_it_is_produced(monkeypatch):
    def nudge(before, after):
        p = after.poses.clone()
        p[1:, 0] += 0.01  # 1 cm on every free pose
        return dataclasses.replace(after, poses=p)

    _with_solve(monkeypatch, nudge)
    res = tiny.run_tiny("indoor7_160.live")
    assert not res["correct"], res["checks"]


def test_plane_altered_where_it_is_produced(monkeypatch):
    real = engine_mod._segment_only

    @functools.wraps(real)
    def shifted(*a, **kw):
        dets = real(*a, **kw)
        return dets._replace(normal_cam=dets.normal_cam + torch.tensor([0.0, 0.0, 0.0, 0.05]))

    monkeypatch.setattr(engine_mod, "_segment_only", shifted)
    res = tiny.run_tiny("indoor7_160.live")
    assert not res["correct"], res["checks"]


def test_half_the_window_left_out(monkeypatch):
    real = engine_mod._segment_only

    @functools.wraps(real)
    def half(*a, **kw):
        dets = real(*a, **kw)
        if dets.valid.dim() == 2:
            keep = torch.arange(dets.valid.shape[0]) < (dets.valid.shape[0] + 1) // 2
            dets = dets._replace(valid=dets.valid & keep[:, None])
        return dets

    monkeypatch.setattr(engine_mod, "_segment_only", half)
    res = tiny.run_tiny("indoor7.window8", seconds=2.0)
    assert not res["correct"], res["checks"]


def test_marginalization_that_keeps_the_old_prior(monkeypatch):
    real = fixed_lag.marginalize

    @functools.wraps(real)
    def stale(g, prior, drop):
        g2, _, nb = real(g, prior, drop)
        return g2, prior, nb

    monkeypatch.setattr(fixed_lag, "marginalize", stale)
    res = tiny.run_tiny("kitti00.fixedlag64", seconds=4.0)
    assert res["numbers"]["prior_gap"] is not None
    assert not res["correct"], res["checks"]


def test_centroid_altered_where_it_is_produced(monkeypatch):
    real = engine_mod._segment_only

    @functools.wraps(real)
    def moved(*a, **kw):
        dets = real(*a, **kw)
        return dets._replace(pose_cam=dets.pose_cam + torch.tensor([0.05, 0.0, 0.0]))

    monkeypatch.setattr(engine_mod, "_segment_only", moved)
    res = tiny.run_tiny("indoor7_160.live")
    assert res["numbers"]["centroid_gap_m"] is not None
    assert not res["correct"], res["checks"]


def test_landmark_edge_altered_at_ingest(monkeypatch):
    real = engine_mod._ingest_landmarks

    @functools.wraps(real)
    def shifted(graph, valid, lm_id, is_new, local, *a):
        return real(graph, valid, lm_id, is_new, local + torch.tensor([0.0, 0.0, 0.05]), *a)

    monkeypatch.setattr(engine_mod, "_ingest_landmarks", shifted)
    res = tiny.run_tiny("indoor7_160.live")
    assert res["numbers"]["ingest_gap_m"] is not None
    assert not res["correct"], res["checks"]


def test_odometry_edge_altered_at_ingest(monkeypatch):
    real = engine_mod._ingest_keyframes_batch

    @functools.wraps(real)
    def shifted(*a, **kw):
        g = real(*a, **kw)
        return g.replace(odom_meas=g.odom_meas + torch.tensor([0.01, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]))

    monkeypatch.setattr(engine_mod, "_ingest_keyframes_batch", shifted)
    res = tiny.run_tiny("indoor7_160.live")
    assert res["numbers"]["odom_gap"] is not None
    assert not res["correct"], res["checks"]


def test_drive_without_a_marginalization_is_not_correct():
    limits = check.load_limits("kitti00.fixedlag64")
    ok, shown = check.verdict({"state_gap_m": 0.0, "det_miss": 0, "prior_gap": None}, limits)
    assert not ok, shown
    assert check.verdict({"state_gap_m": 0.0, "det_miss": 0, "prior_gap": 0.0}, limits)[0]
