"""The metric arithmetic, held to hand-worked cases: the p95 over all ticks,
the keyframes a window's ticks complete, the idle union, the per-layer
readers, and ATE over a fixed keyframe set."""

import types

import numpy as np
import pytest
import torch

from slam_bench import feeder, peaks, registry, run, scene, trace
from slam_bench.record import Record


def test_p95_over_all_ticks():
    ticks = [float(v) for v in range(1, 101)]
    # rank 0.95 * 99 = 94.05 between the 95th (95) and 96th (96) values
    assert run.p95(ticks) == pytest.approx(95.05)
    assert run.p95([7.0]) == 7.0


def test_idle_union():
    assert trace.busy_us([(0, 10), (5, 15), (20, 25)]) == 20
    rec = Record(window_s=100e-6, ticks=[], ops=[("k(", 0, 10), ("k(", 5, 15), ("Memcpy HtoD", 20, 25)],
                 spans={}, cfg=None)
    assert rec.idle_share() == pytest.approx(0.8)


def _rec(**kw):
    base = dict(window_s=1.0, ticks=[{"iters": 2}, {"iters": 0}, {"iters": 1}], ops=[], spans={}, cfg=None)
    base.update(kw)
    return Record(**base)


def _span(ms, **info):
    return dict(t0=0, t1=int(ms * 1e6), s=ms / 1e3, **info)


def test_spans_read_the_device_only_after_the_window():
    sp = trace.Spans(on_card=False)
    seg = sp._wrap("segment", lambda **kw: "out")
    assert seg(class_ids=torch.tensor([0, 2, -1]), boxes=torch.zeros(3, 4)) == "out"
    (c,) = sp.spans["segment"]
    assert isinstance(c["detections"], torch.Tensor)  # read in resolve, not inside the window
    sp.resolve()
    assert c["detections"] == 2 and c["rows"] == 1
    assert c["s"] == pytest.approx((c["t1"] - c["t0"]) / 1e9)


def test_per_layer_readers_by_hand():
    r = registry.metric_reader
    rec = _rec(ops=[("a(", 0, 1), ("b(", 1, 2), ("c(", 2, 3), ("Memset (Device)", 3, 4)])
    assert r("kernels_per_tick").read(rec) == pytest.approx(3 / 2)
    rec = _rec(spans={"frontend.window": [_span(10.0, rows=8)], "frontend.keyframe": [_span(2.0)]})
    assert r("frontend_ms.window").read(rec) == pytest.approx(12.0 / 9)
    assert r("frontend_ms.live").read(rec) == pytest.approx(2.0)
    rec = _rec(spans={"optimize": [_span(20.0), _span(10.0)]})
    assert r("lm_ms_per_iter.dense").read(rec) == pytest.approx(10.0)
    rec = _rec(spans={"marginalize": [_span(4.0), _span(6.0)]})
    assert r("marginalize_ms").read(rec) == pytest.approx(5.0)
    assert r("marginalize_ms").read(_rec()) is None
    assert r("idle_share.live").read(_rec()) is None


def test_k5_roofline_by_hand():
    seg = types.SimpleNamespace(crop_height=4, crop_width=5, num_hypotheses=3, max_planes_per_detection=2)
    cfg = types.SimpleNamespace(segmentation=seg)
    # one call, 2 real detections: per round 11 * 2 * 20 * 3 = 1320 flops and
    # 2 * 20 * 25 + 2 * 3 * 16 + 2 * 3 * 4 = 1120 bytes; the bytes bound
    bound = 2 * max(1320 / peaks.FP32_FLOPS, 1120 / peaks.HBM_BYTES_S)
    rec = _rec(cfg=cfg, spans={"segment": [_span(1.0, detections=2)]}, ops=[("void score_kernel(int)", 0.0, 2.0)])
    assert registry.metric_reader("k5_roofline.window").read(rec) == pytest.approx(100 * bound / 2e-6)
    assert registry.metric_reader("k5_roofline.live").read(rec) == pytest.approx(100 * bound / 2e-6)


def test_pcg_roofline_by_hand():
    counts = {"poses": 3, "landmarks": 2, "odom_edges": 2, "lm_edges": 4}
    launches = {"fused_linearize": 1, "obs_linearize": 0, "resident_chi2": 2, "resident_solve": 1}
    rec = _rec(spans={"lm.pcg": [_span(1.0, counts=counts, launches=launches)]},
               ops=[("lin_slots_kernel(x)", 0.0, 1.0), ("solve_cluster_kernel(y)", 1.0, 3.0)])
    b = peaks.bound_s
    # hand counts of flops.k1-k3 for this graph (see test_bench_flops); K4's
    # kernel is not K1-K3's device time
    want = b(2244, 1220) + b(5864, 1440) + 2 * b(678, 696)
    assert registry.metric_reader("pcg_kernels_roofline").read(rec) == pytest.approx(100 * want / 1e-6)


def test_k4_ms_per_launch_by_hand():
    launches = {"fused_linearize": 1, "obs_linearize": 0, "resident_chi2": 2, "resident_solve": 3}
    rec = _rec(spans={"lm.pcg": [_span(1.0, launches=launches), _span(1.0, launches=launches)]},
               ops=[("solve_cluster_kernel(y)", 0.0, 4.0), ("solve_grid_kernel(y)", 4.0, 6.0),
                    ("lin_slots_kernel(x)", 6.0, 9.0)])
    # 6 us of K4 over 6 launches
    assert registry.metric_reader("k4_ms_per_launch").read(rec) == pytest.approx(1e-3)
    assert registry.metric_reader("k4_ms_per_launch").read(_rec()) is None


class _Engine:
    """Keyframes at the stamps of a stream, with estimates it is given."""

    def __init__(self, stamps, est):
        self.keyframes = [types.SimpleNamespace(stamp=t) for t in stamps]
        self._est = dict(zip(stamps, est))

    def get_keyframe_pose(self, kf):
        return self._est[kf.stamp]


def test_ate_over_a_fixed_keyframe_set():
    n = 12
    gt = np.zeros((n, 7))
    gt[:, 0], gt[:, 3] = np.arange(n, dtype=float), 1.0
    st = types.SimpleNamespace(odom_t=np.arange(n) / 10.0, gt=gt)
    est = gt.copy()
    est[:, 1] = 5.0  # a rigid shift: no error after alignment
    est[6:, 2] = 3.0  # keyframes outside the set are far off
    eng = _Engine(st.odom_t, est)
    assert feeder.keyframe_ate_cm(eng, st, eng.keyframes[:6]) == pytest.approx(0.0, abs=1e-9)
    # two of six points 0.1 m along the line, opposite ways (zero mean): no
    # rigid motion of collinear points undoes an error along their line at
    # first order, so RMSE = 0.1 * sqrt(2 / 6)
    est2 = gt.copy()
    est2[1, 0] += 0.1
    est2[4, 0] -= 0.1
    eng2 = _Engine(st.odom_t, est2)
    got = feeder.keyframe_ate_cm(eng2, st, eng2.keyframes[:6])
    assert got == pytest.approx(100 * 0.1 * np.sqrt(2 / 6), rel=1e-6)


class _FakeEngine:
    """Takes a keyframe at every VIO message; a tick completes all queued."""

    def __init__(self):
        self.keyframe_queue, self.keyframes, self.stats_history, self._kf_base = [], [], [], 0

    def set_point_cloud(self, *a):
        pass

    def set_detections(self, *a):
        pass

    def vio_callback(self, t, pose, cov):
        self.keyframe_queue.append(types.SimpleNamespace(stamp=t, boxes=None))

    def run(self):
        if not self.keyframe_queue:
            return False
        self.keyframes += self.keyframe_queue
        self.keyframe_queue = []
        self.stats_history.append({"iterations": 3})
        return True


def test_feeder_counts_every_keyframe_a_tick_completes():
    n = 9
    cam = scene.Camera(2, 2, 1.0, 1.0, 1.0, 1.0, 5.0)
    st = scene.Stream(odom_t=np.arange(n) / 30.0, odom=np.zeros((n, 7)), gt=np.zeros((n, 7)),
                      sensor_step=np.arange(0, n, 3), frame_of=np.zeros(3, int), dets=[None] * 3,
                      frames=[(np.zeros((2, 2, 3), np.float32), np.zeros((2, 2), bool))], camera=cam)
    f = feeder.Feeder(st)
    ticks = list(f.ticks(_FakeEngine()))
    assert sum(t["kf"] for t in ticks) == n
    assert all(t["iters"] == 3 and t["ms"] >= 0 for t in ticks)
    # a keyframe records the frame it took: the latest one delivered
    assert f.source[3 / 30.0] == (1, None)
