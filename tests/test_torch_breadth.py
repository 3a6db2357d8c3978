"""The port's breadth modules against the JAX package, on the CPU in f64
unless stated: fitness information (``solver/information.py``), adaptive
normals and the batched frontend (``frontend/normals.py``,
``frontend/segmentation.py``), the frame fixups (``core/frames.py``),
``plane_bundle_adjust`` (``solver/plane_ba.py``), ``Metrics`` and the
profiler trace (``utils/profiling.py``).

Tolerances: information 1e-12 (f32: the same subsample indices, scores
within 1e-6 relative), normals and plane outputs 1e-9 (prefix sums in
another order than XLA's), frames 1e-12, plane BA 1e-9; masks and indices
exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.core import frames as jfr
from semantic_slam_tpu.core import geometry as jgeo
from semantic_slam_tpu.frontend import normals as jnm
from semantic_slam_tpu.frontend import segmentation as jseg
from semantic_slam_tpu.io import synthetic as synth_mod
from semantic_slam_tpu.solver import information as jinf
from semantic_slam_tpu.solver import plane_ba as jba
from semantic_slam_tpu.utils import profiling as jprof
from semantic_slam_tpu_torch.core import frames as tfr
from semantic_slam_tpu_torch.frontend import normals as tnm
from semantic_slam_tpu_torch.frontend import segmentation as tseg
from semantic_slam_tpu_torch.solver import information as tinf
from semantic_slam_tpu_torch.solver import plane_ba as tba
from semantic_slam_tpu_torch.utils import profiling as tprof
from torch_cases import one_torch_thread  # noqa: F401

from test_plane_ba import build_plane_graph

INF = dict(var_gain_a=20.0, min_stddev_x=0.1, max_stddev_x=5.0, min_stddev_q=0.05, max_stddev_q=0.2,
           fitness_score_thresh=0.5)


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


@functools.lru_cache(maxsize=1)
def clouds():
    """Two consecutive 120x160 clouds of a synthetic session and their
    measured relative pose."""
    log = synth_mod.make_synthetic_log(seed=3, n_steps=60, sensor_every=5, H=120, W=160)
    a, b = log.clouds[2], log.clouds[3]
    pose = {round(o.t, 6): o.pose7 for o in log.odom}
    ta = min(pose, key=lambda s: abs(s - a.t))
    tb = min(pose, key=lambda s: abs(s - b.t))
    rel = np.asarray(jgeo.pose_mul(jgeo.pose_inv(jnp.asarray(pose[ta])), jnp.asarray(pose[tb])))
    return a.points.astype(np.float64), a.valid, b.points.astype(np.float64), b.valid, rel


# ---------------------------------------------------------------------------
# fitness information
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,S", [(19200, 1024), (307200, 1024), (76800, 1024), (307200, 128), (12345, 7),
                                 (1000, 1024), (3, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_subsample_index_equals_linspace(n, S, dtype):
    """The strided subsample picks JAX's points: ``jnp.linspace(...)
    .astype(int32)`` as compiled, in f32 (the engine's) and f64 (x64)."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(0, n - 1, S, dtype=dtype).astype(jnp.int32))())
    np.testing.assert_array_equal(tinf.subsample_index(n, S, dtype), want)


@pytest.mark.parametrize("x", [0.0, 0.013, 0.2, 0.5, 3.0])
def test_weight_and_info6(x):
    assert tinf.weight(20.0, 0.5, 0.01, 25.0, x) == jinf.weight(20.0, 0.5, 0.01, 25.0, x)
    want = jinf.fitness_info6(x, dtype=np.float64, **INF)
    got = tinf.fitness_info6(torch.tensor(x, dtype=torch.float64), dtype=torch.float64, **INF)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # f32: the host's variance rounded to f32, then 1 / variance in f32
    got32 = tinf.fitness_info6(torch.tensor(x, dtype=torch.float32), dtype=torch.float32, **INF)
    np.testing.assert_allclose(got32.numpy(), jinf.fitness_info6(float(np.float32(x)), dtype=np.float32, **INF),
                               rtol=2e-7, atol=0)


@pytest.mark.parametrize("case", ["pair", "self", "none_valid", "far"])
def test_fitness_score(case):
    pa, va, pb, vb, rel = clouds()
    if case == "self":
        pb, vb, rel = pa, va, np.array([0, 0, 0, 1.0, 0, 0, 0])
    elif case == "none_valid":
        va = np.zeros_like(va)
    elif case == "far":
        rel = rel + np.array([5.0, 0, 0, 0, 0, 0, 0])
    want = float(jinf.fitness_score(jnp.asarray(pa), jnp.asarray(va), jnp.asarray(pb), jnp.asarray(vb),
                                    jnp.asarray(rel), max_range=2.0, S=1024))
    got = float(tinf.fitness_score(t(pa), t(va, torch.bool), t(pb), t(vb, torch.bool), t(rel), max_range=2.0,
                                   S=1024))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    if case in ("none_valid", "far"):
        assert got == 4.0


def test_fitness_score_f32():
    pa, va, pb, vb, rel = clouds()
    f32 = [np.asarray(a, np.float32) for a in (pa, pb, rel)]
    want = float(jinf.fitness_score(jnp.asarray(f32[0]), jnp.asarray(va), jnp.asarray(f32[1]), jnp.asarray(vb),
                                    jnp.asarray(f32[2]), S=1024))
    got = float(tinf.fitness_score(t(f32[0], torch.float32), t(va, torch.bool), t(f32[1], torch.float32),
                                   t(vb, torch.bool), t(f32[2], torch.float32), S=1024))
    assert got == pytest.approx(want, rel=1e-6)


def test_fitness_score_nan_at_invalid():
    """NaN points at invalid pixels (a PointCloud2's) score as zeros there."""
    pa, va, pb, vb, rel = clouds()
    nan_a, nan_b = np.where(va[..., None], pa, np.nan), np.where(vb[..., None], pb, np.nan)
    want = float(tinf.fitness_score(t(pa), t(va, torch.bool), t(pb), t(vb, torch.bool), t(rel)))
    got = float(tinf.fitness_score(t(nan_a), t(va, torch.bool), t(nan_b), t(vb, torch.bool), t(rel)))
    assert got == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# adaptive normals and the batched frontend
# ---------------------------------------------------------------------------


def stepped_cloud(seed: int):
    """A 48x64 cloud with depth steps, a sloped face, invalid borders (a
    finite, non-zero z there) and a few invalid holes."""
    rng = np.random.default_rng(seed)
    H, W = 48, 64
    u, v = np.meshgrid(np.linspace(-1, 1, W), np.linspace(-0.75, 0.75, H))
    z = 2.0 + 0.3 * u + 0.01 * rng.normal(size=(H, W))
    z[:, W // 3:] += 0.5  # a depth step
    z[H // 2:, : W // 4] -= 0.4  # another
    pts = np.stack([u * z, v * z, z], axis=-1)
    valid = np.ones((H, W), bool)
    valid[:3], valid[:, -2:] = False, False
    valid[rng.integers(0, H, 20), rng.integers(0, W, 20)] = False
    pts[~valid] = pts[~valid] * 1.7 + 0.3
    return pts, valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("smoothing", [10, 20])
def test_compute_normals_adaptive(seed, smoothing):
    pts, valid = stepped_cloud(seed)
    jn, jv = jnm.compute_normals_adaptive(jnp.asarray(pts), jnp.asarray(valid), smoothing_size=smoothing)
    tn, tv = tnm.compute_normals_adaptive(t(pts), t(valid, torch.bool), smoothing_size=smoothing)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tn.numpy()[tv.numpy()], np.asarray(jn)[np.asarray(jv)], atol=1e-9, rtol=0)
    # the windows did shrink somewhere: the fixed-window mask differs
    _, fv = tnm.compute_normals(t(pts), t(valid, torch.bool), smoothing_size=smoothing)
    assert (fv.numpy() != tv.numpy()).any()


def test_normals_batched_equal_per_cloud():
    clouds_ = [stepped_cloud(s) for s in (0, 1, 2)]
    P = t(np.stack([c[0] for c in clouds_]))
    V = t(np.stack([c[1] for c in clouds_]), torch.bool)
    for fn in (tnm.compute_normals, tnm.compute_normals_adaptive):
        nb, vb = fn(P, V, smoothing_size=10)
        for b in range(3):
            n1, v1 = fn(P[b], V[b], smoothing_size=10)
            assert torch.equal(vb[b], v1)
            torch.testing.assert_close(nb[b], n1, atol=1e-12, rtol=0)


SEG = dict(num_point_seg=100.0, norm_point_thres=400.0, planar_area=0.01, distance_thres=0.02,
           cos_angular_thres=float(np.cos(np.deg2rad(2.0))))
STATICS = dict(samp_h=64, samp_w=64, max_planes=2, num_hypotheses=64, smoothing_size=10)


@functools.lru_cache(maxsize=1)
def det_frames():
    """Three detection frames of a short session: clouds, boxes, poses."""
    log = synth_mod.make_synthetic_log(seed=3, n_steps=60, sensor_every=5, H=120, W=160)
    dets = sorted(log.detections, key=lambda e: -len(e.boxes))[:3]
    out = []
    for k, det in enumerate(dets):
        cloud = max((c for c in log.clouds if c.t <= det.t), key=lambda c: c.t)
        D = 4
        boxes, cids = np.zeros((D, 4)), np.full((D,), -1, np.int32)
        n = min(len(det.boxes), D)
        boxes[:n], cids[:n] = det.boxes[:n], det.class_ids[:n]
        xyzrpy = np.array([0.1 * k, -0.2, 0.0, 0.0, 0.0, 0.3 - 0.1 * k])
        out.append((cloud.points.astype(np.float64), cloud.valid, boxes, cids, np.full((D,), 0.9), xyzrpy))
    return out


@pytest.mark.parametrize("adaptive", [False, True])
def test_segment_window_equals_jax_per_frame(adaptive):
    """One window call over three frames gives each frame's JAX
    ``segment_all`` (adaptive normals too)."""
    fr = det_frames()
    stack = [t(np.stack([f[i] for f in fr]), torch.bool if i == 1 else torch.int32 if i == 3 else torch.float64)
             for i in range(6)]
    got = tseg.segment_window(*stack, torch.tensor(0.0, dtype=torch.float64), **SEG, **STATICS,
                              adaptive_normals=adaptive)
    n_valid = 0
    for b, (pts, valid, boxes, cids, probs, xyz) in enumerate(fr):
        want = jseg.segment_all(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(boxes), jnp.asarray(cids),
                                jnp.asarray(probs), jnp.asarray(xyz), jnp.asarray(0.0),
                                *(jnp.asarray(v) for v in SEG.values()), **STATICS, adaptive_normals=adaptive)
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(want.valid))
        n_valid += int(np.asarray(want.valid).sum())
        for f in ("world_pose", "pose_cam", "normal_cam", "num_points"):
            ok = np.asarray(want.valid)
            np.testing.assert_allclose(getattr(got, f)[b].numpy()[ok], np.asarray(getattr(want, f))[ok],
                                       atol=1e-9, rtol=0)
    assert n_valid >= 2


# ---------------------------------------------------------------------------
# frames, plane BA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["pose_ned_to_enu", "pose_cam_to_robot_odom", "rot_pose_z", "rebase_to_origin"])
def test_frame_fixups(fn):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(5, 3)), q], axis=-1)
    extra = {"rot_pose_z": (0.37,), "rebase_to_origin": (np.array([0.3, -1.2, 0.5]),)}.get(fn, ())
    want = np.asarray(getattr(jfr, fn)(jnp.asarray(poses), *(jnp.asarray(e) for e in extra)))
    got = getattr(tfr, fn)(t(poses), *(t(e) if isinstance(e, np.ndarray) else e for e in extra)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def _port_plane_graph(g):
    return tba.PlaneGraph(*(torch.as_tensor(np.asarray(a)) for a in g))


@pytest.mark.parametrize("plane_noise", [0.0, 0.01])
def test_plane_bundle_adjust(plane_noise):
    g, _, _ = build_plane_graph(np.random.default_rng(0), plane_noise=plane_noise)
    jg, jc0, jc1 = jba.plane_bundle_adjust(g)
    tg, tc0, tc1 = tba.plane_bundle_adjust(_port_plane_graph(g))
    assert float(tc0) == pytest.approx(float(jc0), rel=1e-12)
    assert float(tc1) == pytest.approx(float(jc1), rel=1e-9, abs=1e-12)
    assert float(tc1) < 0.5 * float(tc0)
    np.testing.assert_allclose(tg.poses.numpy(), np.asarray(jg.poses), atol=1e-9, rtol=0)
    np.testing.assert_allclose(tg.planes.numpy(), np.asarray(jg.planes), atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def _exercise(m):
    with m.scope("a"):
        pass
    with m.scope("a"):
        pass
    try:
        with m.scope("b"):
            raise ValueError
    except ValueError:
        pass
    m.count("c", 3)
    return m


def test_metrics_like_jax(tmp_path):
    tm, jm = _exercise(tprof.Metrics()), _exercise(jprof.Metrics())
    ts, js = tm.summary(), jm.summary()
    assert list(ts) == list(js) == ["a", "b", "c"]
    for k in ts:
        assert ts[k]["count"] == js[k]["count"]
        assert set(ts[k]) == set(js[k])
    tm.dump(str(tmp_path / "m.json"))
    assert json.load(open(tmp_path / "m.json"))["c"]["count"] == 3


def test_device_trace_writes_file(tmp_path):
    with tprof.device_trace(str(tmp_path / "tr")):
        torch.ones(8).cumsum(0)
    path = tmp_path / "tr" / tprof.TRACE_FILE
    assert os.path.getsize(path) > 0
    trace = json.load(open(path))
    assert any("cumsum" in ev.get("name", "") for ev in trace["traceEvents"])
