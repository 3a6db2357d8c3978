"""Port of the perception frontend (depth backprojection, normals, plane
extraction, segmentation)
and of association against the JAX package, in f64 on the CPU.

Tolerances: normals and plane outputs 1e-9 (prefix sums and reductions run
in another order than XLA's, and the plane fit divides by small eigenvalue
gaps); flags, counts, classes and ids exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.assoc import association as jas
from semantic_slam_tpu.frontend import depth as jdp
from semantic_slam_tpu.frontend import normals as jnm
from semantic_slam_tpu.frontend import planes as jpl
from semantic_slam_tpu.frontend import segmentation as jseg
from semantic_slam_tpu.io import synthetic as synth_mod
from semantic_slam_tpu_torch.assoc import association as tas
from semantic_slam_tpu_torch.frontend import depth as tdp
from semantic_slam_tpu_torch.frontend import normals as tnm
from semantic_slam_tpu_torch.frontend import planes as tpl
from semantic_slam_tpu_torch.frontend import segmentation as tseg

TOL = 1e-9
SEG = dict(num_point_seg=100.0, norm_point_thres=400.0, planar_area=0.01, distance_thres=0.02,
           cos_angular_thres=float(np.cos(np.deg2rad(2.0))))
STATICS = dict(samp_h=64, samp_w=64, max_planes=2, num_hypotheses=64, smoothing_size=10)


@functools.lru_cache(maxsize=1)
def frame():
    """The busiest detection frame of a short synthetic session: cloud,
    boxes, pose."""
    log = synth_mod.make_synthetic_log(seed=3, n_steps=60, sensor_every=5, H=120, W=160)
    det = max(log.detections, key=lambda e: len(e.boxes))
    cloud = max((c for c in log.clouds if c.t <= det.t), key=lambda c: c.t)
    D = 4
    boxes = np.zeros((D, 4))
    cids = np.full((D,), -1, np.int32)
    n = min(len(det.boxes), D)
    boxes[:n], cids[:n] = det.boxes[:n], det.class_ids[:n]
    probs = np.full((D,), 0.9)
    xyzrpy = np.array([0.1, -0.2, 0.0, 0.0, 0.0, 0.3])
    return cloud.points.astype(np.float64), cloud.valid, boxes, cids, probs, xyzrpy


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_backproject_depth():
    rng = np.random.default_rng(7)
    depth = rng.integers(0, 4000, size=(24, 32)).astype(np.uint16)
    depth[::5, ::3] = 0
    intr = np.array([40.0, 41.0, 16.0, 12.5])
    jp, jv = jdp.backproject_depth(jnp.asarray(depth), jnp.asarray(intr), jnp.float64(1e-3))
    tp, tv = tdp.backproject_depth(
        torch.as_tensor(depth.astype(np.int32)), torch.as_tensor(intr), torch.tensor(1e-3, dtype=torch.float64)
    )
    close(tv, jv)
    close(tp, jp, 1e-12)


def test_compute_normals():
    pts, valid = frame()[:2]
    jn, jv = jnm.compute_normals(jnp.asarray(pts), jnp.asarray(valid), smoothing_size=10)
    tn, tv = tnm.compute_normals(torch.as_tensor(pts), torch.as_tensor(valid), smoothing_size=10)
    close(tv, jv)
    v = np.asarray(jv)
    assert v.sum() > 1000
    close(tn.numpy()[v], np.asarray(jn)[v], 1e-7)


def planar_batch(seed, D=3, N=2048):
    """Points on two planes per detection, normals with a little noise."""
    rng = np.random.default_rng(seed)
    pts = np.empty((D, N, 3))
    nrm = np.empty((D, N, 3))
    for d in range(D):
        for half, (n, off) in enumerate(((np.array([0.0, -1, 0]), 1.0), (np.array([0.0, 0, -1]), 3.0))):
            sl = slice(half * N // 2, (half + 1) * N // 2)
            p = rng.uniform(-1, 1, size=(N // 2, 3)) + np.array([0, 0, 3.0])
            p -= (p @ n + off)[:, None] * n
            pts[d, sl] = p + 0.002 * rng.normal(size=p.shape)
            nn = n + 0.005 * rng.normal(size=p.shape)
            nrm[d, sl] = nn / np.linalg.norm(nn, axis=-1, keepdims=True)
        perm = rng.permutation(N)  # interleave so evenly spread seeds hit both planes
        pts[d], nrm[d] = pts[d, perm], nrm[d, perm]
    cand = rng.random((D, N)) > 0.1
    return pts, nrm, cand


def test_extract_planes_batched():
    pts, nrm, cand = planar_batch(0)
    D = pts.shape[0]
    h = np.array([0.0, -1.0, 0.0])
    scale = np.array([4.0, 2.0, 1.0])
    args = (SEG["num_point_seg"] / 20, 0.01, SEG["distance_thres"] * 2, 0.99)
    got = tpl.extract_planes(
        torch.as_tensor(pts), torch.as_tensor(nrm), torch.as_tensor(cand), torch.as_tensor(h),
        torch.as_tensor(scale), *args, max_planes=3, num_hypotheses=32,
    )
    assert got.valid.any()
    for d in range(D):
        want = jpl.extract_planes(
            jnp.asarray(pts[d]), jnp.asarray(nrm[d]), jnp.asarray(cand[d]), jnp.asarray(h),
            jnp.float64(scale[d]), *(jnp.float64(a) for a in args), max_planes=3, num_hypotheses=32,
        )
        for name in jpl.PlaneSet._fields:
            close(getattr(got, name)[d], getattr(want, name))


def test_segment_all():
    pts, valid, boxes, cids, probs, xyzrpy = frame()
    want = jseg.segment_all(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(boxes), jnp.asarray(cids), jnp.asarray(probs),
        jnp.asarray(xyzrpy), jnp.float64(0.0), *(jnp.float64(v) for v in SEG.values()), **STATICS,
    )
    got = tseg.segment_all(
        torch.as_tensor(pts), torch.as_tensor(valid), torch.as_tensor(boxes), torch.as_tensor(cids),
        torch.as_tensor(probs), torch.as_tensor(xyzrpy), torch.tensor(0.0, dtype=torch.float64),
        *SEG.values(), **STATICS,
    )
    assert np.asarray(want.valid).any()
    for name in jseg.DetectedObjects._fields:
        close(getattr(got, name), getattr(want, name), 1e-7)


def assoc_inputs(seed, count):
    """A table with ``count`` landmarks and 8 detections, some close to
    them, some close to each other, two invalid."""
    rng = np.random.default_rng(seed)
    L, M = 16, 8
    world = rng.uniform(-2, 2, size=(L, 3))
    A = rng.normal(size=(L, 3, 3)) * 0.2
    table = dict(
        world=world, cov=A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(3),
        class_id=rng.integers(0, 2, size=L).astype(np.int32),
        plane_type=rng.integers(0, 2, size=L).astype(np.int32),
        normal=np.concatenate([rng.normal(size=(L, 3)), rng.normal(size=(L, 1))], axis=-1),
        count=np.int32(count),
    )
    pose_cam = rng.uniform(-2, 2, size=(M, 3)) + np.array([0, 0, 3.0])
    pose_cam[3] = pose_cam[1] + 0.05  # an in-frame near-duplicate
    dets = dict(
        valid=np.array([1, 1, 0, 1, 1, 1, 0, 1], bool),
        class_id=rng.integers(0, 2, size=M).astype(np.int32),
        prob=np.full(M, 0.9),
        plane_type=rng.integers(0, 2, size=M).astype(np.int32),
        num_points=np.full(M, 500.0),
        pose_cam=pose_cam,
        normal_cam=np.concatenate([rng.normal(size=(M, 3)), rng.normal(size=(M, 1))], axis=-1),
        world_pose=np.zeros((M, 3)),
    )
    dets["class_id"][3] = dets["class_id"][1]
    dets["plane_type"][3] = dets["plane_type"][1]
    xyzrpy = np.array([0.2, 0.1, 0.0, 0.0, 0.05, 0.4])
    return table, dets, xyzrpy


@pytest.mark.parametrize(
    "use_maha,use_plane_gate,count",
    [(True, False, 6), (False, False, 6), (True, True, 6), (False, False, 0)],
    ids=["maha", "euclid", "maha-plane-gate", "first-frame"],
)
def test_associate(use_maha, use_plane_gate, count):
    table, dets, xyzrpy = assoc_inputs(4, count)
    params = dict(maha_thres=3.0, eq_thres=1.5, land_noise=0.4)
    jt, jr = jas.associate(
        jas.LandmarkTable(**{k: jnp.asarray(v) for k, v in table.items()}),
        jseg.DetectedObjects(**{k: jnp.asarray(v) for k, v in dets.items()}),
        jnp.asarray(xyzrpy), jnp.float64(0.0), jnp.asarray(use_maha),
        *(jnp.float64(v) for v in params.values()), use_plane_gate=use_plane_gate,
    )
    tt, tr = tas.associate(
        tas.table_from_numpy(table),
        tseg.DetectedObjects(**{k: torch.as_tensor(v) for k, v in dets.items()}),
        torch.as_tensor(xyzrpy), torch.tensor(0.0, dtype=torch.float64), use_maha,
        **params, use_plane_gate=use_plane_gate,
    )
    got_table = tas.table_to_numpy(tt)
    for name in jas.LandmarkTable._fields:
        close(got_table[name], getattr(jt, name))
    for name in jas.AssocResult._fields:
        close(getattr(tr, name), getattr(jr, name))
    assert int(jt.count) > count  # some detections became landmarks


def test_sync_from_graph():
    table, _, _ = assoc_inputs(5, 6)
    rng = np.random.default_rng(6)
    lms, marg = rng.normal(size=(32, 3)), rng.normal(size=(32, 3, 3))
    want = jas.sync_from_graph(
        jas.LandmarkTable(**{k: jnp.asarray(v) for k, v in table.items()}), jnp.asarray(lms), jnp.asarray(marg)
    )
    got = tas.table_to_numpy(
        tas.sync_from_graph(tas.table_from_numpy(table), torch.as_tensor(lms), tas.marginals_from_numpy(marg))
    )
    for name in jas.LandmarkTable._fields:
        close(got[name], getattr(want, name), 0)
