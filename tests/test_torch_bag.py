"""The port's ROS surface against the JAX package's, on the CPU: the rosbag
2.0 reader and writer, the native ``.slog`` library, the viz bag,
``SlamEngine.segment_keyframe``, and ``cli`` with ``.npz``, ``.bag`` and
``.slog`` logs, ``baginfo``, ``--voxel --carve`` and ``--viz-bag-detections``.

Equal: the ``ReplayLog`` that either reader makes of one bag, event for event
and bit for bit (JAX ``write_bag`` bags, none and bz2, a depth log; the
hand-encoded bag of ``tests/test_rosbag.py`` with row padding, an unmapped
topic and foreign message types; a custom topic map); the bytes either
writer makes of one log, and every md5 and full definition; the ``.slog``
file, its events and the ``replay_slog`` stream; the viz bag's bytes from one
port engine; the sessions on one log as ``.npz``, ``.bag`` and ``.slog``
(counts; poses within 1e-9). ``segment_keyframe`` equals the keyframe's
processing-time detections exactly, and the JAX ``_segment_only`` within
1e-9 (f64).

Two faults of the JAX package are held repaired here: a cloud whose invalid
pixels are NaN maps like its zero-filled twin (the JAX frontend lets the NaN
reach its masked plane fit), and a ``.slog`` session's keyframe clouds stay
readable after the reader closes (the JAX engine keeps views into the
unmapped file).
"""

import dataclasses
import io
import os
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from semantic_slam_tpu import cli as jcli
from semantic_slam_tpu import native as jnative
from semantic_slam_tpu.io import rosbag as jrb
from semantic_slam_tpu.io import rosbag_write as jrw
from semantic_slam_tpu.io import synthetic as jsynth
from semantic_slam_tpu.runtime import engine as jengine
from semantic_slam_tpu.viz import rviz_bag as jviz
from semantic_slam_tpu_torch import cli as tcli
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch import native as tnative
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import rosbag as trb
from semantic_slam_tpu_torch.io import rosbag_write as trw
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.runtime import engine as tengine
from semantic_slam_tpu_torch.viz import rviz_bag as tviz
from test_e2e import e2e_config
from test_rosbag import _demo_bag, _pointcloud2
from test_torch_lifecycle import to_port
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

PROFILE = "torch_bag"
TOL = 1e-9
REPO = pathlib.Path(__file__).resolve().parent.parent
LOG_KW = dict(seed=3, n_steps=180, sensor_every=5, drift_noise=0.008, loops=1.0, H=60, W=80)


def assert_logs_equal(a, b):
    """Event for event, bit for bit (NaN where NaN), dtypes included."""
    for field in ("odom", "clouds", "depths", "detections", "gt"):
        ea, eb = getattr(a, field), getattr(b, field)
        assert len(ea) == len(eb), field
        for x, y in zip(ea, eb):
            assert type(x).__name__ == type(y).__name__
            for f in dataclasses.fields(y):
                va, vb = getattr(x, f.name), getattr(y, f.name)
                if isinstance(vb, np.ndarray):
                    assert va.dtype == vb.dtype, (field, f.name)
                    np.testing.assert_array_equal(va, vb, err_msg=f"{field}.{f.name}")
                else:
                    assert va == vb, (field, f.name)


@pytest.fixture(scope="module")
def profile():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tcfg.PROFILES, PROFILE, to_port(e2e_config()))
        yield


@pytest.fixture(scope="module")
def small_log():
    return tsynth.make_synthetic_log(**LOG_KW)


# ---------------------------------------------------------------------------
# rosbag 2.0: reader, writer, message definitions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bags(small_log, tmp_path_factory):
    """name -> (port-written path, JAX-written path, topic map); the demo
    bags are hand-encoded (``tests/test_rosbag.py``), one file each."""
    tmp = tmp_path_factory.mktemp("bags")
    # each writer takes its own package's log (its events' classes): the
    # same values, tests/test_torch_isolation.py
    jlog = jsynth.make_synthetic_log(**LOG_KW)
    cases = (("none", small_log, jlog, "none"), ("bz2", small_log, jlog, "bz2"),
             ("depth", tsynth.clouds_to_depth(tsynth.make_synthetic_log(**LOG_KW)),
              jsynth.clouds_to_depth(jsynth.make_synthetic_log(**LOG_KW)), "none"))
    out = {}
    for name, log, jl, comp in cases:
        tp, jp = str(tmp / f"t_{name}.bag"), str(tmp / f"j_{name}.bag")
        assert trw.write_bag(tp, log, comp) == jrw.write_bag(jp, jl, comp)
        out[name] = (tp, jp, None)
    custom = {"/rovio/odometry": ("odom", "jackal"), "/unrelated/topic": ("gt", None),
              "/image_processed/bounding_boxes": ("detections", None), "/depth_registered/points": ("cloud", None)}
    for comp in ("none", "bz2"):
        demo = _demo_bag()
        # a second cloud whose rows carry 8 bytes of padding (row_step > width * point_step)
        xyz = np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3) * 0.25
        xyz[2, 3] = np.nan
        demo.message("/depth_registered/points", 31.0, _pointcloud2(31.0, xyz, row_pad=8))
        p = tmp / f"demo_{comp}.bag"
        p.write_bytes(demo.tobytes(compression=comp))
        out[f"demo_{comp}"] = (str(p), str(p), None)
        out[f"demo_{comp}_custom_map"] = (str(p), str(p), custom)
    return out


@pytest.mark.parametrize("name", ["none", "bz2", "depth"])
def test_write_bag_same_bytes(bags, name):
    tp, jp, _ = bags[name]
    assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes()


@pytest.mark.parametrize("name", ["none", "bz2", "depth", "demo_none", "demo_bz2", "demo_none_custom_map",
                                  "demo_bz2_custom_map"])
def test_read_bag_equals_jax(bags, name):
    tp, _, tmap = bags[name]
    got, want = trb.read_bag(tp, tmap), jrb.read_bag(tp, tmap)
    assert_logs_equal(got, want)
    assert got.odom and (got.clouds or got.gt)
    assert trb.bag_info(tp) == jrb.bag_info(tp)
    if name.startswith("demo"):  # the NaN pixels are invalid; the padded rows do not shear the grid
        c0, c1 = got.clouds
        assert not c0.valid[1, 1] and np.isnan(c0.points[1, 1]).all()
        assert c1.points.shape == (5, 4, 3) and c1.valid.sum() == 19 and c1.points[4, 3, 2] == 59 * 0.25


def test_md5_and_definitions_equal():
    assert trw.MSG_DEFS == jrw.MSG_DEFS and len(trw.MSG_DEFS) >= 20
    for t in sorted(jrw.MSG_DEFS):
        assert trw.compute_md5(t) == jrw.compute_md5(t), t
        assert trw.full_definition(t) == jrw.full_definition(t), t
    # the official constants the JAX tests pin
    assert trw.compute_md5("nav_msgs/Odometry") == "cd5e73d190d741a2f92e81eda573aca7"
    assert trw.compute_md5("visualization_msgs/MarkerArray") == "d155b9ce5188fbaf89745847fd5882d7"


def test_synth_bag_and_slog_read_back(tmp_path, small_log):
    """``synth --out x.bag`` / ``x.slog``: the JAX CLI's bytes, and read back
    the log (bag: stamps on the 1e9 s epoch, boxes at whole pixels, NaN at
    invalid pixels; slog: f32 boxes and probabilities)."""
    argv = ["--steps", "30", "--sensor-every", "5", "--height", "24", "--width", "32", "--loops", "1",
            "--drift", str(LOG_KW["drift_noise"])]
    log = tsynth.make_synthetic_log(seed=0, n_steps=30, sensor_every=5, drift_noise=LOG_KW["drift_noise"],
                                    loops=1.0, H=24, W=32)
    for ext in ("bag", "slog"):
        tp, jp = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        with redirect_stdout(io.StringIO()):
            tcli.main(["synth", "--out", tp, *argv])
            jcli.main(["synth", "--out", jp, *argv])
        assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes(), ext
    back = trb.read_bag(str(tmp_path / "t.bag"))
    for f in ("odom", "clouds", "detections", "gt"):
        assert len(getattr(back, f)) == len(getattr(log, f)), f
    off = trw.epoch_offset(min(e.t for e in log.clouds + log.odom))
    assert off == 1e9 + 1e-4  # the first cloud's stamp, -1e-4 s, onto the epoch
    for a, b in zip(back.odom, log.odom):
        assert a.t == pytest.approx(b.t + off, abs=1e-6) and a.source == b.source
        np.testing.assert_array_equal(a.pose7, b.pose7)
    for a, b in zip(back.clouds, log.clouds):
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.points[a.valid], b.points[b.valid])
        assert np.isnan(a.points[~a.valid]).all()
    for a, b in zip(back.detections, log.detections):
        np.testing.assert_array_equal(a.boxes[:, :2], np.round(b.boxes[:, :2]))
        np.testing.assert_array_equal(a.class_ids, b.class_ids)
    for a, b in zip(back.gt, log.gt):
        np.testing.assert_array_equal(a.pose7, b.pose7)
    with tnative.SlogReader(str(tmp_path / "t.slog")) as r:
        assert (r.n_odom, r.n_cloud, r.n_det, r.n_gt) == tuple(
            len(getattr(log, f)) for f in ("odom", "clouds", "detections", "gt"))
        t, xyz, valid = r.cloud(0)
        assert t == log.clouds[0].t
        np.testing.assert_array_equal(xyz, log.clouds[0].points)
        np.testing.assert_array_equal(valid, log.clouds[0].valid)
        _, boxes, cids, probs = r.detections(0)
        np.testing.assert_array_equal(boxes, log.detections[0].boxes.astype(np.float32))
        np.testing.assert_array_equal(probs, log.detections[0].probs.astype(np.float32))


def test_baginfo_prints_the_jax_lines(bags, capsys):
    for name in ("none", "demo_bz2"):
        path = bags[name][0]
        tcli.main(["baginfo", path])
        got = capsys.readouterr().out
        jcli.main(["baginfo", path])
        assert got == capsys.readouterr().out and got.count("\n") >= 4, name


# ---------------------------------------------------------------------------
# .slog: the native library
# ---------------------------------------------------------------------------


class _Recorder:
    """An engine stand-in that records what a replay delivers."""

    def __init__(self):
        self.calls = []

    def run(self):
        self.calls.append(("run",))

    def set_point_cloud(self, points, valid):
        self.calls.append(("cloud", np.array(points), np.array(valid)))

    def set_detections(self, boxes, cids, probs):
        self.calls.append(("det", np.array(boxes), np.array(cids), np.array(probs)))

    def vio_callback(self, t, pose, cov):
        self.calls.append(("odom", t, np.array(pose), np.array(cov)))


def test_slog_equals_jax(tmp_path, small_log):
    """Both libraries write the same file; the port's reader gives the JAX
    reader's events and ``replay_slog`` the JAX replay's calls; the library
    is built under build/, nothing is written into the package."""
    before = sorted(p.name for p in (REPO / "semantic_slam_tpu_torch" / "native").iterdir())
    H, W = LOG_KW["H"], LOG_KW["W"]
    tp, jp = str(tmp_path / "t.slog"), str(tmp_path / "j.slog")
    tnative.write_slog(tp, small_log, height=H, width=W)
    jnative.write_slog(jp, small_log, height=H, width=W)
    assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes()
    assert pathlib.Path(tnative._LIB) == REPO / "build" / "semantic_slam_tpu_torch" / "libslamlog.so"
    assert os.path.exists(tnative._LIB)
    after = sorted(p.name for p in (REPO / "semantic_slam_tpu_torch" / "native").iterdir())
    assert after == before and not [n for n in after if n.endswith(".so")]

    jr = jnative.SlogReader(tp)
    with tnative.SlogReader(tp) as tr:
        assert list(tr.events()) == list(jr.events())
        assert (tr.n_odom, tr.n_cloud, tr.n_det, tr.n_gt, tr.height, tr.width, tr.max_det) == (
            jr.n_odom, jr.n_cloud, jr.n_det, jr.n_gt, jr.height, jr.width, jr.max_det)
        for kind, n in ((tr.odom, tr.n_odom), (tr.cloud, tr.n_cloud), (tr.detections, tr.n_det), (tr.gt, tr.n_gt)):
            jkind = getattr(jr, kind.__name__)
            for i in range(n):
                for a, b in zip(kind(i), jkind(i)):
                    np.testing.assert_array_equal(a, b)
    jr.close()

    from semantic_slam_tpu.io import replay as jreplay

    got, want = _Recorder(), _Recorder()
    treplay.replay_slog(tp, got)
    jreplay.replay_slog(tp, want)
    assert len(got.calls) == len(want.calls) > 0
    for a, b in zip(got.calls, want.calls):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(treplay.slog_gt(tp), jreplay.slog_gt(tp)):
        np.testing.assert_array_equal(a, b)


def test_slog_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    monkeypatch.setattr(tnative, "_LIB", str(tmp_path / "libbroken.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.write_slog(str(tmp_path / "x.slog"), treplay.ReplayLog(), 4, 4)
    assert not (tmp_path / "libbroken.so").exists()


# ---------------------------------------------------------------------------
# one short port session: segment_keyframe and the viz bag
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def session(small_log):
    """A port engine after the small log, f64 on the CPU, with each detection
    keyframe's processing-time detections recorded in order."""
    seen = []
    orig = tengine._segment_only

    def recording(*a, **kw):
        dets = orig(*a, **kw)
        seen.append(dets)
        return dets

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "_segment_only", recording)
        eng = tengine.SlamEngine(to_port(e2e_config()), device="cpu")
        treplay.replay(small_log, eng)
    assert int(eng.table.count) >= 2
    return eng, seen


def test_segment_keyframe_equals_processing_time(session):
    eng, seen = session
    det_kfs = [k for k in eng.keyframes if tengine._is_det(k)]
    assert len(det_kfs) == len(seen) >= 5
    for kf, dets in zip(det_kfs, seen):
        d = eng.segment_keyframe(kf)
        np.testing.assert_array_equal(d["valid"], dets.valid.numpy())
        np.testing.assert_array_equal(d["class_id"], dets.class_id.numpy())
        np.testing.assert_array_equal(d["plane_type"], dets.plane_type.numpy())
        np.testing.assert_array_equal(d["world_pose"], dets.world_pose.numpy())
    assert any(eng.segment_keyframe(k)["valid"].any() for k in det_kfs)
    assert all(eng.segment_keyframe(k) is None for k in eng.keyframes if not tengine._is_det(k))


def test_segment_only_equals_jax(session):
    """The frontend alone, the port's against the JAX ``_segment_only``, on
    the inputs of the session's detection keyframes with the most
    detections (f64, crop 64)."""
    import jax.numpy as jnp

    eng, _ = session
    det_kfs = sorted((k for k in eng.keyframes if tengine._is_det(k)), key=lambda k: -len(k.boxes))[:2]
    for kf in det_kfs:
        fa, statics = eng._frontend_args(kf)
        got = tengine._segment_only(**fa, **statics)
        sp = fa["seg_params"]
        want = jengine._segment_only(
            *(jnp.asarray(fa[k].numpy()) for k in ("points", "cloud_valid")), None, None,
            *(jnp.asarray(fa[k].numpy()) for k in ("boxes", "class_ids", "probs", "robot_xyzrpy", "cam_angle")),
            *(sp[k] for k in ("num_point_seg", "norm_point_thres", "planar_area", "distance_thres",
                              "cos_angular_thres")),
            **statics,
        )
        for f in got._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)
        assert got.valid.any()


def _grids(eng, chunk_dims=(32, 32, 16)):
    """Each package's chunked voxel map of the port engine's keyframe clouds
    at its poses (the loop of ``cli run --voxel``, small chunks)."""
    import jax.numpy as jnp

    from semantic_slam_tpu.core import geometry as jgeo
    from semantic_slam_tpu.mapping import voxel as jvox
    from semantic_slam_tpu_torch.core import geometry as tgeo
    from semantic_slam_tpu_torch.mapping import voxel as tvox

    tgrid = tvox.ChunkedVoxelMap(chunk_dims, dtype=torch.float64)
    jgrid = jvox.ChunkedVoxelMap(chunk_dims, dtype=jnp.float64)
    cam = eng.cfg.camera_angle_rad
    for kf in eng.keyframes:
        pose = eng.get_keyframe_pose(kf)
        tgrid.insert_keyframe_cloud(torch.as_tensor(kf.cloud[0], dtype=torch.float64), torch.as_tensor(kf.cloud[1]),
                                    tgeo.pose_to_xyzrpy(torch.as_tensor(pose)), torch.tensor(cam, dtype=torch.float64))
        jgrid.insert_keyframe_cloud(jnp.asarray(kf.cloud[0], jnp.float64), kf.cloud[1],
                                    jgeo.pose_to_xyzrpy(jnp.asarray(pose)), jnp.float64(cam))
    return tgrid, jgrid


def test_viz_bag_equals_jax(session, tmp_path):
    """One port engine, both packages' ``write_viz_bag``: the same bytes
    with the detection stream and no grid; with each package's own voxel
    map of the session, the same topic counts and /occupancy message."""
    eng, _ = session
    tp, jp = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    counts = tviz.write_viz_bag(tp, eng, path_stride=3, detections=True)
    assert counts == jviz.write_viz_bag(jp, eng, path_stride=3, detections=True)
    assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes()
    assert counts["/detected_landmarks"] >= 1 and counts["/mapped_landmarks"] == 1
    assert {t: n for t, (_, n) in trb.bag_info(tp).items()} == counts

    tgrid, jgrid = _grids(eng)
    counts = tviz.write_viz_bag(tp, eng, tgrid)
    assert counts == jviz.write_viz_bag(jp, eng, jgrid) and counts["/occupancy"] == 1
    occ = [[m for tpc, _, _, m in rd(p) if tpc == "/occupancy"] for rd, p in ((trb.read_messages, tp),
                                                                             (jrb.read_messages, jp))]
    assert occ[0] == occ[1] and len(occ[0][0]["markers"][0]["points"]) > 100


# ---------------------------------------------------------------------------
# the CLI on one log as .npz, .bag and .slog
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def three_logs(small_log, tmp_path_factory):
    """The small log as a bag (boxes at whole pixels, NaN at invalid pixels,
    stamps on the 1e9 s epoch), and what that bag reads back as, written
    as .npz and .slog: three files of one log."""
    tmp = tmp_path_factory.mktemp("three")
    paths = {ext: str(tmp / f"log.{ext}") for ext in ("bag", "npz", "slog")}
    trw.write_bag(paths["bag"], small_log)
    log = trb.read_bag(paths["bag"])
    assert sum(np.isnan(c.points).any() for c in log.clouds) > 0
    treplay.save_log(paths["npz"], log)
    tnative.write_slog(paths["slog"], log, height=LOG_KW["H"], width=LOG_KW["W"])
    return paths, tmp


@pytest.fixture(scope="module")
def three_runs(profile, three_logs):
    """``cli run`` from each file, each with --voxel: the .bag run also with
    --carve --viz-bag-detections, the .slog one with --viz-bag-detections
    (after its reader has closed)."""
    paths, tmp = three_logs
    flags = {"npz": ["--voxel"], "bag": ["--voxel", "--carve", "--viz-bag-detections"],
             "slog": ["--voxel", "--viz-bag-detections"]}
    runs = {}
    grids = {}
    orig = tcli.build_voxel_map
    for ext, path in paths.items():
        args = tcli.build_parser().parse_args(["run", "--log", path, "--out", str(tmp / ext), "--profile", PROFILE,
                                               "--device", "cpu", "--compute-ate", *flags[ext]])

        def keep(engine, carve=False, ext=ext):
            grids[ext] = orig(engine, carve)
            return grids[ext]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tcli, "build_voxel_map", keep)
            runs[ext] = tcli.run_from_args(args, tcli.load_replay_log(path)) + (grids.get(ext), str(tmp / ext))
    return runs


def test_three_formats_same_session(three_runs):
    (e0, s0, _, _) = three_runs["npz"]
    assert s0["landmarks"] >= 2 and s0["keyframes"] >= 10
    for ext in ("bag", "slog"):
        e, s, _, _ = three_runs[ext]
        for k in ("keyframes", "landmarks", "edges", "optimize_calls"):
            assert s[k] == s0[k], (ext, k)
        assert [h["iterations"] for h in e.stats_history] == [h["iterations"] for h in e0.stats_history], ext
        assert [k.stamp for k in e.keyframes] == [k.stamp for k in e0.keyframes], ext
        np.testing.assert_allclose(e.get_keyframe_poses(), e0.get_keyframe_poses(), rtol=0, atol=TOL)
        lm, lm0 = e.get_mapped_landmarks(), e0.get_mapped_landmarks()
        np.testing.assert_allclose(lm["pose"], lm0["pose"], rtol=0, atol=TOL)
        assert s["ate_rmse_optimized"] == pytest.approx(s0["ate_rmse_optimized"], abs=TOL)


def test_slog_session_after_close_maps_like_npz(three_runs):
    """Fault 2: the .slog session's keyframe clouds were read after its
    reader closed (the voxel map, the viz bag's detections) and hold the
    .npz session's map: equal chunk keys and hits, and equal re-run
    detections."""
    e0, _, g0, out0 = three_runs["npz"]
    e1, s1, g1, out1 = three_runs["slog"]
    assert sorted(g1.chunks) == sorted(g0.chunks) and g0.chunks
    for cc, g in g0.chunks.items():
        assert torch.equal(g1.chunks[cc].hits, g.hits) and not g1.chunks[cc].misses.any(), cc
    for k0, k1 in zip(e0.keyframes, e1.keyframes):
        if tengine._is_det(k0):
            d0, d1 = e0.segment_keyframe(k0), e1.segment_keyframe(k1)
            np.testing.assert_array_equal(d0["valid"], d1["valid"])
            np.testing.assert_allclose(d1["world_pose"], d0["world_pose"], rtol=0, atol=TOL)
    assert (pathlib.Path(out0) / "occupancy.ply").read_text() == (pathlib.Path(out1) / "occupancy.ply").read_text()
    assert s1["viz_bag"]["/detected_landmarks"] >= 1 and s1["viz_bag"]["/occupancy"] == 1
    assert {t: n for t, (_, n) in trb.bag_info(os.path.join(out1, "viz.bag")).items()} == s1["viz_bag"]


def test_voxel_carve_viz_bag_outputs(three_runs):
    """``--voxel --carve --viz-bag-detections``: occupancy.ply and viz.bag
    written; the carving map holds the plain map's hits (its extra chunks
    are carve-only) and misses."""
    _, _, g0, _ = three_runs["npz"]
    _, s2, g2, out2 = three_runs["bag"]
    for name in ("occupancy.ply", "viz.bag"):
        assert os.path.getsize(os.path.join(out2, name)) > 0, name
    assert set(g0.chunks) <= set(g2.chunks)
    for cc, g in g2.chunks.items():
        if cc in g0.chunks:
            assert torch.equal(g.hits, g0.chunks[cc].hits), cc
        else:
            assert not g.hits.any() and g.misses.any(), cc
    assert sum(int(g.misses.sum()) for g in g2.chunks.values()) > 0
    assert s2["viz_bag"]["/detected_landmarks"] >= 1 and s2["viz_bag"]["/occupancy"] == 1
    assert {t: n for t, (_, n) in trb.bag_info(os.path.join(out2, "viz.bag")).items()} == s2["viz_bag"]


def test_nan_invalid_pixels_map_like_zeros():
    """Fault 1: a full-width log and its twin with NaN at every invalid pixel
    (what a PointCloud2 carries) give the same keyframes, landmarks and
    poses. On the JAX frontend's arithmetic the twin maps 0 landmarks where
    the log maps 3 (this log, crop 16, f64)."""
    base = tcfg.PROFILES["yolo_detector"]
    cfg = base.replace(
        solver=dataclasses.replace(base.solver, dtype="float64"),
        capacity=tcfg.CapacityConfig(max_keyframes=64, max_landmarks=16, max_odom_edges=64, max_landmark_edges=256,
                                     max_detections_per_frame=base.capacity.max_detections_per_frame),
        segmentation=dataclasses.replace(base.segmentation, crop_height=16, crop_width=16, num_hypotheses=16),
    )
    log = tsynth.make_synthetic_log(seed=0, n_steps=18, sensor_every=6, loops=1, H=480, W=640)
    twin = dataclasses.replace(log, clouds=[
        dataclasses.replace(c, points=np.where(c.valid[..., None], c.points, np.float32(np.nan))) for c in log.clouds])
    assert all(np.isnan(c.points[~c.valid]).all() for c in twin.clouds)
    engines = []
    for lg in (log, twin):
        e = tengine.SlamEngine(cfg, device="cpu")
        treplay.replay(lg, e)
        engines.append(e)
    a, b = engines
    assert len(a.keyframes) == len(b.keyframes) == 10
    assert int(a.table.count) == int(b.table.count) >= 3
    assert int(a.graph.num_edges()) == int(b.graph.num_edges())
    np.testing.assert_allclose(b.get_keyframe_poses(), a.get_keyframe_poses(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.get_mapped_landmarks()["pose"], a.get_mapped_landmarks()["pose"], rtol=0,
                               atol=1e-12)
