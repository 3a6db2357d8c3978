"""The port stands alone.

No module of ``semantic_slam_tpu_torch/`` and nothing in ``chip_smoke.py``
imports ``jax``, the JAX package ``semantic_slam_tpu`` or ``__graft_entry__``
(an ``ast`` scan of every import statement and every
``importlib.import_module`` call with a literal name). And the port's copies
of the JAX package's jax-free modules (``config``, ``core/np_geometry``,
``runtime/keyframe_gate``, ``io/{replay,synthetic,tum,dump}``, ``eval/ate``,
``io/{rosbag,rosbag_write}``, ``viz/rviz_bag``, ``utils/profiling``'s
``Metrics`` and ``log_optimize``) give what their originals give on the
same inputs, exactly, and ``native/slamlog.cpp`` is the JAX package's
source byte for byte.
"""

import ast
import dataclasses
import pathlib

import numpy as np

from semantic_slam_tpu import config as jcfg
from semantic_slam_tpu.core import np_geometry as jnpg
from semantic_slam_tpu.eval import ate as jate
from semantic_slam_tpu.io import dump as jdump
from semantic_slam_tpu.io import replay as jreplay
from semantic_slam_tpu.io import synthetic as jsyn
from semantic_slam_tpu.io import tum as jtum
from semantic_slam_tpu.runtime.keyframe_gate import KeyframeGate as JGate
from semantic_slam_tpu.utils import profiling as jprof
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch.core import np_geometry as tnpg
from semantic_slam_tpu_torch.eval import ate as tate
from semantic_slam_tpu_torch.io import dump as tdump
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import synthetic as tsyn
from semantic_slam_tpu_torch.io import tum as ttum
from semantic_slam_tpu_torch.runtime.keyframe_gate import KeyframeGate as TGate
from semantic_slam_tpu_torch.utils import profiling as tprof

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "semantic_slam_tpu", "__graft_entry__"}


def _imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.append(node.args[0].value)
    return names


def test_no_jax_imports():
    files = sorted((REPO / "semantic_slam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    # the plane-landmark modules are among them
    rel = {str(f.relative_to(REPO)) for f in files}
    assert {f"semantic_slam_tpu_torch/{m}.py" for m in ("graph/planes", "frontend/hull", "solver/plane_ba")} <= rel
    # and the ROS surface's
    assert {f"semantic_slam_tpu_torch/{m}.py" for m in ("io/rosbag", "io/rosbag_write", "viz/rviz_bag", "mapping/voxel",
                                                         "native/__init__")} <= rel
    # and the breadth modules': fitness information, the profiling copy
    assert {f"semantic_slam_tpu_torch/{m}.py" for m in ("solver/information", "utils/profiling", "core/frames",
                                                         "frontend/normals", "frontend/segmentation")} <= rel
    # and the several-rank modules' and the last frontend modules'
    assert {f"semantic_slam_tpu_torch/{m}.py" for m in ("parallel/dist", "parallel/sharded", "frontend/filters",
                                                         "frontend/kmeans")} <= rel
    bad = {str(f.relative_to(REPO)): n for f in files for n in _imported_names(f) if n.split(".")[0] in FORBIDDEN}
    assert not bad, bad
    # the scan sees what it looks for
    assert {"semantic_slam_tpu", "semantic_slam_tpu.io"} <= set(_imported_names(pathlib.Path(__file__)))


def test_mesh_workers_load_no_jax():
    """A mesh's spawned workers (``parallel/dist.py``) hold no module of
    JAX or of the JAX package, though this process (rank 0) holds both."""
    from semantic_slam_tpu_torch.parallel import dist

    mesh = dist.make_mesh(2, device="cpu", timeout_s=30.0)
    try:
        loaded = mesh.forbidden_modules()
    finally:
        mesh.close()
    assert "jax" in loaded[0] and "semantic_slam_tpu" in loaded[0]
    assert loaded[1:] == [[]]


def test_config_copy_equal():
    assert tcfg.SEMANTIC_CLASSES == jcfg.SEMANTIC_CLASSES and tcfg.CLASS_TO_ID == jcfg.CLASS_TO_ID
    assert (tcfg.PLANE_VERTICAL, tcfg.PLANE_HORIZONTAL) == (jcfg.PLANE_VERTICAL, jcfg.PLANE_HORIZONTAL)
    assert sorted(tcfg.PROFILES) == sorted(jcfg.PROFILES)
    for name, cfg in jcfg.PROFILES.items():
        assert dataclasses.asdict(tcfg.PROFILES[name]) == dataclasses.asdict(cfg), name
    assert dataclasses.asdict(tcfg.SlamConfig()) == dataclasses.asdict(jcfg.SlamConfig())


def _assert_logs_equal(a, b):
    for field in ("odom", "clouds", "depths", "detections", "gt"):
        ea, eb = getattr(a, field), getattr(b, field)
        assert len(ea) == len(eb), field
        for x, y in zip(ea, eb):
            for f in dataclasses.fields(y):
                va, vb = getattr(x, f.name), getattr(y, f.name)
                if isinstance(vb, np.ndarray):
                    assert va.dtype == vb.dtype, (field, f.name)
                    np.testing.assert_array_equal(va, vb, err_msg=f"{field}.{f.name}")
                else:
                    assert va == vb, (field, f.name)


def test_synthetic_log_and_replay_io_equal(tmp_path):
    kw = dict(seed=0, n_steps=60, sensor_every=6, H=48, W=64, loops=1)
    tlog, jlog = tsyn.make_synthetic_log(**kw), jsyn.make_synthetic_log(**kw)
    _assert_logs_equal(tlog, jlog)
    assert tlog.clouds and tlog.detections and tlog.gt
    _assert_logs_equal(tsyn.clouds_to_depth(tlog), jsyn.clouds_to_depth(jlog))
    # each package reads the other's .npz
    treplay.save_log(str(tmp_path / "t.npz"), tlog)
    jreplay.save_log(str(tmp_path / "j.npz"), jlog)
    _assert_logs_equal(jreplay.load_log(str(tmp_path / "t.npz")), treplay.load_log(str(tmp_path / "j.npz")))


def test_ate_tum_and_geometry_equal(tmp_path):
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 20, 200))
    gt = np.cumsum(rng.normal(size=(200, 3)) * 0.1, axis=0)
    est = gt + rng.normal(size=gt.shape) * 0.05
    for fn in ("ate_rmse", "rpe_rmse"):
        assert getattr(tate, fn)(t, est, t + 0.01, gt) == getattr(jate, fn)(t, est, t + 0.01, gt)
    q = rng.normal(size=(200, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([est, q], axis=-1)
    ttum.write_tum(str(tmp_path / "t.txt"), t, poses)
    jtum.write_tum(str(tmp_path / "j.txt"), t, poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for a, b in zip(ttum.read_tum(str(tmp_path / "j.txt")), jtum.read_tum(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(a, b)

    p, xi = poses[:20], rng.normal(size=(20, 6)) * 0.3
    for fn, args in (("pose_mul", (p, p[::-1])), ("pose_inv", (p,)), ("pose_retract", (p, xi)),
                     ("pose_ned_to_enu", (p[0],)), ("pose_cam_to_robot_odom", (p[0],)), ("rot_pose_z", (p[0], 0.3)),
                     ("pose_to_xyzrpy", (p[0],)), ("t_cam_world", (np.r_[est[0], 0.1, -0.2, 0.3], 0.2))):
        np.testing.assert_array_equal(getattr(tnpg, fn)(*args), getattr(jnpg, fn)(*args), err_msg=fn)

    tg, jg = TGate(), JGate()
    for k in range(200):
        assert tg.update(poses[k], float(t[k])) == jg.update(poses[k], float(t[k])), k


def test_keyframe_dumps_equal(tmp_path):
    """``dump_keyframes``: the same files, byte for byte, for keyframes with
    and without a graph node (``node_idx`` None) and fractional stamps."""
    import types

    rng = np.random.default_rng(2)
    kfs = []
    for i in range(5):
        q = rng.normal(size=4)
        kfs.append(types.SimpleNamespace(
            stamp=float(rng.uniform(0, 1e4)), odom=np.r_[rng.normal(size=3) * 50, q / np.linalg.norm(q)],
            accum_distance=float(rng.uniform(0, 30)), node_idx=None if i == 3 else i))
    engine = types.SimpleNamespace(keyframes=kfs)
    tdump.dump_keyframes(str(tmp_path / "t"), engine)
    jdump.dump_keyframes(str(tmp_path / "j"), engine)
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("data"))
    assert len(files) == 5
    assert sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("data")) == files
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_slamlog_source_is_the_jax_packages():
    """The port builds its own copy of the .slog library's source."""
    got = (REPO / "semantic_slam_tpu_torch" / "native" / "slamlog.cpp").read_bytes()
    assert got == (REPO / "semantic_slam_tpu" / "native" / "slamlog.cpp").read_bytes()


def test_bag_copies_equal(tmp_path):
    """``io/rosbag_write``'s bytes, ``io/rosbag``'s log and ``viz/rviz_bag``'s
    bytes from the same inputs (a tiny log; a stand-in engine)."""
    import types

    from semantic_slam_tpu.io import rosbag as jrb
    from semantic_slam_tpu.io import rosbag_write as jrw
    from semantic_slam_tpu.viz import rviz_bag as jviz
    from semantic_slam_tpu_torch.io import rosbag as trb
    from semantic_slam_tpu_torch.io import rosbag_write as trw
    from semantic_slam_tpu_torch.viz import rviz_bag as tviz

    kw = dict(seed=1, n_steps=20, sensor_every=5, H=12, W=16, loops=1)
    for comp in ("none", "bz2"):
        assert (trw.write_bag(str(tmp_path / f"t{comp}.bag"), tsyn.make_synthetic_log(**kw), comp)
                == jrw.write_bag(str(tmp_path / f"j{comp}.bag"), jsyn.make_synthetic_log(**kw), comp))
        assert (tmp_path / f"t{comp}.bag").read_bytes() == (tmp_path / f"j{comp}.bag").read_bytes()
        _assert_logs_equal(trb.read_bag(str(tmp_path / f"j{comp}.bag")), jrb.read_bag(str(tmp_path / f"j{comp}.bag")))
    assert trb.DEFAULT_TOPIC_MAP == jrb.DEFAULT_TOPIC_MAP

    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 4))
    poses = np.concatenate([rng.normal(size=(6, 3)), q / np.linalg.norm(q, axis=-1, keepdims=True)], axis=-1)
    engine = types.SimpleNamespace(
        keyframes=[types.SimpleNamespace(stamp=0.5 * i, odom=poses[i]) for i in range(6)],
        get_keyframe_poses=lambda: poses, vio_traj=[(0.25 * i, poses[i // 2]) for i in range(12)],
        get_map2odom=lambda: poses[0],
        get_mapped_landmarks=lambda: {"pose": rng.normal(size=(3, 3)), "class_id": np.array([0, 5, 9]),
                                      "plane_type": np.array([0, 1, 1])})
    lms = engine.get_mapped_landmarks()
    engine.get_mapped_landmarks = lambda: lms
    centers = rng.normal(size=(7, 3))
    grid = types.SimpleNamespace(resolution=0.05)
    for stride in (1, 4):
        assert (tviz.write_viz_bag(str(tmp_path / "t.bag"), engine, grid, path_stride=stride, voxel_centers=centers)
                == jviz.write_viz_bag(str(tmp_path / "j.bag"), engine, grid, path_stride=stride,
                                      voxel_centers=centers))
        assert (tmp_path / "t.bag").read_bytes() == (tmp_path / "j.bag").read_bytes()


def test_profiling_copies_equal():
    """``Metrics`` and ``log_optimize`` are the JAX package's source, line
    for line (the port's module adds its own trace context beside them)."""
    import inspect

    for name in ("Metrics", "log_optimize"):
        assert inspect.getsource(getattr(tprof, name)) == inspect.getsource(getattr(jprof, name)), name
