"""The port's g2o export and engine checkpoints against the JAX package, on
the CPU, in f64.

* g2o: the port's ``save_g2o`` writes ``tests/golden/conformance.g2o`` byte
  for byte from ``test_g2o_conformance._fixture_graph``, and the JAX
  package's text for a session's graph; ``load_g2o`` reads the golden back
  to the JAX loader's arrays exactly.
* Checkpoints: one port session (fixed-lag window 8, Mahalanobis gating,
  capacities that double) is saved and loaded into a fresh port engine
  (every tensor and host field exactly), into a JAX engine (port to JAX),
  and saved again by that JAX engine and loaded into the port (JAX to
  port: the file holds the JAX package's plane nodes and plane prior, all
  empty, which the port's point-landmark engine drops). Loaded into an f32
  engine, the f64 arrays take the engine's dtype. Plane-landmark sessions'
  files are held in ``tests/test_torch_planes_engine.py``.

No JAX session runs here: the JAX side is its loaders, savers and engine
constructor.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from semantic_slam_tpu.config import AssociationConfig, CapacityConfig
from semantic_slam_tpu.io import checkpoint as jckpt
from semantic_slam_tpu.io import g2o_io as jg2o
from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine
from semantic_slam_tpu_torch.assoc.association import TABLE_FIELDS
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.io import checkpoint as tckpt
from semantic_slam_tpu_torch.io import g2o_io as tg2o
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from semantic_slam_tpu_torch.solver import fixed_lag as tfl
from test_e2e import e2e_config
from test_g2o_conformance import GOLDEN, _fixture_graph
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

JAX_STATS_KEYS = {"iterations", "chi2_initial", "chi2_final", "solve_seconds", "num_poses", "num_landmarks",
                  "num_edges"}


def session_config(dtype="float64"):
    """Fixed-lag window 8 (chunk 8) with Mahalanobis gating at capacities
    that double during the session."""
    cfg = e2e_config().replace(
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0,
                                      land_noise_low=0.4),
        capacity=CapacityConfig(max_keyframes=8, max_landmarks=16, max_odom_edges=8, max_landmark_edges=32,
                                max_detections_per_frame=4),
    )
    return cfg.replace(solver=dataclasses.replace(cfg.solver, fixed_lag_window=8, fixed_lag_chunk=8, dtype=dtype))


@pytest.fixture(scope="module")
def port_session():
    log = tsynth.make_synthetic_log(seed=3, n_steps=240, sensor_every=5, drift_noise=0.008, H=96, W=128)
    engine = TorchEngine(session_config(), device="cpu")
    treplay.replay(log, engine)
    assert engine._kf_base >= 8 and engine.graph.max_poses > 8 and int(engine.table.count) > 0
    return engine


@pytest.fixture(scope="module")
def port_file(port_session, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    tckpt.save_checkpoint(path, port_session)
    return path


@pytest.fixture(scope="module")
def jax_round_trip(port_file, tmp_path_factory):
    """The port's checkpoint loaded into a JAX engine, which saves it again."""
    je = JaxEngine(session_config())
    jckpt.load_checkpoint(port_file, je)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_checkpoint(path, je)
    return je, path


# ---------------------------------------------------------------------------
# g2o
# ---------------------------------------------------------------------------


def _port_graph(jg):
    return tgs.graph_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})


def test_save_g2o_matches_golden(tmp_path):
    path = tmp_path / "out.g2o"
    tg2o.save_g2o(str(path), _port_graph(_fixture_graph()))
    assert path.read_bytes() == GOLDEN.read_bytes()


def test_load_g2o_round_trips_golden(tmp_path):
    """The port's loader gives the JAX loader's arrays (capacities, counts,
    values) exactly, and writes the golden again."""
    tg = tg2o.load_g2o(str(GOLDEN))
    jg = jg2o.load_g2o(str(GOLDEN))
    for f in tgs.FIELDS:
        want = np.asarray(getattr(jg, f))
        got = getattr(tg, f).numpy()
        assert got.dtype == (np.int32 if f in tgs._INT_FIELDS else np.float64), f
        np.testing.assert_array_equal(got, want, err_msg=f)
    path = tmp_path / "again.g2o"
    tg2o.save_g2o(str(path), tg)
    assert path.read_bytes() == GOLDEN.read_bytes()


def test_save_g2o_session_graph_equals_jax(port_session, tmp_path):
    """A session's graph (grown capacities, inactive rows past the counts):
    the two packages write the same text."""
    g = port_session.graph
    tg2o.save_g2o(str(tmp_path / "t.g2o"), g)
    jg = jg2o.GraphState(**{k: np.asarray(v) for k, v in tgs.graph_to_numpy(g).items()})
    jg2o.save_g2o(str(tmp_path / "j.g2o"), jg)
    text = (tmp_path / "t.g2o").read_text()
    assert text == (tmp_path / "j.g2o").read_text()
    assert text.count("EDGE_SE3_TRACKXYZ") == int(g.num_lme) > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _assert_same_state(te, ref, exact=True):
    """Every checkpointed field of the port engine ``te`` against ``ref``
    (a port engine, or a JAX one)."""

    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def same(got, want, name):
        got, want = host(got), host(want)
        assert got.shape == want.shape, name
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)

    for f in tgs.FIELDS:
        same(getattr(te.graph, f), getattr(ref.graph, f), f"g_{f}")
    for f in TABLE_FIELDS:
        same(getattr(te.table, f), getattr(ref.table, f), f"t_{f}")
    # the prior's point fields: a point session's plane part is empty in the
    # port and sized like the landmark table in the JAX engine, and neither
    # is a point checkpoint's (the port writes none)
    for f in tfl.MarginalPrior._fields:
        if f not in tckpt.PLANE_PRIOR:
            same(getattr(te.prior, f), getattr(ref.prior, f), f"fl_{f}")
    same(te.marginals, ref.marginals, "marginals")
    same(np.asarray(te.archived_poses), np.asarray(ref.archived_poses), "fl_archived")
    for f in ("robot_pose", "vio_pose", "prev_odom", "map2odom"):
        same(getattr(te, f), getattr(ref, f), f)
    for f in ("robot_traj", "vio_traj"):
        a, b = getattr(te, f), getattr(ref, f)
        assert [s for s, _ in a] == [s for s, _ in b], f
        same(np.array([p for _, p in a]), np.array([p for _, p in b]), f)
    assert len(te.keyframes) == len(ref.keyframes)
    for a, b in zip(te.keyframes, ref.keyframes):
        assert (a.stamp, a.accum_distance, a.node_idx) == (b.stamp, b.accum_distance, b.node_idx)
        same(a.odom, b.odom, "odom")
        same(a.robot_pose, b.robot_pose, "kf robot_pose")
    for f in ("is_first", "accum_distance", "prev_time"):
        assert getattr(te.gate, f) == getattr(ref.gate, f), f
    same(te.gate.prev_keypose, ref.gate.prev_keypose, "prev_keypose")
    assert te.first_key_added == ref.first_key_added and te._kf_base == ref._kf_base
    assert (te._n_poses, te._n_landmarks, te._n_odom, te._n_lme) == (
        ref._n_poses, ref._n_landmarks, ref._n_odom, ref._n_lme)
    assert te.stats_history == ref.stats_history


def test_checkpoint_port_to_port_exact(port_session, port_file, tmp_path):
    te = TorchEngine(session_config(), device="cpu")
    tckpt.load_checkpoint(port_file, te)
    assert all(k.cloud is None for k in te.keyframes)
    assert te.graph.max_poses == port_session.graph.max_poses > te.cfg.capacity.max_keyframes  # saved capacities
    assert te.prior.Hl.shape[0] == te.graph.max_landmarks
    _assert_same_state(te, port_session)
    assert {k for s in te.stats_history for k in s} == JAX_STATS_KEYS
    again = str(tmp_path / "again.npz")
    tckpt.save_checkpoint(again, te)
    a, b = np.load(port_file), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    assert not any(k.startswith("p_") or k in ("fl_Hpl", "fl_pl_ref", "fl_gpl0") for k in a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_port_to_jax(port_session, jax_round_trip):
    je, _ = jax_round_trip
    _assert_same_state(port_session, je)
    assert int(je.plane_nodes.num_planes) == 0 and je.prior.Hpl.shape[0] == je.plane_nodes.planes.shape[0]


def test_checkpoint_jax_to_port(port_session, jax_round_trip):
    _, path = jax_round_trip
    z = np.load(path)
    assert "p_planes" in z.files and "fl_Hpl" in z.files  # dropped by the port's loader
    te = TorchEngine(session_config(), device="cpu")
    tckpt.load_checkpoint(path, te)
    _assert_same_state(te, port_session)
    assert json.loads(str(z["meta"]))["dtype"] == "float64"


def test_checkpoint_casts_to_engine_dtype(port_session, jax_round_trip):
    """An f64 file loaded into an f32 engine: float arrays take the engine's
    dtype, integer arrays int32, and the session goes on."""
    _, path = jax_round_trip
    te = TorchEngine(session_config("float32"), device="cpu")
    tckpt.load_checkpoint(path, te)
    for f in tgs.FIELDS:
        t = getattr(te.graph, f)
        assert t.dtype == (torch.int32 if f in tgs._INT_FIELDS else torch.float32), f
    for t in (te.table.world, te.marginals, te.prior.Hp, te.prior.Hl):
        assert t.dtype == torch.float32
    assert te.table.count.dtype == te.prior.p_idx.dtype == torch.int32
    _assert_same_state(te, port_session, exact=False)
    assert te.finalize()
    assert np.isfinite(te.stats_history[-1]["chi2_final"])

