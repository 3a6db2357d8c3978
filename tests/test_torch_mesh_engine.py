"""The port's engine and distributed checkpoint on several gloo CPU ranks,
against the JAX engine's mesh session (f64). The plane and fixed-lag
sessions on ranks are in ``test_torch_mesh_sessions.py``, the CLI and the
capacities in ``test_torch_mesh_cli.py``, the merge's joint BA in
``test_torch_mesh_window.py``.

One short synthetic session (240 steps, seed 3, 96x128 clouds; ~20
keyframes) with Mahalanobis gating (the marginals run every optimizing
tick), ``linear_solver="pcg"`` with 32 CG steps, capacities 32 (no growth,
so that the JAX engine compiles one set of programs):
  * the port on 4 ranks against the JAX engine on its 4-device mesh with
    ``SLAM_SOLVER_IMPL=soa_dist`` (its row-range loop; stored: ``REF``,
    ``tests/jax_golden.py``): equal keyframes,
    landmarks and edges, poses and covariances within 1e-6, and the
    ``host_state.json`` of ``io.checkpoint.save_checkpoint_dist`` equal to
    the JAX package's ``_engine_host_meta`` (its orbax route's host state;
    the times of the solves aside);
  * the distributed checkpoint bit for bit and resumed like the npz route.
Each mesh's timeout (30 s) bounds every wait on its ranks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu.config import AssociationConfig, CapacityConfig, MeshConfig
from semantic_slam_tpu.io import replay as jreplay
from semantic_slam_tpu.io import synthetic as jsynth
from semantic_slam_tpu_torch.assoc.association import TABLE_FIELDS
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.io import checkpoint as tckpt
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_e2e import e2e_config
from test_torch_lifecycle import to_port
from torch_cases import MeshCache, one_torch_thread  # noqa: F401 (a module fixture)

MESHES = MeshCache(timeout_s=30.0)


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


def mesh_config(n: int, planes: bool = False, fixed_lag: int = 0, caps=None):
    cfg = e2e_config().replace(
        association=AssociationConfig(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4),
        capacity=caps or CapacityConfig(max_keyframes=32, max_landmarks=32, max_odom_edges=32, max_landmark_edges=256,
                                        max_detections_per_frame=4),
        mesh=MeshConfig(num_devices=n), use_plane_landmarks=planes,
    )
    return cfg.replace(solver=dataclasses.replace(cfg.solver, linear_solver="pcg", pcg_iters=32,
                                                  fixed_lag_window=fixed_lag, fixed_lag_chunk=8 if fixed_lag else 0))


LOG = dict(seed=3, n_steps=240, sensor_every=5, drift_noise=0.008, H=96, W=128)


@pytest.fixture(scope="module")
def session_log():
    return jsynth.make_synthetic_log(**LOG)


def port_session(cfg, log, n: int):
    te = TorchEngine(to_port(cfg), device="cpu", mesh=MESHES.get(n) if n > 1 else None)
    jreplay.replay(log, te)
    return te


def jax_session(cfg, log, impl) -> dict:
    """The JAX engine on its 4-device mesh with the loop ``impl`` forced
    (``SLAM_SOLVER_IMPL``), and its ``_engine_host_meta``."""
    import jax

    from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLAM_SOLVER_IMPL", impl)
        jax.clear_caches()
        je = JaxEngine(cfg)
        jreplay.replay(log, je)
        out = jax_golden.engine_outputs(je, host_meta=True)
    jax.clear_caches()
    return out


# the JAX package's session, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_mesh_engine", tol=1e-6)


@pytest.fixture(scope="module")
def sessions(session_log):
    """The JAX engine's stored session on its 4-device mesh and the port on
    4 ranks."""
    cfg = mesh_config(4)
    return jax_golden.EngineSnapshot(REF(jax_session, cfg, session_log, "soa_dist")), port_session(cfg, session_log, 4)


def _same_map(te, ref, tol):
    assert len(te.keyframes) == len(ref.keyframes) > 5
    for f in ("num_poses", "num_landmarks", "num_odom", "num_lme"):
        assert int(getattr(te.graph, f)) == int(getattr(ref.graph, f)), f
    assert int(te.table.count) == int(ref.table.count) > 0
    n = int(ref.graph.num_poses)
    np.testing.assert_allclose(np.asarray(te.graph.poses[:n]), np.asarray(ref.graph.poses[:n]), atol=tol, rtol=0)
    np.testing.assert_allclose(te.robot_pose, ref.robot_pose, atol=tol, rtol=0)


def test_mesh_session_matches_jax(sessions):
    je, te = sessions
    assert te.graph.poses.shape[0] % 4 == 0 and te._mesh.size == 4
    _same_map(te, je, 1e-6)
    c = int(je.table.count)
    np.testing.assert_allclose(np.asarray(te.table.cov[:c]), np.asarray(je.table.cov[:c]), atol=1e-6, rtol=0)
    assert [s["iterations"] for s in te.stats_history] == [s["iterations"] for s in je.stats_history]


def _assert_meta_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            if k != "solve_seconds":
                _assert_meta_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_meta_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=path)
    else:
        assert got == want, path


def test_host_state_matches_jax_orbax_route(sessions, tmp_path):
    """The host state ``save_checkpoint_dist`` writes is the JAX package's
    ``host_state.json`` for the same session (its orbax route writes
    ``_engine_host_meta``; orbax itself is a JAX library)."""
    je, te = sessions
    tckpt.save_checkpoint_dist(str(tmp_path / "ck"), te)
    with open(tmp_path / "ck" / "host_state.json") as f:
        got = json.load(f)
    _assert_meta_equal(got, je.host_meta)


def test_dist_checkpoint_round_trip_and_resume(sessions, tmp_path):
    """``save_checkpoint_dist`` -> ``load_checkpoint_dist`` restores the
    mesh session bit for bit; a forced optimize from it and from the npz
    route's checkpoint of the same session agree bit for bit."""
    _, te = sessions
    tckpt.save_checkpoint_dist(str(tmp_path / "d"), te)
    tckpt.save_checkpoint(str(tmp_path / "n.npz"), te)
    cfg = to_port(mesh_config(4))
    a = TorchEngine(cfg, device="cpu", mesh=MESHES.get(4))
    tckpt.load_checkpoint_dist(str(tmp_path / "d"), a)
    for name, fields in (("graph", tgs.FIELDS), ("table", TABLE_FIELDS), ("prior", te.prior._fields)):
        for f in fields:
            assert torch.equal(getattr(getattr(a, name), f), getattr(getattr(te, name), f)), (name, f)
    assert torch.equal(a.marginals, te.marginals)
    assert [k.node_idx for k in a.keyframes] == [k.node_idx for k in te.keyframes]
    assert a.stats_history == te.stats_history and a._n_lme == te._n_lme
    b = TorchEngine(cfg, device="cpu", mesh=MESHES.get(4))
    tckpt.load_checkpoint(str(tmp_path / "n.npz"), b)
    a.finalize()
    b.finalize()
    assert a.stats_history[-1]["iterations"] == b.stats_history[-1]["iterations"] > 0
    assert torch.equal(a.graph.poses, b.graph.poses) and torch.equal(a.table.cov, b.table.cov)
