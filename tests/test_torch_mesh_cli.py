"""``cli run --devices N`` and the engine's capacities on gloo CPU ranks
(f64), on ``test_torch_mesh_engine.py``'s session log and configuration:
  * ``cli run --devices 2 --device cpu`` against ``--devices 1``: the same
    summary and outputs;
  * capacity rounding (K, E1, E2 up to a multiple of the ranks) and growth
    that keeps them divisible, on 4 ranks;
  * more ranks than the host has cores is a ``ValueError``.
Each mesh's timeout (30 s) bounds every wait on its ranks.
"""

import json

import numpy as np
import pytest

from semantic_slam_tpu.config import CapacityConfig
from semantic_slam_tpu.io import replay as jreplay
from semantic_slam_tpu_torch import cli as tcli
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_torch_lifecycle import to_port
from test_torch_mesh_engine import MESHES, mesh_config
from test_torch_mesh_engine import session_log  # noqa: F401 (a module fixture)
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

PROFILE = "mesh_test"


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


def test_capacity_rounding_and_growth_divisibility(session_log):
    cfg = mesh_config(4, caps=CapacityConfig(max_keyframes=10, max_landmarks=8, max_odom_edges=10,
                                             max_landmark_edges=30, max_detections_per_frame=6))
    te = TorchEngine(to_port(cfg), device="cpu", mesh=MESHES.get(4))
    assert [te.graph.poses.shape[0], te.graph.odom_i.shape[0], te.graph.lme_k.shape[0]] == [12, 12, 32]
    jreplay.replay(session_log, te)
    assert len(te.keyframes) > 12  # grown
    for a in (te.graph.poses, te.graph.odom_i, te.graph.lme_k):
        assert a.shape[0] % 4 == 0


def test_too_many_devices_raises():
    with pytest.raises(ValueError, match="num_devices"):
        TorchEngine(to_port(mesh_config(10 ** 5)), device="cpu")


def test_cli_run_devices_matches_single(session_log, tmp_path):
    """``cli run --devices 2 --device cpu`` against ``--devices 1``: the
    same summary and outputs (the CLI's engine opens and closes its own
    mesh, so the module's is closed first)."""
    MESHES.close()
    from semantic_slam_tpu_torch.io import replay as treplay

    log_path = str(tmp_path / "log.npz")
    treplay.save_log(log_path, session_log)
    cfg = mesh_config(1)

    def run(devices):
        out = tmp_path / f"out{devices}"
        tcli.main(["run", "--log", log_path, "--profile", PROFILE, "--out", str(out), "--compute-ate",
                   "--device", "cpu", "--devices", str(devices)])
        with open(out / "summary.json") as f:
            return np.loadtxt(out / "robot_pose.txt"), json.load(f)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tcfg.PROFILES, PROFILE, to_port(cfg))
        t1, s1 = run(1)
        t2, s2 = run(2)
    for k in ("keyframes", "landmarks", "edges", "optimize_calls"):
        assert s2[k] == s1[k], k
    assert s1["keyframes"] > 5
    np.testing.assert_allclose(t2, t1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(s2["ate_rmse_optimized"], s1["ate_rmse_optimized"], atol=1e-6)

