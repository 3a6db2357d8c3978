"""The port's plane and fixed-lag sessions on 2 gloo CPU ranks against the
port's own single-device sessions (f64; each held to the JAX engine by
``test_torch_planes_engine.py`` and ``test_torch_fixed_lag_engine.py``), on
``test_torch_mesh_engine.py``'s session log and configuration (the 4-rank
session against the JAX engine's is there): equal counts, poses within
1e-6. Each mesh's timeout (30 s) bounds every wait on its ranks.
"""

import numpy as np
import pytest

from semantic_slam_tpu.config import MeshConfig
from test_torch_mesh_engine import MESHES, _same_map, mesh_config, port_session
from test_torch_mesh_engine import session_log  # noqa: F401 (a module fixture)
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)


@pytest.fixture(scope="module", autouse=True)
def _close_mesh():
    yield
    MESHES.close()


@pytest.mark.parametrize("kind", ["planes", "fixed_lag"])
def test_mesh_sessions_match_one_device(session_log, kind):
    cfg = mesh_config(2, planes=kind == "planes", fixed_lag=8 if kind == "fixed_lag" else 0)
    te = port_session(cfg, session_log, 2)
    ref = port_session(cfg.replace(mesh=MeshConfig(num_devices=1)), session_log, 1)
    _same_map(te, ref, 1e-6)
    assert te._kf_base == ref._kf_base
    if kind == "planes":
        assert int(te.plane_nodes.num_pe) == int(ref.plane_nodes.num_pe) > 0
        np.testing.assert_allclose(te.plane_nodes.planes.numpy(), ref.plane_nodes.planes.numpy(), atol=1e-6)
    else:
        assert te._kf_base >= 8
