"""The port on the card: the CUDA kernel against its plain version, and a
small session on the card against the same session on the CPU.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker
and skips without a GPU. The file imports no JAX, because the machine with
the card has none. Run it there with ``--noconftest``, since the test
package's conftest configures JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from semantic_slam_tpu_torch.frontend import kernels as tk

DIST, COS = 0.5, 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def inputs(seed, D, N, S, device):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(D, N, 3))
    hn = rng.normal(size=(D, S, 3))
    arrays = (
        rng.normal(size=(D, N, 3)),
        nrm / np.linalg.norm(nrm, axis=-1, keepdims=True),
        rng.random((D, N)) > 0.3,
        hn / np.linalg.norm(hn, axis=-1, keepdims=True),
        rng.normal(size=(D, S)),
    )
    return [torch.as_tensor(a, device=device).to(torch.float32 if a.dtype != bool else torch.bool) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65536, 4133, 1], ids=["path-shape", "ragged", "single-point"])
def test_kernel_matches_plain(cuda, N):
    t = inputs(3, 8, N, 128, cuda)
    before = tk.score_hypotheses.launches
    got = tk.score_hypotheses(*t, DIST, COS)
    ref = tk.score_hypotheses_ref(*t, DIST, COS)
    torch.cuda.synchronize()
    assert tk.score_hypotheses.launches == before + 1
    # with these seeded inputs no pair lies within f32 rounding of a
    # threshold, so the FMA kernel and the cuBLAS plain version agree exactly
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_no_candidates(cuda):
    t = inputs(4, 8, 65536, 128, cuda)
    t[2] = torch.zeros_like(t[2])
    assert float(tk.score_hypotheses(*t, DIST, COS).abs().max()) == 0.0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    t = inputs(5, 2, 256, 16, cuda)
    with pytest.raises(TypeError, match="bool"):
        tk.score_hypotheses(t[0], t[1], t[2].float(), t[3], t[4], DIST, COS)
    with pytest.raises(ValueError, match="shape"):
        tk.score_hypotheses(t[0], t[1], t[2], t[3][:, :8], t[4], DIST, COS)
    with pytest.raises(ValueError, match="is on"):
        tk.score_hypotheses(t[0], t[1], t[2].cpu(), t[3], t[4], DIST, COS)


SMALL_SESSIONS = {
    # gating, capacities: (max_keyframes, max_landmark_edges), LM iteration cap
    "euclid": (dict(use_maha_dist=False, use_eq_dist=True, eq_dist_thres=1.0, land_noise_low=0.1), (8, 32), 64),
    "maha": (dict(use_maha_dist=True, use_eq_dist=False, maha_dist_thres=9.0, land_noise_low=0.4), (16, 64), 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("gating", sorted(SMALL_SESSIONS))
def test_small_session_card_matches_cpu(cuda, gating):
    """Same log, same config (f32) on the card and on the CPU: the same map,
    and trajectories within the f32 tolerance 1e-3 (index_add_ and cuBLAS
    sum in other orders than the CPU)."""
    from semantic_slam_tpu.config import (
        AssociationConfig, CapacityConfig, KeyframeConfig, SegmentationConfig, SlamConfig, SolverConfig,
    )
    from semantic_slam_tpu_torch import cli

    assoc, (kf_cap, lme_cap), max_iterations = SMALL_SESSIONS[gating]
    cfg = SlamConfig(
        keyframe=KeyframeConfig(delta_trans=0.4, delta_angle=0.4, delta_time=2.0),
        segmentation=SegmentationConfig(
            num_point_seg=100, norm_point_thres=400, planar_area=0.01, crop_height=64, crop_width=64,
            max_planes_per_detection=2, num_hypotheses=64, normal_smoothing_size=10,
        ),
        association=AssociationConfig(**assoc),
        solver=SolverConfig(max_iterations=max_iterations),
        capacity=CapacityConfig(max_keyframes=kf_cap, max_landmarks=16, max_odom_edges=kf_cap,
                                max_landmark_edges=lme_cap, max_detections_per_frame=4),
    )
    log = cli.make_synthetic_log(seed=3, n_steps=120, sensor_every=5, drift_noise=0.008, H=120, W=160)
    gpu, cpu = cli.run_session(log, cfg, "cuda"), cli.run_session(log, cfg, "cpu")
    assert gpu.graph.poses.device.type == "cuda" and gpu.graph.max_poses > kf_cap  # grew on the card
    for e in (gpu, cpu):
        assert int(e.table.count) > 0
    assert (len(gpu.keyframes), int(gpu.table.count), int(gpu.graph.num_edges())) == (
        len(cpu.keyframes), int(cpu.table.count), int(cpu.graph.num_edges())
    )
    n = int(cpu.graph.num_lme)
    np.testing.assert_array_equal(gpu.graph.lme_l[:n].cpu().numpy(), cpu.graph.lme_l[:n].numpy())
    np.testing.assert_allclose(gpu.get_keyframe_poses(), cpu.get_keyframe_poses(), atol=1e-3)
