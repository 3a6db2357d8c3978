"""Synthetic window-tick inputs (port of
``semantic_slam_tpu.parallel.window_inputs``): B detection-bearing
keyframes, each an organized cam-frame cloud with a camera-facing plane at
z ~= 2 m inside one whitelisted bounding box, enough for the frontend to
extract a plane and association to map landmarks. The JAX module builds
them for the mesh-sharded window step; here they are the keyword arguments
of the engine's ``_process_keyframes_window`` (one device), for the tests
and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from semantic_slam_tpu_torch.config import CLASS_TO_ID


def make_window_inputs(B: int, dtype=torch.float32, device="cuda", H: int = 32, W: int = 32):
    """Returns (graph, table, args, statics): ``args`` the tensors and
    parameter dicts of ``runtime.engine._process_keyframes_window`` after
    ``table``, ``statics`` its keyword statics. Capacities, values and
    statics are the JAX module's at ``n_devices=1``."""
    from semantic_slam_tpu_torch.assoc import association as assoc_mod
    from semantic_slam_tpu_torch.graph import state as gs

    K = max(16, B + 2)
    graph = gs.make_graph(K, 8, K, 4 * K, dtype=dtype, device=device)
    table = assoc_mod.make_table(8, dtype=dtype, device=device)

    # keyframes along +x, 0.5 m apart (identity orientation)
    ident = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
    odoms = np.tile(ident, (B, 1))
    odoms[:, 0] = 0.5 * np.arange(B)
    robot_xyzrpy = np.zeros((B, 6))
    robot_xyzrpy[:, 0] = odoms[:, 0]

    # organized cloud: camera-facing plane at z = 2 (a deterministic ripple,
    # so that normals are not degenerate-exact); the box covers the center
    u = (np.arange(W) - W / 2) / (W / 2) * 1.5
    v = (np.arange(H) - H / 2) / (H / 2) * 1.5
    xx, yy = np.meshgrid(u, v)
    zz = 2.0 + 0.002 * np.sin(3 * xx) * np.cos(2 * yy)
    points = np.tile(np.stack([xx, yy, zz], axis=-1)[None], (B, 1, 1, 1))
    boxes = np.tile(np.array([[4.0, 4.0, W - 8.0, H - 8.0]]), (B, 1, 1))  # [B,1,4] tl_x, tl_y, w, h

    npdt = np.float64 if dtype == torch.float64 else np.float32

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    args = dict(
        odoms=t(odoms), prev_odom7=t(ident), has_prev=False, info6=t(np.eye(6) * 100.0),
        points=t(points), cloud_valid=t(np.ones((B, H, W), bool), torch.bool), cam_intr=None, depth_scale=None,
        boxes=t(boxes), class_ids=t(np.full((B, 1), CLASS_TO_ID["chair"], np.int32), torch.int32),
        probs=t(np.full((B, 1), 0.9)), robot_xyzrpy=t(robot_xyzrpy), cam_angle=t(npdt(0.0)),
        # the JAX module's scalars, rounded to the dtype as the engine stages them
        seg_params={"num_point_seg": 20.0, "norm_point_thres": 50.0, "planar_area": 0.0,
                    "distance_thres": float(npdt(0.05)), "cos_angular_thres": float(npdt(np.cos(np.deg2rad(5.0))))},
        assoc_params={"use_maha": False, "maha_thres": 1.5, "eq_thres": 1.5, "land_noise": float(npdt(0.1)),
                      "use_plane_gate": False, "plane_cos_thres": float(npdt(0.9)), "plane_offset_thres": 0.5},
        lm_info3=t(np.eye(3) * 10.0),
    )
    statics = dict(samp_h=24, samp_w=24, max_planes=1, num_hypotheses=16, smoothing_size=5, strict_frames=True,
                   use_rtabmap_offset=False, depth_input=False)
    return graph, table, args, statics
