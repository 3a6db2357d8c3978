"""A cell cut to a size the CPU runs in seconds: 160x120 clouds (a 310x94
depth image for the drive), 32x32 crops, 32 hypotheses, lowered frontend
gates (at this size the profiles' area gates map nothing), small
capacities and, for the drive, a 16-keyframe lag with the dense solver.
The tests hold these runs to the cells' own limits. ``CELLS`` holds the
benchmark's cell and the cells left out of it for a fault of the program
at their full size (their configurations, mixes and limits stay), so that
each traffic mode is driven."""

from __future__ import annotations

from slam_bench import check, registry, run

SEED = 1234567891234


CELLS = {
    "indoor7_160.live": ("indoor7_160", "live"),
    "indoor7.live": ("indoor7_640", "live"),
    "indoor7.window8": ("indoor7_640", "window8"),
    "kitti00.fixedlag64": ("kitti00_cars", "drive"),
}


def cell(name: str) -> tuple[dict, dict]:
    config, traffic = CELLS[name]
    cfg, tr = registry.config(config), registry.traffic(traffic)
    sc = cfg["scene"]
    if sc["kind"] == "dense_indoor":
        sc.update(height=120, width=160, fx=150.0, fy=150.0, cx=80.0, cy=60.0, steps_per_round=120)
        cfg["capacity"].update(max_keyframes=128, max_landmarks=64, max_odom_edges=128, max_landmark_edges=512)
    else:
        sc.update(height=94, width=310, fx=179.7, fy=179.7, cx=151.8, cy=46.3, frames=240)
        cfg["capacity"].update(max_keyframes=128, max_landmarks=256, max_odom_edges=128, max_landmark_edges=512)
        cfg["solver"].update(fixed_lag_window=16, fixed_lag_chunk=8, linear_solver="dense")
    cfg["segmentation"] = {"crop_height": 32, "crop_width": 32, "num_hypotheses": 32, "norm_point_thres": 200,
                           "num_point_seg": 50, "planar_area": 0.05}
    tr["check_every"] = 2
    return cfg, tr


def run_tiny(name: str, seconds: float = 3.0, **kw) -> dict:
    cfg, tr = cell(name)
    return run.run_cell(name, cfg, tr, SEED, seconds, False, "cpu", check.load_limits(name), **kw)
