"""Visualization exports — the rviz-marker/TF surface without ROS (the
port's own copy of ``semantic_slam_tpu.viz.markers``).

The reference publishes a MarkerArray of mapped landmarks with per-class
colors and h/v-dependent cuboid scales plus keyframe PoseArray/Path topics
(``semantic_graph_slam_ros.cpp:227-388``). Here the same payloads are
exported as JSON (any web/point-cloud viewer) and PLY (landmarks + voxel
map + trajectory) for offline inspection.

The reference's per-class color table is reproduced including its collisions
(book == bucket == blue, laptop == car == yellow — cpp:281-296, cosmetic
quirk 9).
"""

from __future__ import annotations

import json

import numpy as np

from semantic_slam_tpu_torch.config import SEMANTIC_CLASSES

# r, g, b per class id — transcribed from publishLandmarks
# (semantic_graph_slam_ros.cpp:254-296)
CLASS_COLORS: dict[int, tuple[float, float, float]] = {
    0: (0.0, 1.0, 0.0),  # chair: green
    1: (1.0, 0.0, 0.0),  # tvmonitor: red
    2: (0.0, 0.0, 1.0),  # book: blue
    3: (1.0, 0.0, 1.0),  # keyboard: magenta
    4: (1.0, 1.0, 0.0),  # laptop: yellow
    5: (0.0, 0.0, 1.0),  # bucket: blue (collides with book, quirk 9)
    6: (1.0, 1.0, 0.0),  # car: yellow (collides with laptop)
}


def landmarks_to_json(path: str, landmarks: dict) -> None:
    """landmarks: dict from SlamEngine.get_mapped_landmarks()."""
    out = []
    for i in range(len(landmarks["pose"])):
        cid = int(landmarks["class_id"][i])
        hv = int(landmarks["plane_type"][i])
        out.append(
            {
                "id": i,
                "class": SEMANTIC_CLASSES[cid] if 0 <= cid < len(SEMANTIC_CLASSES) else "?",
                "plane_type": "horizontal" if hv == 0 else "vertical",
                "position": [float(v) for v in landmarks["pose"][i]],
                "normal": [float(v) for v in landmarks["normal"][i]],
                "covariance_trace": float(np.trace(landmarks["covariance"][i])),
                "color": CLASS_COLORS.get(cid, (0.5, 0.5, 0.5)),
                # h/v-dependent marker scale like the reference (thin slab
                # along the plane normal direction)
                "scale": [0.5, 0.5, 0.05] if hv == 0 else [0.05, 0.5, 0.5],
            }
        )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Minimal ASCII PLY point cloud writer (trajectories, voxel centers)."""
    points = np.asarray(points)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]} {points[i,1]} {points[i,2]}"
            if colors is not None:
                c = (np.asarray(colors[i]) * 255).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


def export_session(out_dir: str, engine, grid=None) -> np.ndarray | None:
    """One-call dump of the full viz surface for a finished session.

    Returns the occupied voxel centers when a grid was given (the extraction
    is a full-grid device fetch — callers like ``run --viz-bag`` reuse it
    instead of running it twice), else None."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    lms = engine.get_mapped_landmarks()
    landmarks_to_json(os.path.join(out_dir, "landmarks.json"), lms)
    if len(lms["pose"]):
        cols = np.array([CLASS_COLORS.get(int(c), (0.5, 0.5, 0.5)) for c in lms["class_id"]])
        write_ply(os.path.join(out_dir, "landmarks.ply"), lms["pose"], cols)
    kfs = engine.get_keyframe_poses()
    if len(kfs):
        write_ply(os.path.join(out_dir, "keyframes.ply"), kfs[:, :3])
    if grid is None:
        return None
    from semantic_slam_tpu_torch.mapping.voxel import occupied_centers

    centers = occupied_centers(grid)
    if len(centers):
        write_ply(os.path.join(out_dir, "occupancy.ply"), centers)
    return centers
