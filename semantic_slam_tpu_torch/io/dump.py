"""Per-keyframe text dumps — the ``KeyFrame::dump`` equivalent (the port's own
copy of ``semantic_slam_tpu.io.dump``).

Mirrors ``ps_graph_slam::KeyFrame::dump``
(``ps_graph_slam/keyframe.cpp:22-40``): one directory per
keyframe containing a ``data`` file with the stamp (sec/nsec split like
ros::Time), the odometry 4x4 matrix, the accumulated distance, and the graph
node id. (The reference declares but never calls this; here it is exposed as
``dump_keyframes`` for session archaeology.)
"""

from __future__ import annotations

import os

import numpy as np

from semantic_slam_tpu_torch.core import np_geometry as npg


def _pose_to_mat44(pose7: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = npg.quat_to_rotmat(pose7[3:])
    T[:3, 3] = pose7[:3]
    return T


def dump_keyframe(directory: str, stamp: float, odom7: np.ndarray,
                  accum_distance: float, node_id: int | None) -> None:
    os.makedirs(directory, exist_ok=True)
    sec = int(stamp)
    nsec = int(round((stamp - sec) * 1e9))
    with open(os.path.join(directory, "data"), "w") as f:
        f.write(f"stamp {sec} {nsec}\n")
        f.write("odom\n")
        T = _pose_to_mat44(np.asarray(odom7, np.float64))
        for row in T:
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
        f.write(f"accum_distance {accum_distance}\n")
        if node_id is not None:
            f.write(f"id {node_id}\n")


def dump_keyframes(out_dir: str, engine) -> None:
    """Dump every keyframe of a session (directory per keyframe, like the
    reference's <dir>/<i>/data layout)."""
    for i, kf in enumerate(engine.keyframes):
        dump_keyframe(
            os.path.join(out_dir, f"{i:06d}"), kf.stamp, kf.odom,
            kf.accum_distance, kf.node_idx,
        )
