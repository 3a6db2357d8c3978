"""Plain data association: detections matched one after another against
the landmark table and the frame's earlier new landmarks, in float64.

Semantics of the system's association (the reference system's
``data_association.h``): a detection may match a landmark of its class and
plane type, or an earlier detection of this frame that became a new
landmark; Mahalanobis distance through the landmark's covariance plus the
measurement noise (twice the noise between two detections), or Euclidean;
the nearest candidate within the threshold wins, the table first, the
first of equals; otherwise the detection becomes the next new landmark.
On a frame that meets an empty table nothing is matched at all."""

from __future__ import annotations

import numpy as np

from slam_bench import np_geometry as npg


def world_points(pose_cam: np.ndarray, xyzrpy: np.ndarray, cam_angle: float, strict: bool, rtabmap: bool):
    T = npg.t_cam_world(xyzrpy, cam_angle, strict)
    w = np.concatenate([pose_cam, np.ones((len(pose_cam), 1))], axis=1) @ T.T
    t = xyzrpy[:3] - (np.array([0.0, 0.04, 0.0]) if rtabmap else 0.0)
    return w[:, :3] + t


def associate(table: dict, dets: dict, xyzrpy: np.ndarray, cam_angle: float, params: dict) -> tuple[np.ndarray, np.ndarray]:
    """(landmark id [M], is new [M]) of each valid detection (-1 and False
    for the others). ``table``: ``world`` [L,3], ``cov`` [L,3,3],
    ``class_id``, ``plane_type`` and ``count``; ``dets``: ``valid``,
    ``class_id``, ``plane_type``, ``pose_cam`` [M,3]."""
    count0 = int(table["count"])
    w = world_points(dets["pose_cam"], xyzrpy, cam_angle, params["strict"], params["rtabmap"])
    Q = np.eye(3) * params["land_noise"]
    thres = params["maha_thres"] if params["use_maha"] else params["eq_thres"]

    def dist(z, cov):
        return float(z @ np.linalg.solve(cov, z)) if params["use_maha"] else float(np.linalg.norm(z))

    M = len(w)
    ids = np.full(M, -1, np.int64)
    new = np.zeros(M, bool)
    n_new = 0
    for i in range(M):
        if not dets["valid"][i]:
            continue
        best, best_id = np.inf, -1
        if count0 > 0:
            for j in range(count0):
                if table["class_id"][j] == dets["class_id"][i] and table["plane_type"][j] == dets["plane_type"][i]:
                    d = dist(w[i] - table["world"][j], table["cov"][j] + Q)
                    if d < best:
                        best, best_id = d, j
            for k in range(i):
                if (new[k] and dets["class_id"][k] == dets["class_id"][i]
                        and dets["plane_type"][k] == dets["plane_type"][i]):
                    d = dist(w[i] - w[k], 2.0 * Q)
                    if d < best:
                        best, best_id = d, ids[k]
        if best <= thres:
            ids[i] = best_id
        else:
            ids[i] = count0 + n_new
            new[i] = True
            n_new += 1
    return ids, new
