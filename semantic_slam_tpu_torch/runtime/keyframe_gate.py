"""Keyframe gating — host-side scalar logic on the ingestion path (the
port's own copy of ``semantic_slam_tpu.runtime.keyframe_gate``).

Reproduces ``ps_graph_slam::KeyframeUpdater``
(``include/ps_graph_slam/keyframe_updater.hpp:41-65`` of the reference)
exactly, including its quirks:

  * the angular delta is ``acos(q.w)`` of the relative quaternion — NOT
    ``2*acos(|w|)`` (:53); negative w gives angles > pi/2,
  * the time gate compares the INTEGER seconds part of the elapsed duration
    (``(current_time - prev_time).sec`` is ROS Duration's truncated seconds
    field, :56).

This runs per VIO message on the host (it gates whether any device work
happens at all), so it is plain numpy.
"""

from __future__ import annotations

import math

import numpy as np


def _pose_inv_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a^-1 * b for pose7 [t, q_wxyz] in numpy."""
    aq = a[3:]
    aqc = aq * np.array([1.0, -1, -1, -1])
    bt_rel = _qrot(aqc, b[:3] - a[:3])
    q_rel = _qmul(aqc, b[3:])
    return np.concatenate([bt_rel, q_rel])


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _qrot(q, v):
    w, u = q[0], q[1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


class KeyframeGate:
    def __init__(self, delta_trans: float = 0.5, delta_angle: float = 0.5, delta_time: float = 1.0):
        self.delta_trans = delta_trans
        self.delta_angle = delta_angle
        self.delta_time = delta_time
        self.is_first = True
        self.accum_distance = 0.0
        self.prev_keypose = np.array([0.0, 0, 0, 1, 0, 0, 0])
        self.prev_time = 0.0

    def update(self, pose7: np.ndarray, stamp: float) -> bool:
        if self.is_first:
            self.is_first = False
            self.prev_time = stamp
            self.prev_keypose = pose7.copy()
            return True

        delta = _pose_inv_mul(self.prev_keypose, pose7)
        dx = float(np.linalg.norm(delta[:3]))
        da = float(math.acos(max(-1.0, min(1.0, delta[3]))))

        # integer-seconds truncation of the elapsed time, like ROS Duration.sec
        dt_sec = int(stamp - self.prev_time)
        if dt_sec < self.delta_time and dx < self.delta_trans and da < self.delta_angle:
            return False

        self.accum_distance += dx
        self.prev_keypose = pose7.copy()
        self.prev_time = stamp
        return True
