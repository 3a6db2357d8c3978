"""Host geometry in numpy: quaternions (w first), poses ``[t, q]``, SE(3)
exp, Euler angles and the reference system's frame chains, with its
truncated constants and the (0,2) typo of the robot->world rotation
(``strict=True``).

A frozen copy of the port's ``core/np_geometry.py``: the scene generator and
the plain reference take it from here, so that a change to the port's copy
changes neither the inputs nor the yardstick.
"""


from __future__ import annotations

import numpy as np

REF_HALF_PI = 1.5708
REF_PI = 3.14
REF_HALF_PI_SHORT = 1.57


def quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_rotmat(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def pose_mul(a, b):
    ta, qa = a[..., :3], a[..., 3:]
    tb, qb = b[..., :3], b[..., 3:]
    q = quat_mul(qa, qb)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([ta + quat_rotate(qa, tb), q], axis=-1)


def pose_inv(p):
    t, q = p[..., :3], p[..., 3:]
    qi = quat_conj(q)
    return np.concatenate([-quat_rotate(qi, t), qi], axis=-1)


def pose_apply(p, x):
    return quat_rotate(p[..., 3:], x) + p[..., :3]


def so3_exp_quat(w):
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    half = 0.5 * theta
    small = theta < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc = np.where(small, 0.5 - theta**2 / 48.0, np.sin(half) / np.maximum(theta, 1e-300))
    cw = np.where(small, 1.0 - theta**2 / 8.0, np.cos(half))
    return np.concatenate([cw, sinc * w], axis=-1)


def _so3_left_jacobian(w):
    theta2 = np.sum(w * w, axis=-1)
    theta = np.sqrt(theta2)
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -w[..., 2], w[..., 1]
    W[..., 1, 0], W[..., 1, 2] = w[..., 2], -w[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -w[..., 1], w[..., 0]
    W2 = W @ W
    small = theta2 < 1e-8
    with np.errstate(invalid="ignore", divide="ignore"):
        A = np.where(small, 0.5 - theta2 / 24.0, (1 - np.cos(theta)) / np.maximum(theta2, 1e-300))
        B = np.where(
            small, 1 / 6 - theta2 / 120.0, (theta - np.sin(theta)) / np.maximum(theta2 * theta, 1e-300)
        )
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def se3_exp(xi):
    xi = np.asarray(xi, np.float64)
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    V = _so3_left_jacobian(w)
    t = np.einsum("...ij,...j->...i", V, v)
    return np.concatenate([t, q], axis=-1)


def pose_retract(p, xi):
    return pose_mul(p, se3_exp(xi))


def rpy_to_rotmat(rpy):
    r, p, y = np.moveaxis(np.asarray(rpy), -1, 0)
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    row0 = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = np.stack([-sp, cp * sr, cp * cr], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def rotmat_to_rpy(R):
    sp = -R[..., 2, 0]
    pitch = np.arcsin(np.clip(sp, -1.0, 1.0))
    roll = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    return np.stack([roll, pitch, yaw], axis=-1)


def rotmat_to_quat(R):
    from scipy.spatial.transform import Rotation

    flat = R.reshape(-1, 3, 3)
    q = Rotation.from_matrix(flat).as_quat()  # xyzw
    q = np.roll(q, 1, axis=-1)
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    return q.reshape(R.shape[:-2] + (4,))


def rpy_to_quat(rpy):
    return rotmat_to_quat(rpy_to_rotmat(rpy))


def quat_to_rpy(q):
    return rotmat_to_rpy(quat_to_rotmat(q))


def pose_to_xyzrpy(p):
    return np.concatenate([p[..., :3], quat_to_rpy(p[..., 3:])], axis=-1)


# ---------------------------------------------------------------------------
# frame chains (numpy twins of core.frames)
# ---------------------------------------------------------------------------


def t_robot_world_reference(rpy, strict=True):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    T = np.zeros(np.shape(r) + (4, 4))
    T[..., 0, 0] = cy * cp
    T[..., 0, 1] = cy * sp * sr - sy * cr
    T[..., 0, 2] = cy * sp * cr + (sy * sp if strict else sy * sr)
    T[..., 1, 0] = sy * cp
    T[..., 1, 1] = sy * sp * sr + cy * cr
    T[..., 1, 2] = sy * sp * cr - cy * sr
    T[..., 2, 0] = -sp
    T[..., 2, 1] = cp * sr
    T[..., 2, 2] = cp * cr
    T[..., 3, 3] = 1.0
    return T


def _rot_x44(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])


def _rot_z44(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])


def t_cam_robot(cam_pitch):
    return _rot_z44(-REF_HALF_PI) @ _rot_x44(-REF_HALF_PI) @ _rot_x44(-cam_pitch)


def t_cam_world(robot_xyzrpy, cam_pitch, strict=True):
    return t_robot_world_reference(robot_xyzrpy[..., 3:6], strict) @ t_cam_robot(cam_pitch)


def pose_ned_to_enu(pose7):
    a = -REF_PI
    c, s = np.cos(a), np.sin(a)
    M = np.array([[1, 0, 0], [0, c, s], [0, s, c]])
    rpy = quat_to_rpy(pose7[..., 3:])
    return np.concatenate(
        [pose7[..., :3] @ M.T, rpy_to_quat(rpy @ M.T)], axis=-1
    )


def pose_cam_to_robot_odom(pose7):
    a = -REF_HALF_PI
    c, s = np.cos(a), np.sin(a)
    rot_x = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    rot_z = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    M = rot_z @ rot_x
    rpy = quat_to_rpy(pose7[..., 3:])
    return np.concatenate([pose7[..., :3] @ M.T, rpy_to_quat(rpy @ M.T)], axis=-1)


def rot_pose_z(pose7, first_yaw):
    a = REF_HALF_PI_SHORT
    c, s = np.cos(a), np.sin(a)
    M = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    rpy = quat_to_rpy(pose7[..., 3:]).copy()
    rpy[..., 2] -= first_yaw
    return np.concatenate([pose7[..., :3] @ M.T, rpy_to_quat(rpy @ M.T)], axis=-1)
