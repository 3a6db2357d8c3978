"""SO(3)/SE(3) primitives on tensors (port of ``semantic_slam_tpu.core.geometry``).

Same conventions as the JAX module: quaternions ``[w, x, y, z]``, pose7
``[tx, ty, tz, qw, qx, qy, qz]``, twists ``[v, w]`` with right perturbation
``T <- T * exp(xi)``, ZYX roll-pitch-yaw. Every function is batched over
leading dims and keeps the input's dtype and device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _eye3_like(x: Tensor, batch_shape) -> Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(*batch_shape, 3, 3)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conj(q: Tensor) -> Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, batched over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v by quaternion(s) q (R(q) @ v)."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rotmat(q: Tensor) -> Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_quat(R: Tensor) -> Tensor:
    """Branch-free rotation-matrix -> quaternion (best of four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(wxyz)]
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log
# ---------------------------------------------------------------------------


def hat(w: Tensor) -> Tensor:
    """Skew-symmetric matrix [w]_x, batched."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_quat(w: Tensor) -> Tensor:
    """exp: so(3) -> unit quaternion. Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    small = theta2 < 1e-8
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw, sinc_half * w], dim=-1)


def quat_log(q: Tensor) -> Tensor:
    """log: unit quaternion -> so(3) (rotation vector)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-8
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=1e-12), theta / torch.clamp(vnorm, min=1e-32)
    )
    return scale * v


def so3_left_jacobian(w: Tensor) -> Tensor:
    """Left Jacobian J_l of SO(3); V matrix of the se(3) exp."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(w, W.shape[:-2])
    # f32-safe cutoff (see the JAX module): 3-term Taylor below theta ~ 0.063
    small = theta2 < 4e-3
    t4 = theta2 * theta2
    A = torch.where(
        small,
        0.5 - theta2 / 24.0 + t4 / 720.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-32),
    )
    B = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-32),
    )
    return eye + A * W + B * W2


def so3_left_jacobian_inv(w: Tensor) -> Tensor:
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(w, W.shape[:-2])
    small = theta2 < 4e-3
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.clamp(torch.sin(half_theta), min=1e-32))
        / torch.clamp(theta2, min=1e-32),
    )
    return eye - 0.5 * W + cot_term * W2


def se3_Q_matrix(xi: Tensor) -> Tensor:
    """Barfoot's Q(v, w) block of the SE(3) left Jacobian, batched."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta2 + 1e-32)
    V = hat(v)
    W = hat(w)
    WV = W @ V
    VW = V @ W
    WW = W @ W
    small = theta2 < 4e-3
    t4 = theta2 * theta2
    s, c = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
        (theta - s) / torch.clamp(theta2 * theta, min=1e-32),
    )
    c2 = torch.where(
        small,
        1.0 / 24.0 - theta2 / 720.0 + t4 / 40320.0,
        (theta2 + 2.0 * c - 2.0) / torch.clamp(2.0 * theta2 * theta2, min=1e-32),
    )
    c3 = torch.where(
        small,
        1.0 / 120.0 - theta2 / 2520.0 + t4 / 120960.0,
        (2.0 * theta - 3.0 * s + theta * c) / torch.clamp(2.0 * theta2 * theta2 * theta, min=1e-32),
    )
    return (
        0.5 * V
        + c1 * (WV + VW + W @ VW)
        + c2 * (WW @ V + V @ WW - 3.0 * (W @ VW))
        + c3 * ((W @ VW) @ W + WW @ VW)
    )


def se3_right_jacobian_inv(xi: Tensor) -> Tensor:
    """Inverse right Jacobian of SE(3) at twist xi = [v, w] (6x6, batched)."""
    Jinv = so3_left_jacobian_inv(-xi[..., 3:])
    Q = se3_Q_matrix(-xi)
    top_right = -(Jinv @ Q @ Jinv)
    zero = torch.zeros_like(Jinv)
    top = torch.cat([Jinv, top_right], dim=-1)
    bottom = torch.cat([zero, Jinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose_adjoint(p: Tensor) -> Tensor:
    """Adjoint Ad(T) of a pose7 acting on [v, w] twists: [[R, hat(t) R], [0, R]]."""
    R = quat_to_rotmat(p[..., 3:])
    tR = hat(p[..., :3]) @ R
    zero = torch.zeros_like(R)
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([zero, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Pose7 = [t(3), q(4)]
# ---------------------------------------------------------------------------


def pose_identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def pose_make(t: Tensor, q: Tensor) -> Tensor:
    return torch.cat([t, q], dim=-1)


def pose_mul(a: Tensor, b: Tensor) -> Tensor:
    """Compose: (a*b)(x) = a(b(x))."""
    ta, qa = a[..., :3], a[..., 3:]
    tb, qb = b[..., :3], b[..., 3:]
    return pose_make(ta + quat_rotate(qa, tb), quat_normalize(quat_mul(qa, qb)))


def pose_inv(p: Tensor) -> Tensor:
    t, q = p[..., :3], p[..., 3:]
    qi = quat_conj(q)
    return pose_make(-quat_rotate(qi, t), qi)


def pose_apply(p: Tensor, x: Tensor) -> Tensor:
    return quat_rotate(p[..., 3:], x) + p[..., :3]


def se3_exp(xi: Tensor) -> Tensor:
    """exp: se(3) -> pose7. xi = [v, w]."""
    v, w = xi[..., :3], xi[..., 3:]
    q = so3_exp_quat(w)
    V = so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", V, v)
    return pose_make(t, q)


def se3_log(p: Tensor) -> Tensor:
    """log: pose7 -> se(3) twist [v, w]."""
    w = quat_log(p[..., 3:])
    Vinv = so3_left_jacobian_inv(w)
    v = torch.einsum("...ij,...j->...i", Vinv, p[..., :3])
    return torch.cat([v, w], dim=-1)


def pose_retract(p: Tensor, xi: Tensor) -> Tensor:
    """Right-multiplicative retraction: p * exp(xi)."""
    return pose_mul(p, se3_exp(xi))


# ---------------------------------------------------------------------------
# Euler (ZYX, tf::getEulerYPR convention)
# ---------------------------------------------------------------------------


def rpy_to_rotmat(rpy: Tensor) -> Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll); rpy = [roll, pitch, yaw]."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_rpy(R: Tensor) -> Tensor:
    """Inverse of rpy_to_rotmat (matches tf::Matrix3x3::getEulerYPR)."""
    sp = -R[..., 2, 0]
    pitch = torch.asin(torch.clamp(sp, -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rpy(q: Tensor) -> Tensor:
    return rotmat_to_rpy(quat_to_rotmat(q))


def rpy_to_quat(rpy: Tensor) -> Tensor:
    return rotmat_to_quat(rpy_to_rotmat(rpy))


def pose_to_xyzrpy(p: Tensor) -> Tensor:
    """pose7 -> [x, y, z, roll, pitch, yaw]."""
    return torch.cat([p[..., :3], quat_to_rpy(p[..., 3:])], dim=-1)
