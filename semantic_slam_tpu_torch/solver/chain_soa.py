"""Channelwise (K-last) SE3-SE3 chain linearization (port of
``semantic_slam_tpu.solver.chain_soa``).

The odometry chain's residual ``log(m^-1 T_i^-1 T_j)``, its analytic
Jacobian blocks (``J_j = Jr^-1(r)``, ``J_i = -J_j Ad(T_ij^-1)``, both
``[[X, Y], [0, X]]``) and the Gauss-Newton blocks, on channel tensors
``[C, ..., K]`` with the 3/4/6-sized channel dims unrolled. These are the
plain versions of the chain half of the ``soa_linearize`` kernel (K2) and of
the chain term of the ``soa_chi2`` kernel (K3). Same cutoffs and guards as
``core/geometry.py``.

The JAX module computes the quaternion log's angle with a Newton-iterated
first-quadrant atan2 because Mosaic had no atan2. Here it is ``torch.atan2``,
exact to the resolution of f64. The Newton form is off by up to 5.8e-13 rad
in f64, so the chain blocks agree with the JAX ones to 1e-10 (1e-12 with the
Newton form swapped in); in f32 the angle agrees within 2e-6 rad
(``tests/test_torch_soa.py``).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


# The JAX module unrolls these small products over the channel dims to fill
# TPU lanes; here each is one batched op (the same math up to summation
# order, and a few launches instead of dozens in the plain versions).


def m33_mul(A, B):
    """A @ B for [3,3,...] channel tensors."""
    return torch.einsum("ik...,kj...->ij...", A, B)


def m33T_mul(A, B):
    """A^T @ B for [3,3,...] channel tensors."""
    return torch.einsum("ki...,kj...->ij...", A, B)


def m33_vec(A, x):
    return torch.einsum("ik...,k...->i...", A, x)


def cross_ch(a, b):
    return torch.stack(
        [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]
    )


def hat_mul(v, M):
    """hat(v) @ M."""
    r0 = torch.stack([-v[2] * M[1][j] + v[1] * M[2][j] for j in range(3)])
    r1 = torch.stack([v[2] * M[0][j] - v[0] * M[2][j] for j in range(3)])
    r2 = torch.stack([-v[1] * M[0][j] + v[0] * M[1][j] for j in range(3)])
    return torch.stack([r0, r1, r2])


def hat_ch(w):
    """hat(w) as a [3,3,...] channel tensor."""
    z = torch.zeros_like(w[0])
    return torch.stack(
        [torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]), torch.stack([-w[1], w[0], z])]
    )


def quat_mul_ch(a, b):
    """Hamilton product for [4, ...] (w-first) channel tensors."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_conj_ch(q):
    return torch.stack([q[0], -q[1], -q[2], -q[3]])


def quat_normalize_ch(q):
    return q / torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])


def quat_rotate_ch(q, v):
    """R(q) @ v, cross-product form (geometry.quat_rotate's op sequence)."""
    w = q[0:1]
    u = q[1:]
    uv = cross_ch(u, v)
    return v + 2.0 * (w * uv + cross_ch(u, uv))


def rotmat_ch(q):
    """R(q) as [3,3,...] channels (geometry.quat_to_rotmat entries)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)]),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)]),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]),
        ]
    )


def quat_log_ch(q):
    """geometry.quat_log channelwise: [4, ...] -> rotation vector [3, ...]."""
    sign = torch.where(q[0:1] < 0, -1.0, 1.0).to(q.dtype)
    q = q * sign
    w = torch.clamp(q[0], -1.0, 1.0)
    v = q[1:]
    vnorm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    theta = 2.0 * torch.atan2(vnorm, torch.clamp(w, min=0.0))
    small = vnorm < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), theta / torch.clamp(vnorm, min=1e-32))
    return scale * v


def _eye_ch(like):
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, one, zero]), torch.stack([zero, zero, one])])


def so3_ljac_inv_ch(w):
    """geometry.so3_left_jacobian_inv channelwise (same cutoffs/Taylor)."""
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat_ch(w)
    W2 = m33_mul(W, W)
    small = theta2 < 4e-3
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.clamp(torch.sin(half_theta), min=1e-32))
        / torch.clamp(theta2, min=1e-32),
    )
    return _eye_ch(theta2) - 0.5 * W + cot_term * W2


def so3_ljac_ch(w):
    """geometry.so3_left_jacobian channelwise (the V matrix of se3_exp)."""
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat_ch(w)
    W2 = m33_mul(W, W)
    small = theta2 < 4e-3
    t4 = theta2 * theta2
    A = torch.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-32))
    B = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-32),
    )
    return _eye_ch(theta2) + A * W + B * W2


def se3_Q_ch(v, w):
    """geometry.se3_Q_matrix channelwise (Barfoot eq. 7.86, same cutoffs)."""
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = torch.sqrt(theta2 + 1e-32)
    V = hat_ch(v)
    W = hat_ch(w)
    WV = m33_mul(W, V)
    VW = m33_mul(V, W)
    WW = m33_mul(W, W)
    W_VW = m33_mul(W, VW)
    small = theta2 < 4e-3
    t4 = theta2 * theta2
    s, c = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0, (theta - s) / torch.clamp(theta2 * theta, min=1e-32)
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
        + c1 * (WV + VW + W_VW)
        + c2 * (m33_mul(WW, V) + m33_mul(V, WW) - 3.0 * W_VW)
        + c3 * (m33_mul(W_VW, W) + m33_mul(WW, VW))
    )


# ---------------------------------------------------------------------------
# chain residual / Jacobian blocks
# ---------------------------------------------------------------------------


def chain_residual_ch(t_i, q_i, t_j, q_j, m_t, m_q):
    """r = log(meas^-1 · pose_i^-1 · pose_j) channelwise. Inputs [3/4, K];
    returns (rv [3,K], rw [3,K], rel_t, rel_q) — translation first."""
    qi_c = quat_conj_ch(q_i)
    # R^T (t_j - t_i), not -R^T t_i + R^T t_j as the JAX module has it: the
    # same in exact arithmetic, but two neighbouring positions subtract
    # exactly (within a factor of two of each other), so far from the origin
    # f32 keeps the relative motion instead of cancelling two large rotations
    rel_t = quat_rotate_ch(qi_c, t_j - t_i)
    rel_q = quat_normalize_ch(quat_mul_ch(qi_c, q_j))
    mq_c = quat_conj_ch(m_q)
    E_t = quat_rotate_ch(mq_c, rel_t - m_t)
    E_q = quat_normalize_ch(quat_mul_ch(mq_c, rel_q))
    rw = quat_log_ch(E_q)
    rv = m33_vec(so3_ljac_inv_ch(rw), E_t)
    return rv, rw, rel_t, rel_q


def chain_jacobian_blocks_ch(rv, rw, rel_t, rel_q):
    """(Xi, Yi, Xj, Yj), each [3,3,K]: J = [[X, Y], [0, X]] per side."""
    Xj = so3_ljac_inv_ch(-rw)
    Q = se3_Q_ch(-rv, -rw)
    Yj = -m33_mul(Xj, m33_mul(Q, Xj))
    q_ir = quat_conj_ch(rel_q)
    t_ir = -quat_rotate_ch(q_ir, rel_t)
    R_ir = rotmat_ch(q_ir)
    Xi = -m33_mul(Xj, R_ir)
    Yi = -(m33_mul(Xj, hat_mul(t_ir, R_ir)) + m33_mul(Yj, R_ir))
    return Xi, Yi, Xj, Yj


def _jT_O(X, Y, O11, O12, O21, O22):
    """T = J^T O for J = [[X, Y], [0, X]]; returns T's quadrants."""
    return (
        m33T_mul(X, O11),
        m33T_mul(X, O12),
        m33T_mul(Y, O11) + m33T_mul(X, O21),
        m33T_mul(Y, O12) + m33T_mul(X, O22),
    )


def _T_J(T11, T12, T21, T22, X, Y):
    """H = T J for J = [[X, Y], [0, X]] -> [6,6,K]."""
    H11 = m33_mul(T11, X)
    H12 = m33_mul(T11, Y) + m33_mul(T12, X)
    H21 = m33_mul(T21, X)
    H22 = m33_mul(T21, Y) + m33_mul(T22, X)
    return torch.cat([torch.cat([H11, H12], dim=1), torch.cat([H21, H22], dim=1)], dim=0)


def chain_linearize_ch(t_i, q_i, t_j, q_j, m_t, m_q, O):
    """Full chain linearization. O is the [6,6,K] information, zeroed on
    masked rows (which must carry the identity measurement). Returns
    (Hii, Hij, Hjj [6,6,K], g_i, g_j [6,K], chi [K])."""
    rv, rw, rel_t, rel_q = chain_residual_ch(t_i, q_i, t_j, q_j, m_t, m_q)
    Xi, Yi, Xj, Yj = chain_jacobian_blocks_ch(rv, rw, rel_t, rel_q)
    O11, O12, O21, O22 = O[:3, :3], O[:3, 3:], O[3:, :3], O[3:, 3:]
    Ti = _jT_O(Xi, Yi, O11, O12, O21, O22)
    Tj = _jT_O(Xj, Yj, O11, O12, O21, O22)
    Hii = _T_J(*Ti, Xi, Yi)
    Hij = _T_J(*Ti, Xj, Yj)
    Hjj = _T_J(*Tj, Xj, Yj)
    g_i = torch.cat([m33_vec(Ti[0], rv) + m33_vec(Ti[1], rw), m33_vec(Ti[2], rv) + m33_vec(Ti[3], rw)])
    g_j = torch.cat([m33_vec(Tj[0], rv) + m33_vec(Tj[1], rw), m33_vec(Tj[2], rv) + m33_vec(Tj[3], rw)])
    Orv = m33_vec(O11, rv) + m33_vec(O12, rw)
    Orw = m33_vec(O21, rv) + m33_vec(O22, rw)
    chi = sum(rv[i] * Orv[i] for i in range(3)) + sum(rw[i] * Orw[i] for i in range(3))
    return Hii, Hij, Hjj, g_i, g_j, chi


def chain_chi2_ch(t_i, q_i, t_j, q_j, m_t, m_q, O):
    """Residual-only chain chi2 [K] (the LM trial-point evaluation)."""
    rv, rw, _, _ = chain_residual_ch(t_i, q_i, t_j, q_j, m_t, m_q)
    O11, O12, O21, O22 = O[:3, :3], O[:3, 3:], O[3:, :3], O[3:, 3:]
    Orv = m33_vec(O11, rv) + m33_vec(O12, rw)
    Orw = m33_vec(O21, rv) + m33_vec(O22, rw)
    return sum(rv[i] * Orv[i] for i in range(3)) + sum(rw[i] * Orw[i] for i in range(3))


def retract_ch(t, q, dv, dw):
    """pose_retract channelwise: p' = p · exp([dv, dw]). t [3,K], q [4,K]."""
    theta2 = dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2]
    theta = torch.sqrt(theta2 + 1e-32)
    half = 0.5 * theta
    small = theta2 < 1e-8
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    q_e = torch.cat([cw[None], sinc_half[None] * dw], dim=0)
    t_e = m33_vec(so3_ljac_ch(dw), dv)
    return t + quat_rotate_ch(q, t_e), quat_normalize_ch(quat_mul_ch(q, q_e))


def roll_up_pose_ch(x):
    """[C, K]: lane k of the result = lane k+1 of x, lane 0 wrapping to the
    end (the wrapped row is masked by its zero information)."""
    return torch.cat([x[..., 1:], x[..., :1]], dim=-1)
