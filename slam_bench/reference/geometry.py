"""Plain SE(3) arithmetic for the reference, on tensors of any float dtype:
quaternions w first, poses ``[t, q]``, right-multiplicative retraction
``x exp(xi)`` with ``xi = [v, w]`` (translation first), and its log.
Written from the textbook formulas (the left Jacobian V of SO(3));
series below a small angle."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotmat(q: Tensor) -> Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotate(q: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", rotmat(q), v)


def pose_mul(a: Tensor, b: Tensor) -> Tensor:
    q = quat_mul(a[..., 3:], b[..., 3:])
    return torch.cat([a[..., :3] + rotate(a[..., 3:], b[..., :3]), q / q.norm(dim=-1, keepdim=True)], dim=-1)


def pose_inv(p: Tensor) -> Tensor:
    qi = quat_conj(p[..., 3:])
    return torch.cat([-rotate(qi, p[..., :3]), qi], dim=-1)


def hat(w: Tensor) -> Tensor:
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def _left_jacobian(w: Tensor, inverse: bool) -> Tensor:
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    small = th2 < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    if inverse:
        c = torch.where(small, 1 / 12 + th2 / 720, (1 - (safe / 2) / torch.tan(safe / 2)) / safe**2)
        return eye - 0.5 * W + c * (W @ W)
    a = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(safe)) / safe**2)
    b = torch.where(small, 1 / 6 - th2 / 120, (safe - torch.sin(safe)) / safe**3)
    return eye + a * W + b * (W @ W)


def so3_exp(w: Tensor) -> Tensor:
    th = w.norm(dim=-1, keepdim=True)
    small = th < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    s = torch.where(small, 0.5 - th**2 / 48, torch.sin(safe / 2) / safe)
    return torch.cat([torch.cos(th / 2), s * w], dim=-1)


def so3_log(q: Tensor) -> Tensor:
    q = torch.where(q[..., :1] < 0, -q, q)
    vn = q[..., 1:].norm(dim=-1, keepdim=True)
    small = vn < 1e-9
    theta = 2 * torch.atan2(vn, q[..., :1])
    scale = torch.where(small, 2 / q[..., :1], theta / torch.where(small, torch.ones_like(vn), vn))
    return scale * q[..., 1:]


def se3_exp(xi: Tensor) -> Tensor:
    v, w = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", _left_jacobian(w, False), v)
    return torch.cat([t, so3_exp(w)], dim=-1)


def se3_log(p: Tensor) -> Tensor:
    w = so3_log(p[..., 3:])
    v = torch.einsum("...ij,...j->...i", _left_jacobian(w, True), p[..., :3])
    return torch.cat([v, w], dim=-1)


def retract(p: Tensor, xi: Tensor) -> Tensor:
    return pose_mul(p, se3_exp(xi))
