"""Plane-landmark parameterization (port of the parts of
``semantic_slam_tpu.solver.plane_ba`` that the engine's plane landmarks use).

A plane is ``[n, d]`` with a unit normal ``n``; its local parameterization
has 3 dof, two normal-tangent components and the offset:
``n' = normalize(n + t1 u + t2 v)``, ``d' = d + dd`` with (u, v) the
normal's in-plane basis (``frontend/hull.plane_basis``).

``plane_bundle_adjust``, the JAX module's whole-problem proof of concept,
has no engine caller and is not ported.
"""

from __future__ import annotations

import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.frontend.hull import plane_basis

Tensor = torch.Tensor


def plane_retract(plane4: Tensor, delta3: Tensor) -> Tensor:
    """[t1, t2, dd] tangent update of planes ``[..., 4]``, keeping n unit."""
    n = plane4[..., :3]
    u, v = plane_basis(n)
    n2 = n + delta3[..., 0:1] * u + delta3[..., 1:2] * v
    n2 = n2 / torch.clamp(torch.linalg.vector_norm(n2, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([n2, plane4[..., 3:] + delta3[..., 2:3]], dim=-1)


def plane_retract_jac(plane4: Tensor) -> Tensor:
    """[..., 4, 3]: the Jacobian of ``plane_retract(plane4, delta3)`` at
    delta3 = 0. The normal's columns are (I - n^ n^T) / |n| [u v], the
    normalization's derivative on the tangent basis; the offset's is e_d."""
    n = plane4[..., :3]
    u, v = plane_basis(n)
    norm = torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-12)
    nh = n / norm
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    P = (eye - nh[..., :, None] * nh[..., None, :]) / norm[..., None]
    Jn = P @ torch.stack([u, v], dim=-1)  # [..., 3, 2]
    top = torch.cat([Jn, torch.zeros_like(Jn[..., :1])], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 2] = 1.0
    return torch.cat([top, bottom], dim=-2)


def observe_plane(pose7: Tensor, plane4: Tensor) -> Tensor:
    """The sensor-frame observation of a world plane from ``pose7``:
    n_s = R^T n, d_s = d + n . t (for tests and simulators)."""
    n = plane4[..., :3]
    n_s = geo.quat_rotate(geo.quat_conj(pose7[..., 3:]), n)
    d_s = plane4[..., 3] + torch.sum(n * pose7[..., :3], dim=-1)
    return torch.cat([n_s, d_s[..., None]], dim=-1)
