"""The in-plane basis of a plane normal (port of
``semantic_slam_tpu.frontend.hull.plane_basis``; the hull-area estimators
are not on the engine's path and are not ported).

The plane landmarks' tangent parameterization (``solver/plane_ba.py``
``plane_retract``) and the fixed-lag prior's plane coordinates
(``solver/fixed_lag.py`` ``plane_local``) both read this basis.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def plane_basis(n: Tensor) -> tuple[Tensor, Tensor]:
    """Orthonormal in-plane basis (u, v) of unit normals ``n [..., 3]``:
    u = n x ref / |n x ref| with ref = z, or x where |n_z| >= 0.9; v = n x u."""
    ez = n.new_tensor([0.0, 0.0, 1.0])
    ex = n.new_tensor([1.0, 0.0, 0.0])
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    u = torch.linalg.cross(n, ref.expand_as(n), dim=-1)
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True), min=1e-12)
    v = torch.linalg.cross(n, u, dim=-1)
    return u, v
