"""Closed-form symmetric 3x3 eigen-analysis (port of
``semantic_slam_tpu.core.linalg3``).

The closed form is kept as it is, not replaced by ``torch.linalg.eigh``: the
plane normals and areas downstream depend on its exact arithmetic, and the
port is held to the JAX package's numbers.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def sym33_eigvals(C: Tensor) -> Tensor:
    """Eigenvalues of symmetric 3x3 matrices, ascending. C: [..., 3, 3]."""
    c00, c01, c02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    c11, c12, c22 = C[..., 1, 1], C[..., 1, 2], C[..., 2, 2]
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    q = (c00 + c11 + c22) / 3.0
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-30)

    b00, b11, b22 = (c00 - q) / safe_p, (c11 - q) / safe_p, (c22 - q) / safe_p
    b01, b02, b12 = c01 / safe_p, c02 / safe_p, c12 / safe_p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min
    return torch.stack([e_min, e_mid, e_max], dim=-1)


def sym33_eigvec_for(C: Tensor, lam: Tensor) -> Tensor:
    """Unit eigenvector of symmetric C for eigenvalue lam (largest cross
    product of the rows of C - lam I; isotropic matrices fall back to e_z)."""
    A = C - lam[..., None, None] * torch.eye(3, dtype=C.dtype, device=C.device)
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    norm = torch.linalg.vector_norm(best, dim=-1, keepdim=True)
    fallback = C.new_tensor([0.0, 0.0, 1.0]).expand_as(best)
    ok = norm[..., 0] > 1e-20
    return torch.where(ok[..., None], best / torch.clamp(norm, min=1e-30), fallback)


def sym33_smallest_eig(C: Tensor) -> tuple[Tensor, Tensor]:
    """(unit eigenvector of smallest eigenvalue, eigenvalues ascending)."""
    evals = sym33_eigvals(C)
    return sym33_eigvec_for(C, evals[..., 0]), evals
