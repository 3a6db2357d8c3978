"""Block-tridiagonal solves via parallel cyclic reduction (port of
``semantic_slam_tpu.solver.tridiag``: ``pcr_factor``, ``pcr_solve``,
``pcr_solve_cols``).

PCR eliminates neighbours at strides 1, 2, 4, ...: each of the ceil(log2 K)
levels is a batched set of 6x6 inverses and products over all K rows.
Fixed or inactive rows carry identity diagonal blocks and zero couplings, so
their solution components pass through untouched. The matrix-free landmark
marginals (``solver/pcg.py``) apply the odometry chain's inverse with it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from semantic_slam_tpu_torch.solver.lm import inv66

Tensor = torch.Tensor


class PCRFactor(NamedTuple):
    alphas: Tensor  # [levels, K, 6, 6] lower-elimination coefficients
    gammas: Tensor  # [levels, K, 6, 6] upper-elimination coefficients
    final_inv: Tensor  # [K, 6, 6] inverse of the fully reduced diagonal


def _shift_down(x: Tensor, s: int) -> Tensor:
    """y_k = x_{k-s} (zero-filled)."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:s]), x[: x.shape[0] - s]])


def _shift_up(x: Tensor, s: int) -> Tensor:
    """y_k = x_{k+s} (zero-filled)."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[s:], torch.zeros_like(x[:s])])


def pcr_factor(diag: Tensor, upper: Tensor) -> PCRFactor:
    """Factor the symmetric block tridiagonal with diagonal blocks ``diag``
    [K,6,6] and super-diagonal blocks ``upper`` [K,6,6] (row k couples to
    k+1 through upper[k]; upper[K-1] must be zero)."""
    K = diag.shape[0]
    levels = max(1, math.ceil(math.log2(K))) if K > 1 else 1
    b, c = diag, upper
    a = _shift_down(upper, 1).transpose(-1, -2)
    alphas, gammas = [], []
    s = 1
    for _ in range(levels):
        binv = inv66(b)
        alpha = a @ _shift_down(binv, s)
        gamma = c @ _shift_up(binv, s)
        b = b - alpha @ _shift_down(c, s) - gamma @ _shift_up(a, s)
        a, c = -(alpha @ _shift_down(a, s)), -(gamma @ _shift_up(c, s))
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return PCRFactor(torch.stack(alphas), torch.stack(gammas), inv66(b))


def pcr_solve(fac: PCRFactor, r: Tensor) -> Tensor:
    """Apply the factored inverse to ``r`` [K,6]."""
    s = 1
    for lvl in range(fac.alphas.shape[0]):
        r = (
            r
            - torch.einsum("kij,kj->ki", fac.alphas[lvl], _shift_down(r, s))
            - torch.einsum("kij,kj->ki", fac.gammas[lvl], _shift_up(r, s))
        )
        s *= 2
    return torch.einsum("kij,kj->ki", fac.final_inv, r)


def pcr_solve_cols(fac: PCRFactor, R: Tensor) -> Tensor:
    """Apply the factored inverse to a block of columns ``R`` [K,6,C]."""
    s = 1
    for lvl in range(fac.alphas.shape[0]):
        R = R - fac.alphas[lvl] @ _shift_down(R, s) - fac.gammas[lvl] @ _shift_up(R, s)
        s *= 2
    return fac.final_inv @ R
