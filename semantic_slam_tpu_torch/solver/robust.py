"""Robust kernels for landmark observation edges (port of
``semantic_slam_tpu.solver.robust``): Huber and DCS information reweighting
(IRLS) and the matching robustified objective."""

from __future__ import annotations

import torch

ROBUST_NONE = "none"
ROBUST_HUBER = "huber"
ROBUST_DCS = "dcs"


def robust_weight(chi2: torch.Tensor, kind: str, delta: float) -> torch.Tensor:
    """Per-edge information scale factor in [0, 1]. chi2: [E]."""
    if kind == ROBUST_NONE:
        return torch.ones_like(chi2)
    if kind == ROBUST_HUBER:
        e = torch.sqrt(torch.clamp(chi2, min=1e-30))
        return torch.clamp(delta / e, max=1.0)
    if kind == ROBUST_DCS:
        phi = delta * delta
        s = 2.0 * phi / (phi + torch.clamp(chi2, min=0.0))
        return torch.clamp(s * s, max=1.0)
    raise ValueError(f"unknown robust kernel {kind!r}")


def robust_rho(chi2: torch.Tensor, kind: str, delta: float) -> torch.Tensor:
    """Robustified per-edge objective (monotone in chi2) for the LM
    accept/reject test; Huber exact, DCS in its Geman-McClure form."""
    if kind == ROBUST_NONE:
        return chi2
    if kind == ROBUST_HUBER:
        d2 = delta * delta
        e = torch.sqrt(torch.clamp(chi2, min=1e-30))
        return torch.where(chi2 <= d2, chi2, 2.0 * delta * e - d2)
    if kind == ROBUST_DCS:
        phi = delta * delta
        return 2.0 * phi * chi2 / (phi + torch.clamp(chi2, min=1e-30))
    raise ValueError(f"unknown robust kernel {kind!r}")
