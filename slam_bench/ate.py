"""Trajectory error: stamp association, Umeyama SE(3) alignment, ATE RMSE
and RPE. A frozen copy of the port's ``eval/ate.py``, so that the metric
``ate_cm`` cannot change with the program."""

from __future__ import annotations

import numpy as np


def associate_stamps(
    t_a: np.ndarray, t_b: np.ndarray, max_dt: float = 0.05
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-stamp matching; returns index arrays into a and b."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(t_a):
        j = int(np.searchsorted(t_b, ta))
        best, bestd = None, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(t_b):
                d = abs(float(t_b[k] - ta))
                if d <= bestd:
                    best, bestd = k, d
        if best is not None:
            ia.append(i)
            ib.append(best)
    return np.array(ia, int), np.array(ib, int)


def umeyama_se3(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) aligning src -> dst (no scale)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(S)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_rmse(
    est_t: np.ndarray,
    est_xyz: np.ndarray,
    gt_t: np.ndarray,
    gt_xyz: np.ndarray,
    align: bool = True,
    max_dt: float = 0.05,
) -> float:
    ia, ib = associate_stamps(np.asarray(est_t), np.asarray(gt_t), max_dt)
    if len(ia) < 2:
        return float("nan")
    e = np.asarray(est_xyz)[ia]
    g = np.asarray(gt_xyz)[ib]
    if align:
        R, t = umeyama_se3(e, g)
        e = e @ R.T + t
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=-1))))


def rpe_rmse(
    est_t: np.ndarray,
    est_xyz: np.ndarray,
    gt_t: np.ndarray,
    gt_xyz: np.ndarray,
    delta: int = 10,
    max_dt: float = 0.05,
) -> float:
    """Relative pose (translation) error over a fixed index delta."""
    ia, ib = associate_stamps(np.asarray(est_t), np.asarray(gt_t), max_dt)
    if len(ia) <= delta:
        return float("nan")
    e = np.asarray(est_xyz)[ia]
    g = np.asarray(gt_xyz)[ib]
    de = e[delta:] - e[:-delta]
    dg = g[delta:] - g[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=-1))))
