"""Fitness-weighted odometry-edge information (port of
``semantic_slam_tpu.solver.information``: ``weight``, ``fitness_score``,
``fitness_info6``).

The reference's non-constant branch of ``calc_information_matrix``
(information_matrix_calculator.cpp:37-50) is dead code there; the JAX
package makes it a working opt-in (``use_const_inf_matrix=False``) with
hdl_graph_slam's parameters, and so does the port:

* ``fitness_score``: the mean squared nearest-neighbour distance between two
  keyframes' clouds, the second moved by the measured relative pose, over a
  strided S-point subsample of each and one [S, S] distance matrix in the
  ``|x|^2 + |y|^2 - 2 x.y`` form (the cross term one matmul);
* ``weight``: the reference header's saturating exponential
  (information_matrix_calculator.hpp:20-24);
* ``fitness_info6``: identity with the translation and rotation blocks
  divided by the interpolated variances.

The strided subsample is the JAX package's ``jnp.linspace(0, n - 1,
S).astype(int32)``, reproduced on the host in the points' dtype
(``subsample_index``), so that both packages pick the same points in f32 and
in f64. ``fitness_info6`` forms the matrix on the device from the score
tensor (the JAX package fetches the score and forms it on the host), which
spares the engine a host fetch a keyframe.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from semantic_slam_tpu_torch.core import geometry as geo

Tensor = torch.Tensor


def weight(a: float, max_x: float, min_y: float, max_y: float, x):
    """information_matrix_calculator.hpp:20-24, verbatim semantics; ``x`` a
    float, or a tensor (the same f64 arithmetic on its device)."""
    e = torch.exp(-a * x) if isinstance(x, torch.Tensor) else math.exp(-a * x)
    y = (1.0 - e) / (1.0 - math.exp(-a * max_x))
    return min_y + (max_y - min_y) * y


def subsample_index(n: int, S: int, dtype) -> np.ndarray:
    """``jnp.linspace(0, n - 1, S, dtype=dtype).astype(int32)`` as XLA
    computes it: the interior as ``((n - 1) * (1 / (S - 1))) * i`` in
    ``dtype`` (the compiler turns the division by the constant into a
    product by its reciprocal and folds it with the stop), the last entry
    ``n - 1``, truncated toward zero. The textbook ``(n - 1) * (i / (S -
    1))`` picks other points at several hundred of 1024 entries."""
    t = np.dtype(dtype).type
    if S == 1:
        return np.zeros((1,), np.int32)
    scale = t(n - 1) * (t(1) / t(S - 1))
    out = np.concatenate([scale * np.arange(S - 1, dtype=t), np.array([n - 1], t)])
    return out.astype(np.int32)


def fitness_score_sub(A: Tensor, wa: Tensor, B: Tensor, wb: Tensor, relpose7: Tensor,
                      max_range: float = 2.0) -> Tensor:
    """The score over subsampled clouds A [S, 3] (weights ``wa`` [S]) and
    B [S, 3] (``wb``): mean squared NN distance of relpose * B against A,
    pairs farther than ``max_range`` left out; ``max_range^2`` when nothing
    matches. A 0-d tensor in A's dtype."""
    dtype = A.dtype
    Bt = geo.pose_apply(relpose7.to(dtype), B)
    d2 = torch.sum(Bt * Bt, dim=1)[:, None] + torch.sum(A * A, dim=1)[None, :] - 2.0 * (Bt @ A.T)
    d2 = torch.where(wa[None, :] > 0, d2, torch.full_like(d2, 1e12))
    nn = torch.amin(d2, dim=1)  # per-b nearest squared distance (NaN propagates, as jnp.min)
    ok = (wb > 0) & (nn <= max_range * max_range)
    n = torch.sum(ok.to(dtype))
    mean = torch.sum(torch.where(ok, nn, torch.zeros_like(nn))) / torch.clamp(n, min=1.0)
    return torch.where(n > 0, mean, torch.full_like(mean, max_range * max_range))


def fitness_score(points_a: Tensor, valid_a: Tensor, points_b: Tensor, valid_b: Tensor, relpose7: Tensor,
                  max_range: float = 2.0, S: int = 1024) -> Tensor:
    """Mean squared NN distance of (relpose * b) against a over a strided
    S-point subsample of each cloud (``subsample_index``); hdl_graph_slam's
    ``calc_fitness_score`` contract."""
    pa, pb = points_a.reshape(-1, 3), points_b.reshape(-1, 3)
    va, vb = valid_a.reshape(-1), valid_b.reshape(-1)
    dev, dtype = pa.device, pa.dtype
    ia = torch.as_tensor(subsample_index(pa.shape[0], S, _np_dtype(dtype)), device=dev).long()
    ib = torch.as_tensor(subsample_index(pb.shape[0], S, _np_dtype(dtype)), device=dev).long()
    return fitness_score_sub(pa[ia], va[ia].to(dtype), pb[ib], vb[ib].to(dtype), relpose7, max_range)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def fitness_info6(fitness: Tensor, var_gain_a: float, min_stddev_x: float, max_stddev_x: float,
                  min_stddev_q: float, max_stddev_q: float, fitness_score_thresh: float,
                  dtype: torch.dtype) -> Tensor:
    """The reference's fitness branch (information_matrix_calculator.cpp:
    37-50) with real parameters, on the device from a 0-d score tensor:
    interpolate the variances by the score (in f64, as the JAX package's
    host floats), round each to ``dtype``, and divide identity blocks by them
    in ``dtype`` (as its host ``/=`` on a ``dtype`` array)."""
    f = torch.clamp(fitness.to(torch.float64), max=fitness_score_thresh)
    w_x = weight(var_gain_a, fitness_score_thresh, min_stddev_x**2, max_stddev_x**2, f).to(dtype)
    w_q = weight(var_gain_a, fitness_score_thresh, min_stddev_q**2, max_stddev_q**2, f).to(dtype)
    one = torch.ones((), dtype=dtype, device=fitness.device)
    return torch.diag(torch.cat([(one / w_x).expand(3), (one / w_q).expand(3)]))
