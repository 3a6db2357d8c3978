"""Edge residuals and analytic Jacobians (port of
``semantic_slam_tpu.graph.residuals``; the plane residual is not ported yet).

* ``EdgeSE3`` between keyframes i, j with measurement Z:
  ``r = log(Z^-1 X_i^-1 X_j)`` in se(3), translation first.
* ``EdgeSE3PointXYZ`` with identity sensor offset: ``r = R_k^T (p_l - t_k) - z``.

Jacobians are w.r.t. right perturbations ``X <- X exp(xi)`` for poses and
additive updates for landmarks. Every function is batched over edges.
"""

from __future__ import annotations

import torch

from semantic_slam_tpu_torch.core import geometry as geo

Tensor = torch.Tensor


def se3_edge_residual(pose_i: Tensor, pose_j: Tensor, meas: Tensor) -> Tensor:
    rel = geo.pose_mul(geo.pose_inv(pose_i), pose_j)
    return geo.se3_log(geo.pose_mul(geo.pose_inv(meas), rel))


def se3_edge_residual_jac(pose_i: Tensor, pose_j: Tensor, meas: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Residual [...,6] and Jacobians [...,6,6] w.r.t. right perturbations of
    i and j: J_j = Jr^-1(r), J_i = -J_j Ad(T_ij^-1) with T_ij = X_i^-1 X_j."""
    rel = geo.pose_mul(geo.pose_inv(pose_i), pose_j)
    r = geo.se3_log(geo.pose_mul(geo.pose_inv(meas), rel))
    Jj = geo.se3_right_jacobian_inv(r)
    Ji = -(Jj @ geo.pose_adjoint(geo.pose_inv(rel)))
    return r, Ji, Jj


def se3_point_residual(pose_k: Tensor, lm: Tensor, meas: Tensor) -> Tensor:
    v = geo.quat_rotate(geo.quat_conj(pose_k[..., 3:]), lm - pose_k[..., :3])
    return v - meas


def se3_point_residual_jac(pose_k: Tensor, lm: Tensor, meas: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Residual [...,3], J_pose [...,3,6] = [-I | hat(v)], J_lm [...,3,3] = R^T."""
    Rt = geo.quat_to_rotmat(geo.quat_conj(pose_k[..., 3:]))
    v = torch.einsum("...ij,...j->...i", Rt, lm - pose_k[..., :3])
    r = v - meas
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(*r.shape[:-1], 3, 3)
    J_pose = torch.cat([-eye, geo.hat(v)], dim=-1)
    return r, J_pose, Rt
