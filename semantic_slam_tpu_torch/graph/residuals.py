"""Edge residuals and analytic Jacobians (port of
``semantic_slam_tpu.graph.residuals``).

* ``EdgeSE3`` between keyframes i, j with measurement Z:
  ``r = log(Z^-1 X_i^-1 X_j)`` in se(3), translation first.
* ``EdgeSE3PointXYZ`` with identity sensor offset: ``r = R_k^T (p_l - t_k) - z``.
* ``EdgeSE3Plane`` (the VPS-SLAM paper's plane observation): the world
  plane pulled into the sensor frame against the observed plane, a tangent
  rotation error of the normal and the offset error.

Jacobians are w.r.t. right perturbations ``X <- X exp(xi)`` for poses,
additive updates for landmarks and the raw coefficients ``[n, d]`` for
planes. Every function is batched over edges.
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


def _plane_terms(pose: Tensor, plane4: Tensor, meas4: Tensor):
    """Shared by the residual and its Jacobian: (R^T, n_pred, residual,
    a1, a2) with a_i = n_meas x t_i, where r_i = n_pred . a_i."""
    n_w = plane4[..., :3]
    Rt = geo.quat_to_rotmat(geo.quat_conj(pose[..., 3:]))
    n_pred = torch.einsum("...ij,...j->...i", Rt, n_w)
    d_pred = plane4[..., 3] + torch.sum(n_w * pose[..., :3], dim=-1)
    # (n, d) and (-n, -d) are one plane, and the frontend's orientation rules
    # can flip a plane's observed sign between viewpoints: the measurement
    # takes the prediction's hemisphere before differencing
    sign = torch.where(torch.sum(n_pred * meas4[..., :3], dim=-1) < 0, -1.0, 1.0).to(meas4.dtype)
    meas4 = meas4 * sign[..., None]
    n_meas = meas4[..., :3]
    # the normal's rotation error n_pred x n_meas on two tangent directions of
    # n_meas; (n_pred x n_meas) . t = n_pred . (n_meas x t)
    ez = n_meas.new_tensor([0.0, 0.0, 1.0])
    ex = n_meas.new_tensor([1.0, 0.0, 0.0])
    ref = torch.where(torch.abs(n_meas[..., 2:3]) < 0.9, ez, ex).expand_as(n_meas)
    t1 = torch.linalg.cross(n_meas, ref, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
    t2 = torch.linalg.cross(n_meas, t1, dim=-1)
    e_rot = torch.linalg.cross(n_pred, n_meas, dim=-1)
    r = torch.stack([torch.sum(e_rot * t1, dim=-1), torch.sum(e_rot * t2, dim=-1), d_pred - meas4[..., 3]], dim=-1)
    a1 = torch.linalg.cross(n_meas, t1, dim=-1)
    a2 = torch.linalg.cross(n_meas, t2, dim=-1)
    return Rt, n_pred, r, a1, a2


def se3_plane_residual(pose: Tensor, plane4: Tensor, meas4: Tensor) -> Tensor:
    """3-dof plane observation residual (``include/g2o/edge_se3_plane.hpp``;
    registered nowhere in the reference release, ``graph_slam.cpp:30-33``).

    ``plane4 = [n (unit), d]`` in the world, ``meas4`` the plane seen in the
    sensor frame of ``pose``. Prediction: n_pred = R^T n, d_pred = d + n . t.
    Error: the cross product n_pred x n_meas (the first-order form of g2o's
    azimuth/elevation difference) on two tangent directions of n_meas, and
    d_pred - d_meas, after the measurement is put in the prediction's
    hemisphere."""
    return _plane_terms(pose, plane4, meas4)[2]


def se3_plane_residual_jac(pose: Tensor, plane4: Tensor, meas4: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Residual [...,3], J_pose [...,3,6] w.r.t. the right perturbation
    [rho, phi] of the pose, and J_plane [...,3,4] w.r.t. the raw ``[n, d]``.

    Closed form of the forward-mode Jacobian the JAX package takes: the
    hemisphere sign and the tangent reference are piecewise constant, so
    each branch differentiates as its own smooth function. With
    n_pred' = n_pred + hat(n_pred) phi and
    d_pred' = d_pred + n_pred . rho at first order:
    rows 0-1 = [0, (a_i x n_pred)^T] and [a_i^T R^T, 0];
    row 2 = [n_pred^T, 0] and [t^T, 1]."""
    Rt, n_pred, r, a1, a2 = _plane_terms(pose, plane4, meas4)
    z3 = torch.zeros_like(n_pred)
    J_pose = torch.stack([
        torch.cat([z3, torch.linalg.cross(a1, n_pred, dim=-1)], dim=-1),
        torch.cat([z3, torch.linalg.cross(a2, n_pred, dim=-1)], dim=-1),
        torch.cat([n_pred, z3], dim=-1),
    ], dim=-2)
    one = torch.ones_like(r[..., :1])
    zero = torch.zeros_like(one)
    J_plane = torch.stack([
        torch.cat([torch.einsum("...i,...ij->...j", a1, Rt), zero], dim=-1),
        torch.cat([torch.einsum("...i,...ij->...j", a2, Rt), zero], dim=-1),
        torch.cat([pose[..., :3], one], dim=-1),
    ], dim=-2)
    return r, J_pose, J_plane
