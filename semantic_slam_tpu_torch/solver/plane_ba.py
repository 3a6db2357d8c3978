"""Plane-landmark parameterization (port of the parts of
``semantic_slam_tpu.solver.plane_ba`` that the engine's plane landmarks use).

A plane is ``[n, d]`` with a unit normal ``n``; its local parameterization
has 3 dof, two normal-tangent components and the offset:
``n' = normalize(n + t1 u + t2 v)``, ``d' = d + dd`` with (u, v) the
normal's in-plane basis (``frontend/hull.plane_basis``).

``plane_bundle_adjust`` is the JAX module's whole-problem proof of concept
(no engine path calls it in either package): a damped Gauss-Newton over a
``PlaneGraph`` of poses and planes with the forward-mode Jacobian of the
whitened residual vector (``torch.func.jacfwd``, as the JAX module's
``jax.jacfwd``) and a dense Cholesky solve, sized for tens of planes and
hundreds of keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from semantic_slam_tpu_torch.core import geometry as geo
from semantic_slam_tpu_torch.frontend.hull import plane_basis
from semantic_slam_tpu_torch.graph import residuals as res

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


class PlaneGraph(NamedTuple):
    poses: Tensor  # [K, 7]
    planes: Tensor  # [P, 4] (unit n, d)
    num_poses: Tensor
    num_planes: Tensor
    # odometry chain
    odom_i: Tensor
    odom_j: Tensor
    odom_meas: Tensor  # [E1, 7]
    odom_info: Tensor  # [E1, 6, 6]
    num_odom: Tensor
    # plane observations: pose k sees plane p as meas4 in its sensor frame
    pe_k: Tensor
    pe_p: Tensor
    pe_meas: Tensor  # [E2, 4]
    pe_info: Tensor  # [E2, 3, 3]
    num_pe: Tensor


def _residual_vector(g: PlaneGraph, dp: Tensor, dpl: Tensor) -> Tensor:
    """All whitened residuals at the retracted state; dp [K,6], dpl [P,3]."""
    poses = geo.pose_retract(g.poses, dp)
    planes = plane_retract(g.planes, dpl)
    dtype = poses.dtype
    om = (torch.arange(g.odom_i.shape[0], device=poses.device) < g.num_odom).to(dtype)
    oi, oj = g.odom_i.long(), g.odom_j.long()
    r_o = res.se3_edge_residual(poses[oi], poses[oj], g.odom_meas)
    Lo = torch.linalg.cholesky(g.odom_info + 1e-9 * torch.eye(6, dtype=dtype, device=poses.device)[None])
    r_o = torch.einsum("eji,ej->ei", Lo, r_o) * om[:, None]
    pm = (torch.arange(g.pe_k.shape[0], device=poses.device) < g.num_pe).to(dtype)
    r_p = res.se3_plane_residual(poses[g.pe_k.long()], planes[g.pe_p.long()], g.pe_meas)
    Lp = torch.linalg.cholesky(g.pe_info + 1e-9 * torch.eye(3, dtype=dtype, device=poses.device)[None])
    r_p = torch.einsum("eji,ej->ei", Lp, r_p) * pm[:, None]
    return torch.cat([r_o.reshape(-1), r_p.reshape(-1)])


def plane_bundle_adjust(g: PlaneGraph, max_iterations: int = 32,
                        rel_tol: float = 1e-8) -> tuple[PlaneGraph, Tensor, Tensor]:
    """Damped GN over poses + planes. Returns (graph, chi2_initial,
    chi2_final). Pose 0 is gauge-fixed; inactive capacity slots are frozen.
    The loop fetches its (accept, done) pair once an iteration."""
    K, P = g.poses.shape[0], g.planes.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    pidx = torch.arange(K, device=dev)
    pose_free = ((pidx < g.num_poses) & (pidx > 0)).to(dtype)
    plane_free = (torch.arange(P, device=dev) < g.num_planes).to(dtype)
    free = torch.cat([pose_free.repeat_interleave(6), plane_free.repeat_interleave(3)])
    n_var = 6 * K + 3 * P
    zk, zp = torch.zeros((K, 6), dtype=dtype, device=dev), torch.zeros((P, 3), dtype=dtype, device=dev)

    def chi2_of(state):
        r = _residual_vector(state, zk, zp)
        return torch.sum(r * r)

    state = g
    chi2 = chi2_0 = _residual_vector(g, zk, zp).square().sum()
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    nu = 2.0
    for _ in range(max_iterations):
        def r_state(x, s=state):
            return _residual_vector(s._replace(poses=geo.pose_retract(s.poses, x[: 6 * K].reshape(K, 6)),
                                               planes=plane_retract(s.planes, x[6 * K:].reshape(P, 3))), zk, zp)

        zero = torch.zeros((n_var,), dtype=dtype, device=dev)
        r0 = r_state(zero)
        J = torch.func.jacfwd(r_state)(zero) * free[None, :]  # [R, n_var]
        H = J.T @ J + lam * torch.eye(n_var, dtype=dtype, device=dev) + torch.diag(1.0 - free)
        b = -(J.T @ r0) * free
        dx = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(H))[:, 0]
        trial = state._replace(poses=geo.pose_retract(state.poses, dx[: 6 * K].reshape(K, 6)),
                               planes=plane_retract(state.planes, dx[6 * K:].reshape(P, 3)))
        chi2_new = chi2_of(trial)
        pred = lam * torch.dot(dx, dx) - torch.dot(dx, -b)
        rho = (chi2 - chi2_new) / torch.clamp(pred, min=1e-12)
        accept_t = (rho > 0) & torch.isfinite(chi2_new)
        lam_next = torch.where(accept_t, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * nu)
        done_t = (accept_t & ((chi2 - chi2_new) <= rel_tol * torch.clamp(chi2, min=1e-12))) | (lam_next > 1e12)
        accept, done = torch.stack([accept_t, done_t]).tolist()  # one host fetch an iteration
        if accept:
            state, chi2, nu = trial, chi2_new, 2.0
        else:
            nu *= 2.0
        lam = lam_next
        if done:
            break
    return state, chi2_0, chi2
