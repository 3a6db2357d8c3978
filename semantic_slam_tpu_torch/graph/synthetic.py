"""Seeded synthetic pose graphs for the solver (the port's own copy of
``__graft_entry__._build_graph`` and ``_ell_rows_for``): a noisy odometry
chain plus random landmark observations, built in numpy and moved to the
device once. Same seed, same arrays as the original."""

from __future__ import annotations

import numpy as np
import torch

from semantic_slam_tpu_torch.graph.state import GraphState


def _np_qmul(a, b):
    aw, ax, ay, az = a.T
    bw, bx, by, bz = b.T
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _np_qrot(q, v):
    w, u = q[..., :1], q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def build_graph(K: int, L: int, E2: int, dtype=torch.float32, seed: int = 0, noise: float = 0.01,
                device=None) -> GraphState:
    """Capacities K poses, L landmarks, E2 observation edges; K-2 poses,
    L-2 landmarks, K-3 chain edges and E2-8 observations are active. The
    observations are sorted by keyframe with a balanced static per-pose bound
    (``ell_rows_for``), the engine's construction invariant."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n_poses, n_lms, n_odom, n_obs = K - 2, L - 2, K - 3, E2 - 8

    t_rel = rng.normal(size=(n_poses - 1, 3)) * 0.3 + [0.5, 0, 0]
    q_rel = np.roll(Rotation.from_rotvec(rng.normal(size=(n_poses - 1, 3)) * 0.1).as_quat(), 1, -1)

    def integrate(t_rels, q_rels):
        ts = [np.zeros(3)]
        qs = [np.array([1.0, 0, 0, 0])]
        for tr, qr in zip(t_rels, q_rels):
            ts.append(ts[-1] + _np_qrot(qs[-1][None], tr[None])[0])
            q = _np_qmul(qs[-1][None], qr[None])[0]
            qs.append(q / np.linalg.norm(q))
        return np.stack(ts), np.stack(qs)

    gt_t, gt_q = integrate(t_rel, q_rel)
    tn_rel = t_rel + rng.normal(size=t_rel.shape) * noise
    dq = np.roll(Rotation.from_rotvec(rng.normal(size=q_rel.shape[:-1] + (3,)) * noise).as_quat(), 1, -1)
    qn_rel = _np_qmul(q_rel, dq)
    odo_t, odo_q = integrate(tn_rel, qn_rel)

    lm_world = rng.uniform(-2, 2, size=(n_lms, 3)) + gt_t[rng.integers(0, n_poses, n_lms)]
    r_max = -(-n_obs // n_poses)
    ks = np.sort(rng.permutation(np.tile(np.arange(n_poses), r_max))[:n_obs])
    ls = rng.integers(0, n_lms, size=n_obs)
    qc = gt_q[ks] * [1.0, -1, -1, -1]
    z = _np_qrot(qc, lm_world[ls] - gt_t[ks])

    def pad(a, n):
        a = np.asarray(a, np.float64)
        out = np.zeros((n,) + a.shape[1:], np.float64)
        out[: len(a)] = a
        return out

    ident = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
    poses = np.tile(ident, (K, 1))
    poses[:n_poses] = np.concatenate([odo_t, odo_q], axis=-1)
    odom_meas = np.tile(ident, (K, 1))
    odom_meas[:n_odom] = np.concatenate([tn_rel[:n_odom], qn_rel[:n_odom]], axis=-1)

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    return GraphState(
        poses=f(poses),
        num_poses=i32(n_poses),
        landmarks=f(pad(lm_world, L)),
        num_landmarks=i32(n_lms),
        odom_i=i32(pad(np.arange(n_odom), K)),
        odom_j=i32(pad(np.arange(1, n_odom + 1), K)),
        odom_meas=f(odom_meas),
        odom_info=f(np.tile(np.eye(6) * 100.0, (K, 1, 1))),
        num_odom=i32(n_odom),
        lme_k=i32(pad(ks, E2)),
        lme_l=i32(pad(ls, E2)),
        lme_meas=f(pad(z, E2)),
        lme_info=f(np.tile(np.eye(3) * 10.0, (E2, 1, 1))),
        num_lme=i32(n_obs),
    )


def ell_rows_for(K: int, E2: int) -> tuple:
    """Static (R_oi, R_oj, R_lk) bounds matching ``build_graph``'s layout."""
    n_poses, n_obs = K - 2, E2 - 8
    return (1, 1, -(-n_obs // n_poses))
