"""Port of core.geometry, core.frames and core.linalg3 against the JAX
package, on the same seeded numpy inputs in f64, to 1e-12 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.core import frames as jfr
from semantic_slam_tpu.core import geometry as jgeo
from semantic_slam_tpu.core import linalg3 as jl3
from semantic_slam_tpu_torch.core import frames as tfr
from semantic_slam_tpu_torch.core import geometry as tgeo
from semantic_slam_tpu_torch.core import linalg3 as tl3

ATOL = 1e-12
N = 64


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _twists(rng, n=N):
    """Large, medium and tiny rotations: every Taylor / closed-form branch."""
    xi = rng.normal(size=(n, 6))
    xi[: n // 3, 3:] *= 1e-3
    xi[n // 3 : 2 * n // 3, 3:] *= 0.03
    xi[-2:, 3:] = 0.0
    return xi


def _poses(rng, n=N):
    return np.concatenate([rng.normal(size=(n, 3)), _quats(rng, n)], axis=-1)


def _rotmats(rng, n=N):
    q = _quats(rng, n)
    return np.array(jgeo.quat_to_rotmat(jnp.asarray(q)))


def _sym33(rng, n=N):
    A = rng.normal(size=(n, 3, 3))
    C = A @ np.swapaxes(A, -1, -2)
    C[:4] = np.eye(3)  # isotropic: the e_z fallback
    C[4:8] = np.diag([1.0, 1.0, 1e-9])  # plane-like
    return C


GEOMETRY_CASES = {
    "quat_mul": (lambda r: (_quats(r), _quats(r))),
    "quat_rotate": (lambda r: (_quats(r), r.normal(size=(N, 3)))),
    "quat_to_rotmat": (lambda r: (_quats(r),)),
    "rotmat_to_quat": (lambda r: (_rotmats(r),)),
    "hat": (lambda r: (r.normal(size=(N, 3)),)),
    "so3_exp_quat": (lambda r: (_twists(r)[:, 3:],)),
    "quat_log": (lambda r: (_quats(r),)),
    "so3_left_jacobian": (lambda r: (_twists(r)[:, 3:],)),
    "so3_left_jacobian_inv": (lambda r: (_twists(r)[:, 3:],)),
    "se3_Q_matrix": (lambda r: (_twists(r),)),
    "se3_right_jacobian_inv": (lambda r: (_twists(r),)),
    "pose_adjoint": (lambda r: (_poses(r),)),
    "pose_mul": (lambda r: (_poses(r), _poses(r))),
    "pose_inv": (lambda r: (_poses(r),)),
    "pose_apply": (lambda r: (_poses(r), r.normal(size=(N, 3)))),
    "se3_exp": (lambda r: (_twists(r),)),
    "se3_log": (lambda r: (_poses(r),)),
    "pose_retract": (lambda r: (_poses(r), _twists(r))),
    "rpy_to_rotmat": (lambda r: (r.uniform(-3, 3, size=(N, 3)),)),
    "rotmat_to_rpy": (lambda r: (_rotmats(r),)),
    "rpy_to_quat": (lambda r: (r.uniform(-3, 3, size=(N, 3)),)),
    "pose_to_xyzrpy": (lambda r: (_poses(r),)),
}


def _both(jfn, tfn, args):
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(torch.as_tensor(a) for a in args))
    return want, got


def _close(want, got):
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            _close(w, g)
        return
    g = got.numpy()
    assert g.dtype == np.float64
    np.testing.assert_allclose(g, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry(name):
    args = GEOMETRY_CASES[name](np.random.default_rng(0))
    _close(*_both(getattr(jgeo, name), getattr(tgeo, name), args))


@pytest.mark.parametrize("name", ["sym33_eigvals", "sym33_smallest_eig"])
def test_linalg3(name):
    C = _sym33(np.random.default_rng(1))
    _close(*_both(getattr(jl3, name), getattr(tl3, name), (C,)))


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "clean"])
def test_frame_chain(strict):
    rng = np.random.default_rng(2)
    xyzrpy = np.concatenate([rng.normal(size=3), rng.uniform(-1, 1, size=3)])
    pitch = np.float64(0.3)
    p_cam = rng.normal(size=(8, 3))
    n4 = np.concatenate([rng.normal(size=(8, 3)), rng.normal(size=(8, 1))], axis=-1)
    jx, jp = jnp.asarray(xyzrpy), jnp.asarray(pitch)
    tx, tp = torch.as_tensor(xyzrpy), torch.as_tensor(pitch)
    pairs = [
        (jfr.t_robot_world_reference(jx[3:], strict=strict), tfr.t_robot_world_reference(tx[3:], strict=strict)),
        (jfr.t_cam_robot(jp, dtype=jnp.float64), tfr.t_cam_robot(tp)),
        (jfr.t_cam_world(jx, jp, strict=strict), tfr.t_cam_world(tx, tp, strict=strict)),
        (jfr.convert_normal_to_world(jx, jp, jnp.asarray(n4), strict=strict),
         tfr.convert_normal_to_world(tx, tp, torch.as_tensor(n4), strict=strict)),
        (jfr.convert_cam_to_robot(jp, jnp.asarray(p_cam)), tfr.convert_cam_to_robot(tp, torch.as_tensor(p_cam))),
        (jfr.horizontal_plane_normal_in_cam(jx, jp, strict=strict),
         tfr.horizontal_plane_normal_in_cam(tx, tp, strict=strict)),
    ]
    for rtab in (False, True):
        pairs.append((
            jfr.convert_pose_to_world(jx, jp, jnp.asarray(p_cam), strict=strict, rtabmap_y_offset=rtab),
            tfr.convert_pose_to_world(tx, tp, torch.as_tensor(p_cam), strict=strict, rtabmap_y_offset=rtab),
        ))
    for want, got in pairs:
        _close(want, got)
