"""Reference-faithful frame-transform chains (port of
``semantic_slam_tpu.core.frames``).

Reproduces the reference's ``semantic_tools`` numerics exactly, including the
truncated constants (``1.5708`` for pi/2) and the (0,2) typo of the
robot->world rotation (``strict=True``). The per-odometry-source fixups (``pose_ned_to_enu``,
``pose_cam_to_robot_odom``, ``rot_pose_z``, ``rebase_to_origin``) are here
on tensors; the engine's host path applies their numpy copies in
``core/np_geometry.py``.

Scalar angles are passed as 0-d tensors, which carry the dtype and device.
"""

from __future__ import annotations

import torch

from semantic_slam_tpu_torch.core import geometry as geo

Tensor = torch.Tensor

# The reference uses these truncated constants everywhere; keep them bit-exact.
REF_HALF_PI = 1.5708  # tools.h:53 etc.


def _rot_x44(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([o, z, z, z]),
            torch.stack([z, c, -s, z]),
            torch.stack([z, s, c, z]),
            torch.stack([z, z, z, o]),
        ]
    )


def _rot_z44(a: Tensor) -> Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack([c, -s, z, z]),
            torch.stack([s, c, z, z]),
            torch.stack([z, z, o, z]),
            torch.stack([z, z, z, o]),
        ]
    )


def t_robot_world_reference(rpy: Tensor, strict: bool = True) -> Tensor:
    """Reference robot->world rotation (4x4, zero translation), tools.h:76-92.

    ``strict=True`` keeps the reference's (0,2) typo ``cy*sp*cr + sy*sp``
    (the correct ZYX term is ``cy*sp*cr + sy*sr``) for trajectory parity.
    """
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    e02 = cy * sp * cr + (sy * sp if strict else sy * sr)
    z = torch.zeros_like(r)
    o = torch.ones_like(r)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, e02, z], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr, z], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr, z], dim=-1)
    row3 = torch.stack([z, z, z, o], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def t_cam_robot(cam_pitch: Tensor) -> Tensor:
    """cam->robot chain Rz(-90deg) @ Rx(-90deg) @ Rx(-cam_pitch), tools.h:104-135."""
    half_pi = torch.full_like(cam_pitch, -REF_HALF_PI)
    return _rot_z44(half_pi) @ _rot_x44(half_pi) @ _rot_x44(-cam_pitch)


def t_cam_world(robot_xyzrpy: Tensor, cam_pitch: Tensor, strict: bool = True) -> Tensor:
    """cam->world rotation chain (zero translation), tools.h:18-102."""
    Trw = t_robot_world_reference(robot_xyzrpy[..., 3:6], strict=strict)
    return Trw @ t_cam_robot(cam_pitch.to(robot_xyzrpy.dtype))


def convert_pose_to_world(
    robot_xyzrpy: Tensor,
    cam_pitch: Tensor,
    p_cam: Tensor,
    strict: bool = True,
    rtabmap_y_offset: bool = False,
) -> Tensor:
    """Detection centroid cam-frame -> world frame, data_association.h:320-343:
    rotate [x,y,z,1] by the cam->world chain, then add the robot translation."""
    T = t_cam_world(robot_xyzrpy, cam_pitch, strict=strict)
    ph = torch.cat([p_cam[..., :3], torch.ones_like(p_cam[..., :1])], dim=-1)
    out = torch.einsum("...ij,...j->...i", T, ph)[..., :3]
    t = robot_xyzrpy[..., :3]
    if rtabmap_y_offset:
        t = t - t.new_tensor([0.0, 0.04, 0.0])
    return out + t


def convert_normal_to_world(
    robot_xyzrpy: Tensor, cam_pitch: Tensor, n_cam4: Tensor, strict: bool = True
) -> Tensor:
    """Normal [nx,ny,nz,d] cam->world; the 4x4 chain has no translation, so d
    passes through (data_association.h:345-359)."""
    T = t_cam_world(robot_xyzrpy, cam_pitch, strict=strict)
    return torch.einsum("...ij,...j->...i", T, n_cam4)


def convert_cam_to_robot(cam_pitch: Tensor, p_cam: Tensor) -> Tensor:
    """Detection centroid cam -> robot frame (data_association.h:361-373)."""
    T = t_cam_robot(cam_pitch.to(p_cam.dtype))
    ph = torch.cat([p_cam[..., :3], torch.ones_like(p_cam[..., :1])], dim=-1)
    return torch.einsum("ij,...j->...i", T, ph)[..., :3]


def horizontal_plane_normal_in_cam(
    robot_xyzrpy: Tensor, cam_pitch: Tensor, strict: bool = True
) -> Tensor:
    """World +z rotated into the camera frame by the transposed chain
    (plane_segmentation.cpp:119-131)."""
    T = t_cam_world(robot_xyzrpy, cam_pitch, strict=strict)
    n_world = T.new_tensor([0.0, 0.0, 1.0, 0.0])
    return torch.einsum("...ji,...j->...i", T, n_world)  # T^T @ n


# ---------------------------------------------------------------------------
# Per-odometry-source ingestion fixups (ros_utils.hpp), on tensors. The
# engine's host path applies the ``np_geometry`` copies of these; these are
# for odometry already on the device.
# ---------------------------------------------------------------------------

REF_PI = 3.14  # ros_utils.hpp:205 (NED->ENU)
REF_HALF_PI_SHORT = 1.57  # ros_utils.hpp:248 (RotPoseZ)


def _euler_vector_fixup(pose7: Tensor, M: Tensor, rpy: Tensor) -> Tensor:
    """The reference's fixups rotate the Euler-angle vector and the
    translation by one 3x3 matrix and rebuild the quaternion."""
    rpy_r = torch.einsum("ij,...j->...i", M, rpy)
    t_r = torch.einsum("ij,...j->...i", M, pose7[..., :3])
    return geo.pose_make(t_r, geo.rpy_to_quat(rpy_r))


def pose_ned_to_enu(pose7: Tensor) -> Tensor:
    """Snap-VIO NED->ENU fixup, ``ros_utils.hpp:192-231``: the Euler-angle
    vector and the translation multiplied by the reference's matrix with
    both off-diagonal terms sin(-3.14) (not a rotation), verbatim."""
    a = torch.tensor(-REF_PI, dtype=pose7.dtype, device=pose7.device)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    M = torch.stack([torch.stack([o, z, z]), torch.stack([z, c, s]), torch.stack([z, s, c])])
    return _euler_vector_fixup(pose7, M, geo.quat_to_rpy(pose7[..., 3:]))


def pose_cam_to_robot_odom(pose7: Tensor) -> Tensor:
    """ORB-SLAM camera-frame odometry -> robot frame, ``ros_utils.hpp:143-190``:
    the Euler-angle vector and the translation rotated by Rz(-90)Rx(-90)."""
    a = torch.tensor(-REF_HALF_PI, dtype=pose7.dtype, device=pose7.device)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rot_x = torch.stack([torch.stack([o, z, z]), torch.stack([z, c, -s]), torch.stack([z, s, c])])
    rot_z = torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]), torch.stack([z, z, o])])
    return _euler_vector_fixup(pose7, rot_z @ rot_x, geo.quat_to_rpy(pose7[..., 3:]))


def rot_pose_z(pose7: Tensor, first_yaw) -> Tensor:
    """Jackal odometry yaw-rebase + 90deg yaw rotation, ``ros_utils.hpp:233-271``."""
    a = torch.tensor(REF_HALF_PI_SHORT, dtype=pose7.dtype, device=pose7.device)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    M = torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]), torch.stack([z, z, o])])
    rpy = geo.quat_to_rpy(pose7[..., 3:])
    yaw = rpy[..., 2] - torch.as_tensor(first_yaw, dtype=pose7.dtype, device=pose7.device)
    return _euler_vector_fixup(pose7, M, torch.cat([rpy[..., :2], yaw[..., None]], dim=-1))


def rebase_to_origin(pose7: Tensor, origin_t: Tensor) -> Tensor:
    """Subtract the first-sample translation, ``ros_utils.hpp:273-286``."""
    return torch.cat([pose7[..., :3] - origin_t, pose7[..., 3:]], dim=-1)
