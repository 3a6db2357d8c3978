"""The benchmark's inputs, made from the seed: planar semantic objects, the
ground-truth path, a drifting VIO stream, organized clouds or depth images
rendered on the device, and the projected detector boxes.

The object layouts, the circle and straight paths, the box projection and
the VIO drift model are a frozen copy of the port's ``io/synthetic.py``
(``dense_indoor_scene``, ``kitti_scene``, ``circle_trajectory``,
``straight_trajectory``, ``project_bbox``, ``make_synthetic_log``'s drift);
the renderer is that module's ``render_cloud`` ray cast, batched over frames
on the device, with a pinhole of its own (fx, fy, cx, cy). Added here: the
session log of the indoor cells (one round of frames rendered and reused,
since the loop repeats its poses exactly) and the KITTI-00 drive (cars
parked along both sides, depth images).

The object layout and the VIO drift come from the scene's ``layout_seed``;
the run's seed draws, for each session of the indoor log and for the drive,
a rigid motion of the whole world (a yaw and a shift in the plane) that
carries the ground truth and the VIO (``placed``). Frames and boxes are
rendered in the layout's own coordinates, which the motion leaves as they
are in the camera, so every seed and session gives the engine the same
frames, boxes and drift (the same sizes of work and the same map error) in
other world coordinates, where the float32 engine rounds otherwise.

A ``Stream`` holds what the feeder delivers: VIO at ``odom_t``, and at the
sensor steps a frame (cloud or depth image) and the detections of that step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_bench import np_geometry as npg


@dataclasses.dataclass
class PlanarObject:
    class_id: int
    center: np.ndarray  # world [3]
    normal: np.ndarray  # world unit [3]
    half_u: float  # half-extent along the in-plane u axis [m]
    half_v: float

    def basis(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.normal / np.linalg.norm(self.normal)
        ref = np.array([0.0, 0, 1]) if abs(n[2]) < 0.9 else np.array([1.0, 0, 0])
        u = np.cross(n, ref)
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        return u, v


@dataclasses.dataclass(frozen=True)
class Camera:
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    max_depth: float

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float64)


@dataclasses.dataclass
class Stream:
    """One log as the feeder replays it. ``frame_of[s]`` is the frame of
    sensor step s (frames may repeat), ``dets[s]`` its (boxes, class ids,
    probs) or None; ``frames`` holds (points f32 [H,W,3], valid [H,W]) for
    clouds, or a u16 depth [H,W] with ``depth_scale`` for depth images."""

    odom_t: np.ndarray  # [N]
    odom: np.ndarray  # [N, 7] VIO
    gt: np.ndarray  # [N, 7]
    sensor_step: np.ndarray  # [S] VIO step of each sensor event
    frame_of: np.ndarray  # [S]
    dets: list
    frames: list
    camera: Camera
    depth_scale: float | None = None  # None: clouds

    @property
    def depth_input(self) -> bool:
        return self.depth_scale is not None


def dense_indoor_scene(rng: np.random.Generator) -> list[PlanarObject]:
    """All 7 semantic classes in one room (BASELINE config #4)."""
    specs = [
        (0, [2.0, 2.5, 0.45], [0, 0, 1], 0.45, 0.45),  # chair seat (horizontal)
        (1, [4.0, 0.0, 1.0], [-1, 0, 0], 0.45, 0.35),  # tvmonitor
        (2, [0.0, 3.0, 0.9], [0, -1, 0], 0.25, 0.18),  # book face
        (3, [2.5, -0.8, 0.75], [0, 0, 1], 0.35, 0.15),  # keyboard (horizontal)
        (4, [-0.5, 2.0, 0.8], [1, 0, 0], 0.3, 0.25),  # laptop lid
        (5, [-1.5, 1.0, 0.4], [1, 0, 0], 0.35, 0.5),  # bucket side
        (6, [1.0, -1.8, 0.7], [0, 1, 0], 1.2, 0.5),  # car side panel
    ]
    out = []
    for cid, c, n, hu, hv in specs:
        jitter = rng.uniform(-0.1, 0.1, size=3)
        out.append(PlanarObject(cid, np.asarray(c, float) + jitter, np.asarray(n, float), hu, hv))
    return out


def parked_cars(rng: np.random.Generator, length: float, spacing: float) -> list[PlanarObject]:
    """'car' side panels (``kitti_scene``'s 3.6 m x 1.2 m, 0.7 m up, facing
    the road) parked alternately left and right of a road along +x, one every
    ``spacing`` metres from 6 m to ``length``."""
    objs = []
    for i in range(int((length - 6.0) // spacing) + 1):
        side = -1.0 if i % 2 == 0 else 1.0
        x = 6.0 + i * spacing + rng.uniform(-0.25, 0.25) * spacing
        y = side * rng.uniform(3.0, 4.5)
        objs.append(PlanarObject(6, np.array([x, y, 0.7]), np.array([0.0, -side, 0.0]), 1.8, 0.6))
    return objs


def circle_trajectory(n: int, radius: float = 1.2, center=(1.2, 1.2), z: float = 0.0) -> np.ndarray:
    """Yaw-following circular loop (flat: roll = pitch = 0)."""
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n
        x = center[0] + radius * np.cos(th)
        y = center[1] + radius * np.sin(th)
        yaw = th + np.pi / 2
        q = npg.rpy_to_quat(np.array([0.0, 0.0, yaw]))
        out.append(np.concatenate([[x, y, z], q]))
    return np.stack(out)


def straight_trajectory(n: int, step: float, z: float = 0.0, wiggle: float = 0.02) -> np.ndarray:
    """Forward drive along +x with a mild yaw wiggle."""
    yaw = wiggle * np.sin(np.arange(n) / 25.0)
    x = np.cumsum(step * np.cos(yaw))
    y = np.cumsum(step * np.sin(yaw))
    q = npg.rpy_to_quat(np.stack([np.zeros(n), np.zeros(n), yaw], axis=-1))
    return np.concatenate([np.stack([x, y, np.full(n, z)], axis=-1), q], axis=-1)


def seed_motion(seed: int, session: int = 0) -> np.ndarray:
    """The pose [t, q] of the world of a seed's session: a yaw in [0, 2 pi)
    and a shift of up to 5 m in x and y."""
    rng = np.random.default_rng([seed, 1, session])
    yaw, tx, ty = rng.uniform(0.0, 2 * np.pi), rng.uniform(-5.0, 5.0), rng.uniform(-5.0, 5.0)
    return np.concatenate([[tx, ty, 0.0], npg.rpy_to_quat(np.array([0.0, 0.0, yaw]))])


def move(T: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Poses [N, 7] carried by the rigid motion T."""
    return npg.pose_mul(np.broadcast_to(T, poses.shape), poses)


def placed(stream: "Stream", seed: int, session: int) -> "Stream":
    """The stream with its VIO and ground truth in the world of a seed's
    session (frames and boxes shared)."""
    T = seed_motion(seed, session)
    return dataclasses.replace(stream, odom=move(T, stream.odom), gt=move(T, stream.gt))


def drift_vio(gt: np.ndarray, rng: np.random.Generator, drift_noise: float) -> np.ndarray:
    """Integrated odometry with a random walk of ``drift_noise`` a step in
    translation and a tenth of it in rotation (``make_synthetic_log``)."""
    vio = np.empty_like(gt)
    vio[0] = gt[0]
    noise = rng.normal(size=(len(gt), 6)) * drift_noise
    noise[:, 3:] *= 0.1
    for i in range(1, len(gt)):
        rel = npg.pose_mul(npg.pose_inv(gt[i - 1]), gt[i])
        vio[i] = npg.pose_mul(vio[i - 1], npg.pose_retract(rel, noise[i]))
    return vio


def world_to_cam(robot_pose7: np.ndarray, cam_pitch: float = 0.0) -> np.ndarray:
    """The world -> camera rotation of the reference frame chain."""
    return npg.t_cam_world(npg.pose_to_xyzrpy(robot_pose7), cam_pitch)[:3, :3].T


def project_bbox(robot_pose7: np.ndarray, obj: PlanarObject, cam: Camera, R_wc: np.ndarray):
    """The object's rectangle corners projected into the image: the fake
    detector's box (tl_x, tl_y, w, h), or None when a corner is behind the
    camera or the clipped box is under 12 px a 320-px width."""
    t_w = robot_pose7[:3]
    ub, vb = obj.basis()
    uv = []
    for su in (-1, 1):
        for sv in (-1, 1):
            pc = R_wc @ (obj.center + su * obj.half_u * ub + sv * obj.half_v * vb - t_w)
            if pc[2] < 0.15:
                return None
            uv.append([cam.cx + cam.fx * pc[0] / pc[2], cam.cy + cam.fy * pc[1] / pc[2]])
    uv = np.array(uv)
    x0, y0 = np.maximum(uv.min(axis=0), 0.0)
    x1, y1 = min(float(cam.W), uv[:, 0].max()), min(float(cam.H), uv[:, 1].max())
    min_px = max(6.0, 12.0 * cam.W / 320.0)
    if x1 - x0 < min_px or y1 - y0 < min_px:
        return None
    return np.array([x0, y0, x1 - x0, y1 - y0])


def detections(pose7: np.ndarray, objects: list[PlanarObject], cam: Camera, max_dets: int):
    """The boxes of the visible objects, nearest first, at most ``max_dets``;
    None when none is visible."""
    seen = []
    R_wc = world_to_cam(pose7)
    for obj in objects:
        bb = project_bbox(pose7, obj, cam, R_wc)
        if bb is not None:
            seen.append((float(np.linalg.norm(obj.center - pose7[:3])), bb, obj.class_id))
    if not seen:
        return None
    seen.sort(key=lambda s: s[0])
    seen = seen[:max_dets]
    return (np.stack([s[1] for s in seen]), np.array([s[2] for s in seen], np.int32), np.full(len(seen), 0.9))


def render_depth(poses7: np.ndarray, objects: list[PlanarObject], cam: Camera, device, near: np.ndarray | None = None,
                 chunk: int = 16) -> torch.Tensor:
    """Camera-frame depth z [F, H, W] (inf where no object is hit) of each
    pose, ray-cast in float32 on ``device``. ``near`` [F, J] lists the objects
    each frame tests (all of them when None)."""
    dev = torch.device(device)
    f32 = torch.float32
    u = torch.arange(cam.W, dtype=f32, device=dev)[None, :].expand(cam.H, cam.W)
    v = torch.arange(cam.H, dtype=f32, device=dev)[:, None].expand(cam.H, cam.W)
    dirs_c = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], dim=-1)
    R_cw = np.stack([npg.t_cam_world(npg.pose_to_xyzrpy(p), 0.0)[:3, :3] for p in poses7])
    bases = [o.basis() for o in objects]
    obj = torch.tensor(np.array([np.concatenate([o.center, o.normal / np.linalg.norm(o.normal), b[0], b[1],
                                                 [o.half_u, o.half_v]]) for o, b in zip(objects, bases)]),
                       dtype=f32, device=dev)  # [O, 14]
    idx = torch.as_tensor(np.arange(len(objects))[None].repeat(len(poses7), 0) if near is None else near,
                          device=dev)
    out = []
    for f0 in range(0, len(poses7), chunk):
        R = torch.tensor(R_cw[f0:f0 + chunk], dtype=f32, device=dev)  # [F, 3, 3]
        t = torch.tensor(poses7[f0:f0 + chunk, :3], dtype=f32, device=dev)  # [F, 3]
        dirs_w = torch.einsum("hwj,fij->fhwi", dirs_c, R)  # [F, H, W, 3]
        depth = torch.full(dirs_w.shape[:3], float("inf"), dtype=f32, device=dev)
        for j in range(idx.shape[1]):
            o = obj[idx[f0:f0 + chunk, j]]  # [F, 14]
            c, n, ub, vb, hu, hv = o[:, 0:3], o[:, 3:6], o[:, 6:9], o[:, 9:12], o[:, 12], o[:, 13]
            denom = torch.einsum("fhwi,fi->fhw", dirs_w, n)
            s = torch.sum((c - t) * n, dim=-1)[:, None, None] / denom
            rel = dirs_w * s[..., None] + (t - c)[:, None, None, :]
            du = torch.einsum("fhwi,fi->fhw", rel, ub)
            dv = torch.einsum("fhwi,fi->fhw", rel, vb)
            ok = (s > 0.1) & (du.abs() <= hu[:, None, None]) & (dv.abs() <= hv[:, None, None])
            better = ok & (s < depth) & (s < cam.max_depth)  # camera z == s, since dirs_c.z == 1
            depth = torch.where(better, s, depth)
        out.append(depth)
    return torch.cat(out)


def depth_to_cloud(depth: torch.Tensor, cam: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Organized cloud (points f32 [F,H,W,3], valid [F,H,W]) of rendered
    depths, as ``render_cloud`` returns it: zero points where invalid."""
    dt = depth.dtype
    u = torch.arange(cam.W, dtype=dt, device=depth.device)[None, :]
    v = torch.arange(cam.H, dtype=dt, device=depth.device)[:, None]
    valid = torch.isfinite(depth)
    z = torch.where(valid, depth, 0.0)
    pts = torch.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], dim=-1)
    return pts.to(torch.float32).cpu().numpy(), valid.cpu().numpy()


def depth_to_u16(depth: torch.Tensor, scale: float) -> np.ndarray:
    """u16 depth images (0 where invalid), as ``clouds_to_depth`` makes them."""
    ok = torch.isfinite(depth) & (depth > 0)
    d = torch.where(ok, torch.clamp(torch.round(torch.where(ok, depth, 0.0) / scale), 1, 65535), 0.0)
    return d.to(torch.int32).cpu().numpy().astype(np.uint16)


def indoor_session(scene: dict, seed: int, device) -> Stream:
    """The indoor session log (config ``scene.kind == "dense_indoor"``):
    ``rounds`` rounds of the circle at ``steps_per_round`` VIO steps a round,
    a frame and detections every ``sensor_every`` steps. One round of frames
    is rendered; later rounds reuse it."""
    layout = np.random.default_rng(scene["layout_seed"])
    objects = dense_indoor_scene(layout)
    cam = Camera(scene["height"], scene["width"], scene["fx"], scene["fy"], scene["cx"], scene["cy"],
                 scene["max_depth"])
    per_round, rounds, every = scene["steps_per_round"], scene["rounds"], scene["sensor_every"]
    if per_round % every:
        raise ValueError("steps_per_round must be a multiple of sensor_every")
    one = circle_trajectory(per_round, radius=scene["radius"], center=tuple(scene["center"]))
    gt = np.concatenate([one] * rounds)
    vio = drift_vio(gt, layout, scene["drift_noise"])
    steps = np.arange(0, len(gt), every)
    round_steps = steps[steps < per_round]
    cloud_pts, cloud_valid = depth_to_cloud(render_depth(gt[round_steps], objects, cam, device), cam)
    frames = [(cloud_pts[i], cloud_valid[i]) for i in range(len(round_steps))]
    dets_round = [detections(gt[s], objects, cam, scene["max_detections"]) for s in round_steps]
    frame_of = (steps % per_round) // every
    stream = Stream(
        odom_t=np.arange(len(gt)) / scene["vio_hz"], odom=vio, gt=gt, sensor_step=steps, frame_of=frame_of,
        dets=[dets_round[i] for i in frame_of], frames=frames, camera=cam,
    )
    return stream


def kitti_drive(scene: dict, seed: int, device) -> Stream:
    """The KITTI-00 drive (``scene.kind == "kitti_drive"``): ``frames``
    frames at ``vio_hz``, ``step`` metres apart along a straight road with
    parked cars; every frame a u16 depth image and the detections of the
    nearest visible cars."""
    n = scene["frames"]
    gt = straight_trajectory(n, step=scene["step"])
    length = float(gt[-1, 0]) + scene["max_depth"] + 10.0
    layout = np.random.default_rng(scene["layout_seed"])
    cars = parked_cars(layout, length, scene["car_spacing"])
    vio = drift_vio(gt, layout, scene["drift_noise"])
    cx = np.array([c.center[0] for c in cars])
    J = scene["render_objects"]
    first = np.clip(np.searchsorted(cx, gt[:, 0] - 6.0) - 1, 0, max(len(cars) - J, 0))
    near = np.minimum(first[:, None] + np.arange(J)[None, :], len(cars) - 1)
    cam = Camera(scene["height"], scene["width"], scene["fx"], scene["fy"], scene["cx"], scene["cy"],
                 scene["max_depth"])
    frames = []
    for f0 in range(0, n, 256):
        d = render_depth(gt[f0:f0 + 256], cars, cam, device, near=near[f0:f0 + 256])
        u16 = depth_to_u16(d, scene["depth_scale"])
        frames.extend(u16[i] for i in range(len(u16)))
    dets = []
    for i in range(n):
        ahead = [cars[j] for j in dict.fromkeys(near[i].tolist())]
        dets.append(detections(gt[i], ahead, cam, scene["max_detections"]))
    stream = Stream(
        odom_t=np.arange(n) / scene["vio_hz"], odom=vio, gt=gt, sensor_step=np.arange(n), frame_of=np.arange(n),
        dets=dets, frames=frames, camera=cam, depth_scale=scene["depth_scale"],
    )
    return placed(stream, seed, 0)


SCENES = {"dense_indoor": indoor_session, "kitti_drive": kitti_drive}


def make_stream(scene: dict, seed: int, device) -> Stream:
    return SCENES[scene["kind"]](scene, seed, device)
