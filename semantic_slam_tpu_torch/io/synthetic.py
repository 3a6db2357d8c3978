"""Synthetic session generator — the stand-in for the reference's demo bags
(the port's own copy of ``semantic_slam_tpu.io.synthetic``).

The reference validates end-to-end by replaying recorded bags
(``entire_lab_3_rounds.bag`` etc., README.md:54-68) with external VIO and a
detector. Those bags are not redistributable, so integration tests and
benchmarks use a simulated lab: planar semantic objects (tables, monitors,
buckets...) in a world, a drifting VIO odometry stream, organized RGB-D
cloud renders, and projected detector bounding boxes. Geometry uses the same
camera frame chain as the pipeline so ground truth is exactly consistent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from semantic_slam_tpu_torch.core import np_geometry as npg
from semantic_slam_tpu_torch.io.replay import (
    CloudEvent,
    DepthEvent,
    DetectionEvent,
    GtEvent,
    OdomEvent,
    ReplayLog,
)


@dataclasses.dataclass
class PlanarObject:
    class_id: int
    center: np.ndarray  # world [3]
    normal: np.ndarray  # world unit [3]
    half_u: float  # half-extent along in-plane u axis [m]
    half_v: float

    def basis(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.normal / np.linalg.norm(self.normal)
        ref = np.array([0.0, 0, 1]) if abs(n[2]) < 0.9 else np.array([1.0, 0, 0])
        u = np.cross(n, ref)
        u /= np.linalg.norm(u)
        v = np.cross(n, u)
        return u, v


def default_lab_scene() -> list[PlanarObject]:
    """A small lab: two vertical 'tvmonitor' boards, a horizontal 'chair'
    seat, a vertical 'bucket' face — enough for loop closures on a loop
    trajectory around the room."""
    return [
        PlanarObject(1, np.array([4.0, 0.0, 0.8]), np.array([-1.0, 0, 0]), 0.5, 0.4),
        PlanarObject(1, np.array([0.0, 3.0, 1.0]), np.array([0.0, -1, 0]), 0.5, 0.4),
        PlanarObject(0, np.array([2.0, 2.5, 0.45]), np.array([0.0, 0, 1]), 0.45, 0.45),
        PlanarObject(5, np.array([-1.5, 1.0, 0.4]), np.array([1.0, 0, 0]), 0.35, 0.5),
    ]


def kitti_scene(n_cars: int = 12, spacing: float = 8.0, seed: int = 0) -> list[PlanarObject]:
    """Outdoor corridor of 'car' side-planes along a road (BASELINE config
    #3: KITTI sequence with the yolo_detector_kitti profile — car landmarks,
    larger outdoor graph). Cars parked alternating left/right of the +x road,
    side panels facing it."""
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n_cars):
        side = -1.0 if i % 2 == 0 else 1.0
        x = 6.0 + i * spacing + rng.uniform(-1.5, 1.5)
        y = side * rng.uniform(3.0, 4.5)
        objs.append(
            PlanarObject(
                6,  # 'car'
                np.array([x, y, 0.7]),
                np.array([0.0, -side, 0.0]),  # panel faces the road
                1.8,
                0.6,
            )
        )
    return objs


def dense_indoor_scene(seed: int = 0) -> list[PlanarObject]:
    """All 7 semantic classes in one room (BASELINE config #4: dense
    multi-object indoor scene, high keyframe rate, on-device voxelization)."""
    rng = np.random.default_rng(seed)
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


def corridor_scene(length: float = 10.0, seed: int = 0) -> list[PlanarObject]:
    """Hallway with chair/tvmonitor/keyboard planes on the walls/furniture
    (BASELINE config #2: the ROVIO + YOLO corridor sequence's class mix:
    chair, tvmonitor, keyboard landmarks; ``config/yolo_detector.yaml``)."""
    rng = np.random.default_rng(seed)
    specs = [
        (1, [2.5, -1.4, 1.1], [0, 1, 0], 0.45, 0.35),   # tvmonitor right wall
        (0, [4.0, 1.2, 0.45], [0, 0, 1], 0.45, 0.45),   # chair seat left
        (3, [6.0, -1.0, 0.75], [0, 0, 1], 0.35, 0.15),  # keyboard on desk
        (1, [8.0, 1.4, 1.0], [0, -1, 0], 0.45, 0.35),   # tvmonitor left wall
        (0, [9.5, -1.2, 0.45], [0, 0, 1], 0.45, 0.45),  # chair seat right
    ]
    out = []
    for cid, c, n, hu, hv in specs:
        jitter = rng.uniform(-0.08, 0.08, size=3)
        out.append(
            PlanarObject(cid, np.asarray(c, float) + jitter, np.asarray(n, float), hu, hv)
        )
    return out


def out_and_back_trajectory(n: int, length: float = 9.0, z: float = 0.0):
    """Walk +x down a corridor, U-turn, walk back — re-observes every
    landmark from the opposite heading (the corridor sequence's loop-closure
    regime). Flat (roll = pitch = 0) so strict/clean frame chains agree."""
    half = max(n // 2, 2)
    out = []
    for i in range(n):
        if i < half:
            s = i / (half - 1)
            x, yaw = s * length, 0.0
        else:
            s = (i - half) / max(n - half - 1, 1)
            x, yaw = length * (1.0 - s), np.pi
        q = npg.rpy_to_quat(np.array([0.0, 0.0, yaw]))
        out.append(np.concatenate([[x, 0.0, z], q]))
    return np.stack(out)


def straight_trajectory(n: int, step: float = 0.4, z: float = 0.0, wiggle: float = 0.02):
    """Forward-driving trajectory along +x with mild yaw wiggle (outdoor)."""
    out = []
    yaw = 0.0
    x, y = 0.0, 0.0
    for i in range(n):
        yaw = wiggle * np.sin(i / 25.0)
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
        q = npg.rpy_to_quat(np.array([0.0, 0.0, yaw]))
        out.append(np.concatenate([[x, y, z], q]))
    return np.stack(out)


def circle_trajectory(n: int, radius: float = 1.2, center=(1.2, 1.2), z: float = 0.0):
    """Yaw-following circular loop (flat: roll = pitch = 0, so the strict
    frame-chain typo is inert and GT is exact)."""
    out = []
    for i in range(n):
        th = 2 * np.pi * i / n
        x = center[0] + radius * np.cos(th)
        y = center[1] + radius * np.sin(th)
        yaw = th + np.pi / 2
        q = npg.rpy_to_quat(np.array([0.0, 0.0, yaw]))
        out.append(np.concatenate([[x, y, z], q]))
    return np.stack(out)


def render_cloud(
    robot_pose7: np.ndarray,
    objects: list[PlanarObject],
    cam_pitch: float,
    H: int = 240,
    W: int = 320,
    fx: float = 300.0,
    max_depth: float = 8.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Ray-cast the planar objects into an organized cam-frame cloud."""
    xyzrpy = npg.pose_to_xyzrpy(robot_pose7)
    T = npg.t_cam_world(xyzrpy, cam_pitch)
    R_cw = T[:3, :3]  # cam -> world rotation
    t_w = robot_pose7[:3]

    cx, cy = W / 2, H / 2
    u = np.arange(W)[None, :].repeat(H, 0)
    v = np.arange(H)[:, None].repeat(W, 1)
    dirs_c = np.stack([(u - cx) / fx, (v - cy) / fx, np.ones_like(u, float)], axis=-1)
    dirs_w = dirs_c @ R_cw.T  # [H, W, 3]

    depth = np.full((H, W), np.inf)
    for obj in objects:
        n = obj.normal / np.linalg.norm(obj.normal)
        denom = dirs_w @ n
        num = (obj.center - t_w) @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            s = num / denom  # distance along ray (world units per unit dir)
        hit = dirs_w * s[..., None] + t_w  # world hit point
        ub, vb = obj.basis()
        du = (hit - obj.center) @ ub
        dv = (hit - obj.center) @ vb
        ok = (s > 0.1) & (np.abs(du) <= obj.half_u) & (np.abs(dv) <= obj.half_v)
        zc = s * dirs_c[..., 2]  # camera z
        better = ok & (zc < depth) & (zc > 0.1) & (zc < max_depth)
        depth = np.where(better, zc, depth)

    valid = np.isfinite(depth)
    z = np.where(valid, depth, 0.0)
    pts = dirs_c * z[..., None]
    return pts.astype(np.float32), valid


def project_bbox(
    robot_pose7: np.ndarray,
    obj: PlanarObject,
    cam_pitch: float,
    H: int = 240,
    W: int = 320,
    fx: float = 300.0,
) -> np.ndarray | None:
    """Project the object's rectangle corners -> image bbox (the fake detector)."""
    xyzrpy = npg.pose_to_xyzrpy(robot_pose7)
    T = npg.t_cam_world(xyzrpy, cam_pitch)
    R_wc = T[:3, :3].T
    t_w = robot_pose7[:3]
    ub, vb = obj.basis()
    corners = [
        obj.center + su * obj.half_u * ub + sv * obj.half_v * vb
        for su in (-1, 1)
        for sv in (-1, 1)
    ]
    uv = []
    cx, cy = W / 2, H / 2
    for c in corners:
        pc = R_wc @ (c - t_w)
        if pc[2] < 0.15:
            return None
        uv.append([cx + fx * pc[0] / pc[2], cy + fx * pc[1] / pc[2]])
    uv = np.array(uv)
    x0, y0 = uv.min(axis=0)
    x1, y1 = uv.max(axis=0)
    x0, y0 = max(0.0, x0), max(0.0, y0)
    x1, y1 = min(float(W), x1), min(float(H), y1)
    min_px = max(6.0, 12.0 * W / 320.0)
    if x1 - x0 < min_px or y1 - y0 < min_px:
        return None
    return np.array([x0, y0, x1 - x0, y1 - y0])


def make_synthetic_log(
    seed: int = 0,
    n_steps: int = 240,
    vio_hz: float = 30.0,
    sensor_every: int = 3,
    drift_noise: float = 0.004,
    cam_pitch: float = 0.0,
    H: int = 240,
    W: int = 320,
    objects: list[PlanarObject] | None = None,
    loops: float = 1.0,
    scene: str = "lab",
) -> ReplayLog:
    """Simulated session: circular loop(s) with drifting VIO.

    drift_noise is the per-step translational random-walk magnitude injected
    into the integrated odometry (the VIO drift the optimizer must correct).
    Rotational drift is 10x smaller: the reference's constant information
    matrix (1/const_stddev_q ~ 1e5 vs 1/const_stddev_x ~ 150) encodes a
    gravity-aligned VIO whose orientation is far more trustworthy than its
    position, and the simulated sensor must match that model.
    """
    rng = np.random.default_rng(seed)
    if objects is None:
        objects = {
            "lab": default_lab_scene,
            "kitti": kitti_scene,
            "dense_indoor": dense_indoor_scene,
            "corridor": corridor_scene,
        }[scene]()
    fx = 300.0 * W / 320.0  # keep the FOV constant across render sizes
    if scene == "kitti":
        # forward drive through the car corridor; no loop closure, larger
        # graph (the yolo_detector_kitti profile's regime)
        gt = straight_trajectory(n_steps, step=0.12)
    elif scene == "corridor":
        gt = out_and_back_trajectory(n_steps)
    else:
        per_loop = max(int(n_steps / max(loops, 1e-9)), 8)
        one = circle_trajectory(per_loop)
        reps = int(np.ceil(n_steps / per_loop))
        gt = np.concatenate([one] * max(reps, 1))[:n_steps]

    log = ReplayLog()
    vio = gt[0].copy()
    dt = 1.0 / vio_hz
    for i in range(n_steps):
        t = i * dt
        if i > 0:
            rel = npg.pose_mul(npg.pose_inv(gt[i - 1]), gt[i])
            noise = rng.normal(size=6) * drift_noise
            noise[3:] *= 0.1
            rel_noisy = npg.pose_retract(rel, noise)
            vio = npg.pose_mul(vio, rel_noisy)
        if i % sensor_every == 0:
            pts, valid = render_cloud(gt[i], objects, cam_pitch, H=H, W=W, fx=fx)
            log.clouds.append(CloudEvent(t - 1e-4, pts, valid))
            boxes, cids, probs = [], [], []
            for obj in objects:
                bb = project_bbox(gt[i], obj, cam_pitch, H=H, W=W, fx=fx)
                if bb is not None:
                    boxes.append(bb)
                    cids.append(obj.class_id)
                    probs.append(0.9)
            if boxes:
                log.detections.append(
                    DetectionEvent(
                        t - 5e-5,
                        np.stack(boxes),
                        np.array(cids, np.int32),
                        np.array(probs),
                    )
                )
        log.odom.append(OdomEvent(t, vio.copy(), None, "rovio"))
        log.gt.append(GtEvent(t, gt[i].copy()))
    return log


def clouds_to_depth(log, depth_scale: float = 1e-3):
    """Convert a synthetic log's CloudEvents to u16 DepthEvents in place.

    Valid because render_cloud's organized clouds are pinhole-consistent
    (points = z * ((u-cx)/fx, (v-cy)/fx, 1)); real sensors provide the depth
    frame directly. Round-trips through frontend/depth.backproject_depth to
    ~1 mm.
    """
    if not log.clouds:
        return log
    H, W = log.clouds[0].points.shape[:2]
    fx = 300.0 * W / 320.0  # make_synthetic_log's FOV-constant intrinsics
    intr = np.array([fx, fx, W / 2, H / 2], np.float64)
    for e in log.clouds:
        z = e.points[..., 2]
        ok = e.valid & (z > 0)
        d = np.where(ok, np.clip(np.round(z / depth_scale), 1, 65535), 0)
        log.depths.append(DepthEvent(e.t, d.astype(np.uint16), intr, depth_scale))
    log.clouds = []
    return log
