"""Replay logs — the rosbag/pub-sub replacement (the port's own copy of
``semantic_slam_tpu.io.replay``: npz logs, in-process replay and the native
``.slog`` replay through the port's ``native`` reader).

The reference consumes live ROS topics wired by ``launch/*.launch`` (VIO
odometry, depth clouds, detector boxes, GT). Here a session is a time-sorted
event log replayed into the engine, reproducing the reference's pairing
semantics: there is NO time synchronization between streams (the reference's
ApproximateTime synchronizer is commented out, semantic_graph_slam_ros.h:111-127)
— a keyframe grabs whatever cloud/detections arrived last.

Per-source odometry fixups mirror ``semantic_graph_slam_ros.cpp:113-183``:
  * 'rovio'  — used as-is (+ covariance from the message)
  * 'snap'   — NED->ENU Euler trick, identity covariance (:134-151)
  * 'jackal' — yaw rebase + Rz(1.57) + rebase-to-origin (:160-183)
  * 'orb'    — camera->robot Euler-vector rotation (PoseCam2Robot)
The snap path's ros::Time::now() stamping quirk (:136) is reproduced by
stamping with replay wall time (== event time here).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from semantic_slam_tpu_torch.core import np_geometry as npg


@dataclasses.dataclass
class OdomEvent:
    t: float
    pose7: np.ndarray
    cov: np.ndarray | None = None
    source: str = "rovio"


@dataclasses.dataclass
class CloudEvent:
    t: float
    points: np.ndarray  # [H, W, 3] float32, camera frame
    valid: np.ndarray  # [H, W] bool


@dataclasses.dataclass
class DepthEvent:
    """Raw u16 depth frame + pinhole intrinsics — the compact alternative to
    CloudEvent (backprojection happens on-device, frontend/depth.py)."""

    t: float
    depth: np.ndarray  # [H, W] u16
    intrinsics: np.ndarray  # [4] (fx, fy, cx, cy)
    depth_scale: float = 1e-3


@dataclasses.dataclass
class DetectionEvent:
    t: float
    boxes: np.ndarray  # [D, 4] tl_x, tl_y, w, h
    class_ids: np.ndarray  # [D]
    probs: np.ndarray  # [D]


@dataclasses.dataclass
class GtEvent:
    t: float
    pose7: np.ndarray


@dataclasses.dataclass
class ReplayLog:
    odom: list[OdomEvent] = dataclasses.field(default_factory=list)
    clouds: list[CloudEvent] = dataclasses.field(default_factory=list)
    depths: list[DepthEvent] = dataclasses.field(default_factory=list)
    detections: list[DetectionEvent] = dataclasses.field(default_factory=list)
    gt: list[GtEvent] = dataclasses.field(default_factory=list)

    def events(self) -> Iterator[object]:
        """Merged, time-ordered stream. Within a timestamp, clouds and
        detections are delivered before odometry (so a keyframe triggered by
        an odom message sees same-tick sensor data, like callback ordering
        inside one spinOnce)."""
        tagged = (
            [(e.t, 0, e) for e in self.clouds]
            + [(e.t, 0, e) for e in self.depths]
            + [(e.t, 1, e) for e in self.detections]
            + [(e.t, 2, e) for e in self.odom]
            + [(e.t, 3, e) for e in self.gt]
        )
        tagged.sort(key=lambda x: (x[0], x[1]))
        for _, _, e in tagged:
            yield e


def apply_odom_fixup(ev: OdomEvent, ctx: dict) -> tuple[np.ndarray, np.ndarray]:
    """Per-source frame fixup; returns (pose7, cov6x6). Pure numpy — this
    runs per message on the host ingestion path."""
    p = np.asarray(ev.pose7, np.float64)
    if ev.source == "rovio":
        out = p
        cov = ev.cov if ev.cov is not None else np.eye(6)
    elif ev.source == "snap":
        out = npg.pose_ned_to_enu(p)
        cov = np.eye(6)  # snap path fabricates identity (:138-139)
    elif ev.source == "jackal":
        if "first_yaw" not in ctx:
            ctx["first_yaw"] = float(npg.quat_to_rpy(p[3:])[2])
        rotated = npg.rot_pose_z(p, ctx["first_yaw"])
        if "origin_t" not in ctx:
            ctx["origin_t"] = rotated[:3].copy()
        out = rotated.copy()
        out[:3] -= ctx["origin_t"]
        cov = np.eye(6)
    elif ev.source == "orb":
        out = npg.pose_cam_to_robot_odom(p)
        cov = np.eye(6)
    else:
        raise ValueError(f"unknown odom source {ev.source!r}")
    return out, cov


def replay(log: ReplayLog, engine, tick_hz: float = 30.0, run_ticks: bool = True) -> None:
    """Feed a log into the engine, calling ``engine.run()`` on a simulated
    30 Hz tick grid (semantic_graph_SLAM_node.cpp:11-20)."""
    ctx: dict = {}
    next_tick: float | None = None
    for ev in log.events():
        if next_tick is None:
            next_tick = ev.t
        while run_ticks and ev.t >= next_tick:
            engine.run()
            next_tick += 1.0 / tick_hz
        if isinstance(ev, CloudEvent):
            # host numpy straight through — the engine transfers a cloud to
            # the device only if a detection keyframe actually consumes it
            engine.set_point_cloud(ev.points, ev.valid)
        elif isinstance(ev, DepthEvent):
            engine.set_depth_image(ev.depth, ev.intrinsics, ev.depth_scale)
        elif isinstance(ev, DetectionEvent):
            engine.set_detections(ev.boxes, ev.class_ids, ev.probs)
        elif isinstance(ev, OdomEvent):
            pose, cov = apply_odom_fixup(ev, ctx)
            engine.vio_callback(ev.t, pose, cov)
        # GtEvent: evaluation-only side channel (never enters optimization,
        # matching SURVEY.md §3.5)
    engine.run()


def replay_slog(path: str, engine, tick_hz: float = 30.0) -> None:
    """Replay a native SLOG binary log (mmap, zero-copy cloud views) through
    the engine — same tick semantics as ``replay``. The reader closes when
    the replay ends; the engine copies a cloud when a keyframe takes it, so
    no keyframe keeps a view into the unmapped file."""
    from semantic_slam_tpu_torch import native

    ctx: dict = {}
    next_tick: float | None = None
    with native.SlogReader(path) as r:
        for kind, idx in r.events():
            if kind == 0:
                t, xyz, valid = r.cloud(idx)
            elif kind == 1:
                t, boxes, cids, probs = r.detections(idx)
            elif kind == 2:
                t, source, pose, cov = r.odom(idx)
            else:
                continue  # gt: evaluation side channel
            if next_tick is None:
                next_tick = t
            while t >= next_tick:
                engine.run()
                next_tick += 1.0 / tick_hz
            if kind == 0:
                engine.set_point_cloud(xyz, valid)
            elif kind == 1:
                engine.set_detections(boxes, cids, probs)
            else:
                fixed, cov6 = apply_odom_fixup(OdomEvent(t, pose, cov, source), ctx)
                engine.vio_callback(t, fixed, cov6)
        engine.run()


def slog_gt(path: str):
    """Ground-truth track from a SLOG file: (stamps [N], poses7 [N,7])."""
    from semantic_slam_tpu_torch import native

    with native.SlogReader(path) as r:
        ts, ps = [], []
        for i in range(r.n_gt):
            t, p = r.gt(i)
            ts.append(t)
            ps.append(p)
        return np.asarray(ts), np.asarray(ps).reshape(-1, 7)


def save_log(path: str, log: ReplayLog) -> None:
    # detection events carry VARIABLE box counts; pad to the per-log max and
    # store the true count per event (a ragged np.array() is an error)
    max_det = max((len(e.boxes) for e in log.detections), default=0)
    nd = len(log.detections)
    det_boxes = np.zeros((nd, max_det, 4), np.float64)
    det_cids = np.full((nd, max_det), -1, np.int32)
    det_probs = np.zeros((nd, max_det), np.float64)
    det_n = np.zeros((nd,), np.int32)
    for i, e in enumerate(log.detections):
        n = len(e.boxes)
        det_n[i] = n
        det_boxes[i, :n] = e.boxes
        det_cids[i, :n] = e.class_ids
        det_probs[i, :n] = e.probs
    np.savez_compressed(
        path,
        odom_t=np.array([e.t for e in log.odom]),
        odom_pose=np.array([e.pose7 for e in log.odom]).reshape(-1, 7),
        odom_source=np.array([e.source for e in log.odom]),
        cloud_t=np.array([e.t for e in log.clouds]),
        cloud_points=np.array([e.points for e in log.clouds], np.float32),
        cloud_valid=np.array([e.valid for e in log.clouds]),
        depth_t=np.array([e.t for e in log.depths]),
        depth_img=np.array([e.depth for e in log.depths], np.uint16),
        depth_intr=np.array([e.intrinsics for e in log.depths], np.float64).reshape(-1, 4),
        depth_scale=np.array([e.depth_scale for e in log.depths], np.float64),
        det_t=np.array([e.t for e in log.detections]),
        det_boxes=det_boxes,
        det_cids=det_cids,
        det_probs=det_probs,
        det_n=det_n,
        gt_t=np.array([e.t for e in log.gt]),
        gt_pose=np.array([e.pose7 for e in log.gt]).reshape(-1, 7),
    )


def load_log(path: str) -> ReplayLog:
    z = np.load(path, allow_pickle=False)
    log = ReplayLog()
    for t, p, s in zip(z["odom_t"], z["odom_pose"], z["odom_source"]):
        log.odom.append(OdomEvent(float(t), p, None, str(s)))
    for t, pts, v in zip(z["cloud_t"], z["cloud_points"], z["cloud_valid"]):
        log.clouds.append(CloudEvent(float(t), pts, v))
    if "depth_t" in z.files:
        for t, d, intr, s in zip(
            z["depth_t"], z["depth_img"], z["depth_intr"], z["depth_scale"]
        ):
            log.depths.append(DepthEvent(float(t), d, intr, float(s)))
    det_n = z["det_n"] if "det_n" in z.files else None
    for i, (t, b, c, pr) in enumerate(
        zip(z["det_t"], z["det_boxes"], z["det_cids"], z["det_probs"])
    ):
        n = int(det_n[i]) if det_n is not None else len(b)
        log.detections.append(DetectionEvent(float(t), b[:n], c[:n], pr[:n]))
    for t, p in zip(z["gt_t"], z["gt_pose"]):
        log.gt.append(GtEvent(float(t), p))
    return log
