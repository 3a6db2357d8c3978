"""Export a finished session's output surface as a playable rosbag (the
port's own copy of ``semantic_slam_tpu.viz.rviz_bag``).

The reference node *publishes* its results live — optimized Path/PoseArray,
per-class landmark MarkerArray with h/v-dependent cuboid scales, the
corrected robot pose, the corresponding VIO path, and the map->odom TF
(``semantic_graph_slam_ros.cpp:94-110,227-452,531-550``) — and users watch
them in rviz (``rviz/*.rviz`` profiles). This module reproduces that surface
offline: ``write_viz_bag`` serializes the same topics (same md5-checked
message types) into a rosbag 2.0 file, so ``rosbag play out/viz.bag`` +
stock rviz shows this framework's results exactly as the reference's.

Timeline: per-keyframe streams (/robot_pose, the growing /robot_path and
/keyframe_poses, /corres_vio_path, /tf map->odom) are stamped at keyframe
times, so playback animates the session; the final landmark MarkerArray and
the voxel-map CUBE_LIST are emitted at the last stamp.
"""

from __future__ import annotations

import numpy as np

from semantic_slam_tpu_torch.core import np_geometry as npg
from semantic_slam_tpu_torch.io.rosbag_write import (
    BagWriter,
    epoch_offset,
    pose_msg as _pose_msg,
)
from semantic_slam_tpu_torch.viz.markers import CLASS_COLORS

MAP_FRAME = "map"
ODOM_FRAME = "odom"


def _header(t: float, seq: int, frame: str = MAP_FRAME) -> dict:
    return {"seq": seq, "stamp": t, "frame_id": frame}


def _color(rgb, a: float = 1.0) -> dict:
    return {"r": rgb[0], "g": rgb[1], "b": rgb[2], "a": a}


def _marker(t: float, mid: int, ns: str, mtype: int, pose7, scale, color,
            points=(), colors=(), action: int = 0) -> dict:
    return {
        "header": _header(t, 0),
        "ns": ns,
        "id": mid,
        "type": mtype,
        "action": action,
        "pose": _pose_msg(pose7),
        "scale": {"x": scale[0], "y": scale[1], "z": scale[2]},
        "color": _color(color),
        "lifetime": 0.0,
        "frame_locked": False,
        "points": list(points),
        "colors": list(colors),
        "text": "",
        "mesh_resource": "",
        "mesh_use_embedded_materials": False,
    }


_IDENT7 = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def landmark_markers(t: float, landmarks: dict) -> dict:
    """MarkerArray of mapped landmarks — publishLandmarks semantics
    (semantic_graph_slam_ros.cpp:227-303): CUBE per landmark, per-class
    colors (collisions included, quirk 9), thin slab along the plane normal
    (h: flat in z, v: flat in x)."""
    markers = []
    for i in range(len(landmarks["pose"])):
        cid = int(landmarks["class_id"][i])
        hv = int(landmarks["plane_type"][i])
        pose7 = np.concatenate([
            np.asarray(landmarks["pose"][i], np.float64), [1.0, 0.0, 0.0, 0.0]
        ])
        markers.append(_marker(
            t, i, "mapped_landmarks", 1,  # CUBE
            pose7,
            (0.5, 0.5, 0.05) if hv == 0 else (0.05, 0.5, 0.5),
            CLASS_COLORS.get(cid, (0.5, 0.5, 0.5)),
        ))
    return {"markers": markers}


def detected_markers(t: float, dets: dict) -> dict:
    """Per-frame detected objects — publishDetectedLandmarks semantics
    (semantic_graph_slam_ros.cpp:305-347): plain WHITE cubes at the
    detections' world poses, thin slab by h/v (0.3x0.3x0.01 horizontal,
    0.01x0.3x0.3 vertical)."""
    markers = []
    mid = 0
    for i in range(len(dets["valid"])):
        if not dets["valid"][i]:
            continue
        pose7 = np.concatenate([
            np.asarray(dets["world_pose"][i], np.float64), [1.0, 0.0, 0.0, 0.0]
        ])
        hv = int(dets["plane_type"][i])
        markers.append(_marker(
            t, mid, "my_namespace", 1,  # CUBE, reference ns (:316)
            pose7,
            (0.3, 0.3, 0.01) if hv == 0 else (0.01, 0.3, 0.3),
            (1.0, 1.0, 1.0),
        ))
        mid += 1
    return {"markers": markers}


def voxel_markers(t: float, centers: np.ndarray, resolution: float) -> dict:
    """Occupancy voxel map as ONE CUBE_LIST marker (the rviz-friendly
    replacement for the external octomap_server's output)."""
    pts = [{"x": c[0], "y": c[1], "z": c[2]} for c in np.asarray(centers)]
    m = _marker(
        t, 0, "occupancy", 6,  # CUBE_LIST
        _IDENT7, (resolution, resolution, resolution), (0.6, 0.6, 0.6),
        points=pts,
    )
    m["color"]["a"] = 0.8
    return {"markers": [m]}


def _path_msg(t: float, seq: int, stamps, poses7) -> dict:
    return {
        "header": _header(t, seq),
        "poses": [
            {"header": _header(float(ts), i), "pose": _pose_msg(p)}
            for i, (ts, p) in enumerate(zip(stamps, poses7))
        ],
    }


def _tf_msg(t: float, seq: int, map2odom7) -> dict:
    return {
        "transforms": [{
            "header": _header(t, seq, MAP_FRAME),
            "child_frame_id": ODOM_FRAME,
            "transform": {
                "translation": {"x": map2odom7[0], "y": map2odom7[1],
                                "z": map2odom7[2]},
                "rotation": {"x": map2odom7[4], "y": map2odom7[5],
                             "z": map2odom7[6], "w": map2odom7[3]},
            },
        }]
    }


def write_viz_bag(path: str, engine, grid=None, compression: str = "none",
                  path_stride: int = 1, voxel_centers=None,
                  detections: bool = False) -> dict[str, int]:
    """Serialize a finished ``SlamEngine`` session's outputs as a bag.

    ``path_stride`` thins the progressive Path/PoseArray re-publishes (the
    full path is re-sent per emission like the reference does per tick, so
    long sessions can set a stride > 1); the final full path is always
    written. ``voxel_centers`` short-circuits the occupancy extraction when
    the caller already computed ``occupied_centers(grid)`` (cmd_run does,
    for occupancy.ply). ``detections=True`` completes the reference's
    13-publisher surface with the per-frame ``/detected_landmarks`` stream —
    recomputed post-hoc from stored clouds via ``engine.segment_keyframe``
    (the frontend and one fetch per detection keyframe here, zero cost on
    the live path, preserving the one-fetch-per-tick invariant).
    Returns {topic: message_count}.
    """
    kf_stamps = [float(k.stamp) for k in engine.keyframes]
    kf_poses = np.asarray(engine.get_keyframe_poses(), np.float64)
    vio = [(float(t), np.asarray(p, np.float64)) for t, p in engine.vio_traj]

    # vio_traj can start before the first keyframe (dead-reckoned samples
    # between gate acceptances) — the epoch base must cover the earliest
    # stamp of EITHER stream or negative stamps would break _pack_time
    t_candidates = ([kf_stamps[0]] if kf_stamps else []) + ([vio[0][0]] if vio else [])
    offset = epoch_offset(min(t_candidates) if t_candidates else 0.0)

    counts: dict[str, int] = {}
    with BagWriter(path, compression) as bag:
        def emit(topic: str, t: float, msg_type: str, msg: dict):
            bag.write(topic, t + offset, msg_type, msg)
            counts[topic] = counts.get(topic, 0) + 1

        n = len(kf_stamps)
        for i in range(n):
            t = kf_stamps[i]
            ts = t + offset
            emit("/robot_pose", t, "geometry_msgs/PoseStamped",
                 {"header": _header(ts, i), "pose": _pose_msg(kf_poses[i])})
            if i % max(1, path_stride) == 0 or i == n - 1:
                stamps = [s + offset for s in kf_stamps[: i + 1]]
                emit("/robot_path", t, "nav_msgs/Path",
                     _path_msg(ts, i, stamps, kf_poses[: i + 1]))
                emit("/keyframe_poses", t, "geometry_msgs/PoseArray",
                     {"header": _header(ts, i),
                      "poses": [_pose_msg(p) for p in kf_poses[: i + 1]]})
            # map->odom at keyframe i: correction between the optimized pose
            # and its raw odometry (publishMap2OdomTF semantics, cpp:437-452).
            # kf_poses was bulk-fetched once above — pure-numpy math here, no
            # per-keyframe device fetches
            m2o = (np.asarray(engine.get_map2odom(), np.float64)
                   if i == n - 1 else
                   npg.pose_mul(kf_poses[i], npg.pose_inv(
                       np.asarray(engine.keyframes[i].odom, np.float64))))
            emit("/tf", t, "tf2_msgs/TFMessage", _tf_msg(ts, i, m2o))
            if detections:
                d = engine.segment_keyframe(engine.keyframes[i])
                if d is not None and d["valid"].any():
                    emit("/detected_landmarks", t,
                         "visualization_msgs/MarkerArray",
                         detected_markers(ts, d))

        if vio:
            t_end = vio[-1][0]
            emit("/corres_vio_path", t_end, "nav_msgs/Path",
                 _path_msg(t_end + offset, 0,
                           [t + offset for t, _ in vio], [p for _, p in vio]))

        t_last = kf_stamps[-1] if kf_stamps else (vio[-1][0] if vio else 0.0)
        lms = engine.get_mapped_landmarks()
        if len(lms["pose"]):
            emit("/mapped_landmarks", t_last, "visualization_msgs/MarkerArray",
                 landmark_markers(t_last + offset, lms))
        if grid is not None:
            if voxel_centers is None:
                from semantic_slam_tpu_torch.mapping.voxel import occupied_centers

                voxel_centers = occupied_centers(grid)
            if len(voxel_centers):
                emit("/occupancy", t_last, "visualization_msgs/MarkerArray",
                     voxel_markers(t_last + offset, voxel_centers,
                                   float(grid.resolution)))
    return counts
