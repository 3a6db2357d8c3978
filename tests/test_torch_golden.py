"""The port against the reference's own oracles, on the CPU, at the JAX
package's tolerances:

* ``tests/golden/ref_oracle_frontend.json`` (the C++ frontend harness over
  the unmodified reference frontend): the cases of
  ``tests/test_ref_oracle_frontend.py`` that reach a ported function --
  the bbox sampler's region, the h/v classification and sign
  canonicalization, the camera-frame horizontal normal, the world-pose
  recipe and the detection packing (2e-5; the sampler's mean 2e-2);
* ``tests/golden/ref_oracle.json``'s 60-frame sessions (the reference's
  gate, pose bookkeeping and association composed, as
  ``tests/test_ref_oracle_session.py`` replays them): the port's
  ``KeyframeGate``, ``np_geometry`` and ``assoc.associate`` (2e-5 and
  1e-4);
* the lab golden (``tests/golden/regen.py``'s session): the port's engine
  in f64 gives ``lab_robot_pose.txt`` and ``lab_landmarks.npz`` within 1e-9
  (``tests/test_golden_replay.py``).

Nothing here runs the JAX package: the goldens are the reference's.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_slam_tpu_torch.assoc import association as assoc
from semantic_slam_tpu_torch.config import CLASS_TO_ID
from semantic_slam_tpu_torch.core import frames
from semantic_slam_tpu_torch.core import np_geometry as npg
from semantic_slam_tpu_torch.frontend import planes as planes_mod
from semantic_slam_tpu_torch.frontend import segmentation as seg_mod
from semantic_slam_tpu_torch.frontend.segmentation import DetectedObjects
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.io import tum
from semantic_slam_tpu_torch.runtime.engine import SlamEngine
from semantic_slam_tpu_torch.runtime.keyframe_gate import KeyframeGate
from test_e2e import e2e_config
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

GOLDEN = Path(__file__).parent / "golden"
FRONT = json.loads((GOLDEN / "ref_oracle_frontend.json").read_text())
SESSION = json.loads((GOLDEN / "ref_oracle.json").read_text())
PLANE_TO_ID = {"horizontal": 0, "vertical": 1}
ATOL32 = 2e-5


def t64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


# ---------------------------------------------------------------------------
# the C++ frontend harness
# ---------------------------------------------------------------------------


def _cloud_xyz(H=480, W=640):
    """The oracle's organized cloud (oracle_frontend.cpp cloud_x/y/z)."""
    u = np.arange(W)[None, :]
    v = np.arange(H)[:, None]
    x = 0.01 * u - 3.2 + 0.001 * v
    y = 0.002 * v - 0.48 + 0 * u
    z = 2.0 + 0.0005 * (u + v)
    return np.stack([np.broadcast_to(x, (H, W)), np.broadcast_to(y, (H, W)), np.broadcast_to(z, (H, W))], axis=-1)


def test_sampler_covers_crop_region():
    """The strided bbox sampler samples the reference crop's region: on the
    oracle's cloud (linear in u, v) its mean approximates the crop mean."""
    c = {x["name"]: x for x in FRONT["crop"]}["normal"]
    pts = torch.as_tensor(_cloud_xyz(), dtype=torch.float32)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    box = torch.tensor([[c["tl_x"], c["tl_y"], c["w"], c["h"]]], dtype=torch.float32)
    spts, _, ok = seg_mod._bbox_sample(pts[None], valid[None], torch.zeros_like(pts)[None], valid[None], box[None],
                                       32, 32)
    ours = spts[0][ok[0]].double().mean(dim=0).numpy()
    ref_mean = np.array([c["sum_x"], c["sum_y"], c["sum_z"]]) / c["points"]
    np.testing.assert_allclose(ours, ref_mean, atol=2e-2)


@pytest.mark.parametrize("name", ["mixed", "flat"])
def test_hv_classification(name):
    """``classify_and_canonicalize`` gives the reference's
    multiPlaneSegmentation rows, region by region."""
    case = next(c for c in FRONT["hv"] if c["name"] == name)
    h = t64(case["h_cam"][:3])
    emitted = [r["row8"] for r in case["rows"]]
    k = 0
    for reg in case["regions"]:
        if reg["contour"] <= 100 or reg["area"] < case["planar_area"]:
            continue  # gate-dropped before classification output
        coeffs, hv, ok = planes_mod.classify_and_canonicalize(t64([reg["coeffs"][:3]]), t64([reg["coeffs"][3]]), h)
        if not bool(ok[0]):
            continue  # neither horizontal nor vertical: the reference emits nothing
        row = emitted[k]
        k += 1
        np.testing.assert_allclose(reg["centroid"], row[:3], atol=ATOL32)
        np.testing.assert_allclose(coeffs[0].numpy(), row[3:7], atol=ATOL32)
        assert int(hv[0]) == int(round(row[7]))
    assert k == len(emitted), "emission pattern diverges from the reference"


def test_h_cam_vector():
    for case in FRONT["hv"]:
        hc = frames.horizontal_plane_normal_in_cam(t64(case["robot_pose"]), t64(case["cam_angle"]), strict=True)
        np.testing.assert_allclose(hc.numpy()[:3], case["h_cam"][:3], atol=ATOL32)


def test_world_pose_recipe():
    """world = T_cam_world (rotation only) @ [cam, 1] + robot translation
    (point_cloud_segmentation.h:55-94)."""
    g = FRONT["segment_all"][0]
    T = frames.t_cam_world(t64(g["robot_pose"]), t64(g["cam_angle"]), strict=True).numpy()
    for d in g["detections"]:
        world = (T @ np.asarray(d["pose_cam"] + [1.0]))[:3] + np.asarray(g["robot_pose"][:3])
        np.testing.assert_allclose(world, d["world_pose"], atol=ATOL32)
        got = frames.convert_pose_to_world(t64(g["robot_pose"]), t64(g["cam_angle"]), t64(d["pose_cam"]))
        np.testing.assert_allclose(got.numpy(), d["world_pose"], atol=ATOL32)


def test_packing_fields():
    """num_points = contour size; the normal is the canonicalized camera-frame
    plane; the plane type follows the flag."""
    g = FRONT["segment_all"][0]
    h = frames.horizontal_plane_normal_in_cam(t64(g["robot_pose"]), t64(g["cam_angle"]), strict=True)[:3]
    for d, reg in zip(g["detections"][:2], g["regions"]):
        assert d["num_points"] == reg["contour"]
        coeffs, hv, ok = planes_mod.classify_and_canonicalize(t64([reg["coeffs"][:3]]), t64([reg["coeffs"][3]]), h)
        assert bool(ok[0])
        np.testing.assert_allclose(coeffs[0].numpy(), d["normal_orientation"], atol=ATOL32)
        assert PLANE_TO_ID[d["plane_type"]] == int(hv[0])


# ---------------------------------------------------------------------------
# the reference's 60-frame session
# ---------------------------------------------------------------------------


def _pose7(pos, quat_xyzw):
    x, y, z, w = quat_xyzw
    return np.concatenate([np.asarray(pos, np.float64), [w, x, y, z]])


def _dets(frame):
    ds = frame["detections"]
    M = len(ds)
    f32 = torch.float32
    return DetectedObjects(
        valid=torch.ones((M,), dtype=torch.bool),
        class_id=torch.tensor([CLASS_TO_ID[d["type"]] for d in ds], dtype=torch.int32),
        prob=torch.tensor([d["prob"] for d in ds], dtype=f32),
        plane_type=torch.tensor([PLANE_TO_ID[d["plane_type"]] for d in ds], dtype=torch.int32),
        num_points=torch.tensor([d["num_points"] for d in ds], dtype=f32),
        pose_cam=torch.tensor([d["pose_cam"] for d in ds], dtype=f32),
        normal_cam=torch.tensor([d["normal_cam"] for d in ds], dtype=f32),
        world_pose=torch.zeros((M, 3), dtype=f32),
    )


@pytest.mark.parametrize("name", ["session_eq", "session_maha"])
def test_session_composition_matches_reference(name):
    """Gate verdicts, accum_distance, the robot-pose snapshots handed to
    association, per-detection match/new outcomes, landmark ids and poses,
    edge counts and the final table, frame by frame (optimization stubbed:
    the estimate of the last keyframe is its odometry, as in the oracle)."""
    scen = next(s for s in SESSION["session"] if s["name"] == name)
    cam_angle = torch.tensor(scen["cam_angle"], dtype=torch.float32)
    gate = KeyframeGate(delta_trans=0.5, delta_angle=0.5, delta_time=1.0)
    table = assoc.make_table(64)
    robot_pose = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)
    prev_odom = robot_pose.copy()
    first_key_added = False
    n_keyframes = n_edges = 0

    for fi, frame in enumerate(scen["frames"]):
        odom7 = _pose7(frame["odom_pos"], frame["odom_quat_xyzw"])
        gate_hit = gate.update(odom7, frame["t_sec"] + frame["t_nsec"] * 1e-9)
        is_kf = gate_hit or frame["det_available"]
        assert is_kf == frame["is_keyframe"], f"{name} frame {fi}: gate diverges"
        if not is_kf:
            if first_key_added:
                robot_pose = npg.pose_mul(robot_pose, npg.pose_mul(npg.pose_inv(prev_odom), odom7))
            prev_odom = odom7
            continue
        np.testing.assert_allclose(gate.accum_distance, frame["accum_distance"], atol=1e-5, err_msg=f"frame {fi}")
        prev_odom = odom7
        first_key_added = True
        rp6 = npg.pose_to_xyzrpy(robot_pose.copy())
        np.testing.assert_allclose(rp6, frame["robot_pose6"], atol=ATOL32, err_msg=f"{name} frame {fi}: snapshot")
        n_keyframes += 1
        if n_keyframes >= 2:
            n_edges += 1
        if frame["det_available"]:
            table, res = assoc.associate(
                table, _dets(frame), torch.tensor(rp6, dtype=torch.float32), cam_angle,
                use_maha=bool(scen["use_maha"]), maha_thres=float(np.float32(scen["maha_thres"])),
                eq_thres=float(np.float32(scen["eq_thres"])), land_noise=0.5, strict_frames=True,
                rtabmap_y_offset=False,
            )
            assert len(frame["results"]) == res.is_new.shape[0]
            for di, r in enumerate(frame["results"]):
                assert bool(res.is_new[di]) == r["is_new"], f"{name} frame {fi} det {di}: new/match diverges"
                assert int(res.lm_id[di]) == r["id"], f"{name} frame {fi} det {di}: landmark id diverges"
                np.testing.assert_allclose(res.world_pose[di].numpy(), r["pose_world"], atol=1e-4)
                np.testing.assert_allclose(res.local_pose[di].numpy(), r["local_pose"], atol=1e-4)
                n_edges += 1
        assert n_edges == frame["n_edges"], f"{name} frame {fi}: edge count"
        if frame["optimized"]:
            robot_pose = odom7.copy()  # the stub optimizer's estimate of the last keyframe
        assert (n_edges >= 10) == frame["optimized"]

    final = scen["final_table"]
    assert int(table.count) == len(final), f"{name}: final table size"
    for li, lm in enumerate(final):
        np.testing.assert_allclose(table.world[li].numpy(), lm["pose_world"], atol=1e-4, err_msg=f"landmark {li}")


# ---------------------------------------------------------------------------
# the lab golden
# ---------------------------------------------------------------------------


def test_lab_golden_replay():
    """``tests/golden/regen.py``'s session (seed 3, 360 steps, two loops)
    through the port's engine in f64 on the CPU."""
    log = tsynth.make_synthetic_log(seed=3, n_steps=360, sensor_every=5, drift_noise=0.008, loops=2.0)
    eng = SlamEngine(e2e_config(), device="cpu")
    treplay.replay(log, eng)
    t_g, p_g = tum.read_tum(os.path.join(GOLDEN, "lab_robot_pose.txt"))
    kf_t = np.array([k.stamp for k in eng.keyframes])
    assert len(kf_t) == len(t_g)
    np.testing.assert_allclose(kf_t, t_g, atol=1e-9)
    np.testing.assert_allclose(eng.get_keyframe_poses(), p_g, rtol=0, atol=1e-9)
    z = np.load(os.path.join(GOLDEN, "lab_landmarks.npz"))
    lms = eng.get_mapped_landmarks()
    assert len(lms["pose"]) == len(z["pose"]) > 0
    np.testing.assert_allclose(lms["pose"], z["pose"], atol=1e-9)
    np.testing.assert_array_equal(lms["class_id"], z["class_id"])
    np.testing.assert_array_equal(lms["plane_type"], z["plane_type"])
