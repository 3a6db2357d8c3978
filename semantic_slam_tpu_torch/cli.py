"""Command-line entry of the PyTorch/CUDA port.

  python -m semantic_slam_tpu_torch.cli synth --out lab.npz --steps 240 --height 480 --width 640
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --profile yolo_detector --out results/ --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --solver pcg --max-keyframes 4096 --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --solver pcg --max-keyframes 8192 --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --fixed-lag 64 [--solver pcg] --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --plane-landmarks [--solver pcg] [--fixed-lag 64] --device cuda
  python -m semantic_slam_tpu_torch.cli run --log a.npz --out a/ --checkpoint --save-graph --dump-keyframes
  python -m semantic_slam_tpu_torch.cli run --log b.npz --out b/ --resume a/checkpoint.npz
  python -m semantic_slam_tpu_torch.cli merge a/checkpoint.npz b/checkpoint.npz --out merged/ [--plane-landmarks]
  python -m semantic_slam_tpu_torch.cli synth --out lab.bag   (or lab.slog)
  python -m semantic_slam_tpu_torch.cli baginfo lab.bag
  python -m semantic_slam_tpu_torch.cli run --log lab.bag --voxel --carve --viz-bag-detections --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --ingest-window 8 --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --solver pcg --precond tridiag --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --adaptive-normals --xla-trace trace/ --device cuda
  python -m semantic_slam_tpu_torch.cli run --log lab.npz --devices 2 --device cpu

``run`` replays a log through the port's engine on the 30 Hz tick grid and
writes what ``semantic_slam_tpu.cli run`` writes: ``summary.json``,
``stats.jsonl``, the TUM trajectories (with ``--compute-ate`` or a profile
that asks for them) and the ``export_session`` files. ``--solver pcg`` runs
the SoA Schur-PCG solver: up to 4096 keyframes of capacity its resident loop
(kernels K1-K4 on the card), above it the row-range loop (K6-K10, and K1+K2
for the marginals). ``--fixed-lag N`` marginalizes keyframes beyond the
last N into a prior (on the dense LM and both PCG loops; the pcg resident
loop applies the prior's boundary block inside K4); the trajectory files and
the summary still cover every keyframe. ``--plane-landmarks`` makes each
landmark a planar patch as well (an SE3-plane edge per observation, solved
jointly: the dense plane LM, or with ``--solver pcg`` the row-range loop's
plane half at every capacity, K6-K10 on the card). ``--robust``, ``--optimize-every``
(with the closing ``finalize()`` pass) and ``--plane-gate`` map onto the
config as the JAX CLI maps them. ``--save-graph`` writes
``semantic_graph.g2o``, ``--checkpoint`` ``checkpoint.npz`` (the JAX
package's format: each package loads the other's), ``--dump-keyframes`` the
``keyframes/`` text dumps, and ``--resume PATH`` restores a checkpoint into
the fresh engine before the replay; with plane landmarks the graph and the
checkpoint carry the plane nodes. ``merge`` joins session checkpoints into
one map (landmarks unified by class, plane type and radius; with
``--plane-landmarks`` their planes too) and runs the joint dense LM over it,
writing ``merged_pose.txt``, ``merged_graph.g2o`` and ``summary.json``. ``synth`` writes the JAX
package's logs: ``.npz``, the native ``.slog``, or a rosbag 2.0 ``.bag`` on
the reference node's topics. ``run --log`` reads all three. ``baginfo``
lists a bag's topics, types and counts. ``--voxel`` maps every keyframe's
cloud at its optimized pose into a chunked occupancy map (``--carve`` adds
free-space carving) and writes ``occupancy.ply``; ``--viz-bag`` writes
``viz.bag``, the reference's rviz topics, and ``--viz-bag-detections`` adds
the per-keyframe ``/detected_landmarks`` stream, re-running the frontend on
each detection keyframe's stored cloud. ``--ingest-window W`` pools W
keyframes a tick (offline throughput: each run of detection keyframes takes
one frontend call; ``finalize()`` flushes the last, partial window),
``--precond tridiag`` preconditions both PCG loops with the odometry chain's
block tridiagonal, ``--adaptive-normals`` shrinks the normal windows at
depth edges, and ``--xla-trace DIR`` writes a ``torch.profiler`` trace of
the replay to ``DIR/trace.json``. The profile's
``use_const_inf_matrix=False`` (fitness-weighted odometry information) is a
config field with no flag, as in the JAX CLI. ``--devices N`` runs every
optimize's solve over N ranks (the row-range loop with the pose rows split;
``parallel/dist.py``): NCCL over N GPUs with ``--device cuda`` (fewer
visible GPUs is an error), N gloo CPU ranks with ``--device cpu``; the
summary and the outputs are the single-device run's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np


def make_config(args):
    from semantic_slam_tpu_torch.config import PROFILES, CapacityConfig, MeshConfig

    if args.profile not in PROFILES:
        sys.exit(f"unknown profile {args.profile!r}; have {sorted(PROFILES)}")
    cfg = PROFILES[args.profile]
    if args.devices > 1:
        # every optimize tick's solve over an N-rank mesh (runtime/engine.py):
        # NCCL over cuda:0..N-1 with --device cuda, gloo ranks with --device cpu
        cfg = cfg.replace(mesh=MeshConfig(num_devices=args.devices))
    if args.compute_ate:
        cfg = cfg.replace(compute_txt_for_ate=True)
    if args.max_keyframes:
        cfg = cfg.replace(
            capacity=CapacityConfig(
                max_keyframes=args.max_keyframes,
                max_landmarks=max(args.max_keyframes // 4, 16),
                max_odom_edges=args.max_keyframes,
                max_landmark_edges=args.max_keyframes * 4,
                max_detections_per_frame=cfg.capacity.max_detections_per_frame,
            )
        )
    if args.crop_size:
        cfg = cfg.replace(
            segmentation=dataclasses.replace(
                cfg.segmentation,
                crop_height=args.crop_size,
                crop_width=args.crop_size,
                num_hypotheses=min(cfg.segmentation.num_hypotheses, args.crop_size),
            )
        )
    if args.solver:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, linear_solver=args.solver))
    if args.precond != "jacobi":
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, pcg_precond=args.precond))
    if args.adaptive_normals:
        cfg = cfg.replace(segmentation=dataclasses.replace(cfg.segmentation, adaptive_normals=True))
    if args.plane_landmarks:
        cfg = cfg.replace(use_plane_landmarks=True)
    if args.plane_gate:
        cfg = cfg.replace(association=dataclasses.replace(cfg.association, use_plane_gate=True))
    solver_kw = {}
    if args.robust != "none":
        solver_kw["robust_kernel"] = args.robust
    if args.optimize_every > 1:
        solver_kw["optimize_every_n_ticks"] = args.optimize_every
    if args.ingest_window > 1:
        solver_kw["ingest_window"] = args.ingest_window
    if args.fixed_lag > 0:
        solver_kw["fixed_lag_window"] = args.fixed_lag
    if solver_kw:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **solver_kw))
    return cfg


class SlogLog:
    """A ``.slog`` log as ``run`` takes it: replayed from its file
    (``io.replay.replay_slog``), with its ground truth in memory."""

    def __init__(self, path: str):
        from semantic_slam_tpu_torch.io import replay as replay_mod

        self.path = path
        gt_t, gt_p = replay_mod.slog_gt(path)
        self.gt = [replay_mod.GtEvent(float(t), p) for t, p in zip(gt_t, gt_p)]


def load_replay_log(path: str):
    """A ``.npz`` or ROS ``.bag`` log read into memory, or a ``.slog`` log
    (``SlogLog``) to replay from its file."""
    from semantic_slam_tpu_torch.io import replay as replay_mod

    if path.endswith(".slog"):
        return SlogLog(path)
    if path.endswith(".bag"):
        # recorded ROS session (rosbag v2.0) — the reference's native input
        from semantic_slam_tpu_torch.io.rosbag import read_bag

        return read_bag(path)
    return replay_mod.load_log(path)


def make_synthetic_log(**kwargs):
    """An in-process synthetic log (the generator ``synth`` writes to disk)."""
    from semantic_slam_tpu_torch.io import synthetic as synth_mod

    return synth_mod.make_synthetic_log(**kwargs)


def run_session(log, cfg, device: str, resume: str = "", finalize: bool = False, mesh=None):
    """Replay ``log`` through a fresh engine (on ``mesh``, a mesh the caller
    keeps, if given), restored from the checkpoint ``resume`` first if
    given, and with a closing ``finalize()`` pass if asked; returns the
    engine."""
    from semantic_slam_tpu_torch.io import replay as replay_mod
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    engine = SlamEngine(cfg, device=device, mesh=mesh)
    try:
        if resume:
            from semantic_slam_tpu_torch.io.checkpoint import load_checkpoint

            load_checkpoint(resume, engine)
        if isinstance(log, SlogLog):
            replay_mod.replay_slog(log.path, engine)
        else:
            replay_mod.replay(log, engine)
        if finalize:
            engine.finalize()
    except BaseException:
        engine.close()
        raise
    return engine


def voxel_inputs(engine, kf):
    """One keyframe's insert into the voxel map, on the engine's device:
    (points [H,W,3], valid [H,W], xyzrpy [6] of its optimized pose, camera
    angle), depth keyframes backprojected; None for a keyframe without a
    cloud (a restored session's) or without a pose. The pose's angles are
    taken in float64 and rounded once, so that every device inserts the
    same pose."""
    import torch

    from semantic_slam_tpu_torch.core import geometry as geo
    from semantic_slam_tpu_torch.frontend import depth as depth_mod

    if kf.cloud is None or kf.node_idx is None:
        return None
    est7 = engine.get_keyframe_pose(kf)  # archive-aware (fixed-lag)
    if est7 is None:
        return None
    if kf.depth_intr is not None:
        pts, valid = depth_mod.backproject_depth(
            engine._tensor(kf.cloud[0], torch.int32), engine._tensor(kf.depth_intr), engine._tensor(kf.depth_scale))
    else:
        pts, valid = engine._tensor(kf.cloud[0]), engine._tensor(kf.cloud[1], torch.bool)
    xyzrpy = geo.pose_to_xyzrpy(engine._tensor(est7, torch.float64)).to(engine.dtype)
    return pts, valid, xyzrpy, engine._cam_angle


def build_voxel_map(engine, carve: bool = False):
    """A ``ChunkedVoxelMap`` on the engine's device and dtype from every
    keyframe's cloud at its optimized pose (``voxel_inputs``)."""
    from semantic_slam_tpu_torch.mapping import voxel as vox

    grid = vox.ChunkedVoxelMap(carve=carve, strict_frames=engine.cfg.strict_reference_frames, dtype=engine.dtype)
    for kf in engine.keyframes:
        ins = voxel_inputs(engine, kf)
        if ins is not None:
            grid.insert_keyframe_cloud(*ins)
    return grid


def write_outputs(out_dir: str, profile: str, cfg, engine, log, save_graph: bool = False,
                  checkpoint: bool = False, dump_keyframes: bool = False, grid=None, viz_bag: bool = False,
                  viz_bag_detections: bool = False) -> dict:
    """The shutdown work of ``semantic_slam_tpu.cli run``, in its order: TUM
    dumps, the g2o graph, the checkpoint, the keyframe dumps, viz exports
    (with ``grid``, a voxel map, ``occupancy.ply``), ``viz.bag``,
    summary.json and stats.jsonl. Returns the summary; with a viz bag its
    ``viz_bag`` entry holds the bag's message counts by topic."""
    from semantic_slam_tpu_torch.eval import ate as ate_mod
    from semantic_slam_tpu_torch.io import tum as tum_mod
    from semantic_slam_tpu_torch.viz.markers import export_session

    os.makedirs(out_dir, exist_ok=True)
    kf_t = np.array([k.stamp for k in engine.keyframes])
    kf_poses = engine.get_keyframe_poses()
    if cfg.compute_txt_for_ate:
        tum_mod.write_tum(os.path.join(out_dir, "robot_pose.txt"), kf_t, kf_poses)
        vio_t = np.array([t for t, _ in engine.vio_traj])
        vio_p = np.stack([p for _, p in engine.vio_traj]) if engine.vio_traj else np.zeros((0, 7))
        tum_mod.write_tum(os.path.join(out_dir, "vio_pose.txt"), vio_t, vio_p)
        if log.gt:
            gt_t = np.array([e.t for e in log.gt])
            gt_p = np.stack([e.pose7 for e in log.gt])
            tum_mod.write_tum(os.path.join(out_dir, "gt_pose.txt"), gt_t, gt_p)

    if cfg.save_graph or save_graph:
        from semantic_slam_tpu_torch.io.g2o_io import save_g2o

        pn = engine.plane_nodes if cfg.use_plane_landmarks else None
        save_g2o(os.path.join(out_dir, "semantic_graph.g2o"), engine.graph, pn)
    if checkpoint:
        from semantic_slam_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(os.path.join(out_dir, "checkpoint.npz"), engine)
    if dump_keyframes:
        from semantic_slam_tpu_torch.io.dump import dump_keyframes as dump

        dump(os.path.join(out_dir, "keyframes"), engine)

    voxel_centers = export_session(out_dir, engine, grid)
    viz_counts = None
    if viz_bag or viz_bag_detections:
        # the reference's live publisher surface, replayable in stock rviz
        from semantic_slam_tpu_torch.viz.rviz_bag import write_viz_bag

        viz_counts = write_viz_bag(
            os.path.join(out_dir, "viz.bag"), engine, grid, path_stride=max(1, len(engine.keyframes) // 64),
            voxel_centers=voxel_centers, detections=viz_bag_detections,
        )

    history = engine.stats_history
    summary = {
        "profile": profile,
        "device": str(engine.device),
        "keyframes": len(engine.keyframes),
        "landmarks": int(engine.table.count),
        "edges": int(engine.graph.num_edges()),
        "optimize_calls": len([s for s in history if s["iterations"] > 0]),
        "mean_solve_ms": float(np.mean([s["solve_seconds"] for s in history]) * 1e3) if history else None,
    }
    if log.gt:
        gt_t = np.array([e.t for e in log.gt])
        gt_xyz = np.stack([e.pose7[:3] for e in log.gt])
        vio_t = np.array([t for t, _ in engine.vio_traj])
        vio_xyz = np.stack([p[:3] for _, p in engine.vio_traj])
        summary["ate_rmse_optimized"] = ate_mod.ate_rmse(kf_t, kf_poses[:, :3], gt_t, gt_xyz, align=False)
        summary["ate_rmse_vio"] = ate_mod.ate_rmse(vio_t, vio_xyz, gt_t, gt_xyz, align=False)
    if viz_counts is not None:
        summary["viz_bag"] = viz_counts
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(out_dir, "stats.jsonl"), "w") as f:
        for s in history:
            f.write(json.dumps(s) + "\n")
    return summary


def cmd_synth(args) -> None:
    """Write a synthetic session to an ``.npz``, ``.slog`` or ``.bag`` log."""
    import math

    from semantic_slam_tpu_torch.io import replay as replay_mod
    from semantic_slam_tpu_torch.io import synthetic as synth_mod

    log = synth_mod.make_synthetic_log(
        seed=args.seed, n_steps=args.steps, sensor_every=args.sensor_every, drift_noise=args.drift,
        loops=args.loops, H=args.height, W=args.width, cam_pitch=math.radians(args.cam_pitch_deg),
        scene=args.scene,
    )
    if args.depth:
        log = synth_mod.clouds_to_depth(log)
        if args.out.endswith(".slog"):
            sys.exit(
                "--depth with a .slog output is not supported: the SLOG "
                "binary schema carries XYZ clouds only (native/slamlog.cpp); "
                "use an .npz log for depth sessions"
            )
    if args.out.endswith(".slog"):
        from semantic_slam_tpu_torch import native

        native.write_slog(args.out, log, height=args.height, width=args.width)
    elif args.out.endswith(".bag"):
        # reference-ready rosbag: the synthetic scene on the reference
        # node's subscription topics (rosbag play into the reference node)
        from semantic_slam_tpu_torch.io.rosbag_write import write_bag

        write_bag(args.out, log)
    else:
        replay_mod.save_log(args.out, log)
    print(
        f"wrote {args.out}: {len(log.odom)} odom / {len(log.clouds)} clouds / "
        f"{len(log.depths)} depths / {len(log.detections)} detections / "
        f"{len(log.gt)} gt"
    )


def run_from_args(args, log, mesh=None):
    """``run`` on a log already in memory: the session, then its shutdown
    work. ``mesh``: a mesh of ``--devices`` ranks the caller opened and
    keeps (the Python API's way to gloo ranks sharing one card; the flags
    open their own). Returns (engine, summary)."""
    cfg = make_config(args)
    trace = contextlib.nullcontext()
    if args.xla_trace:
        from semantic_slam_tpu_torch.utils.profiling import device_trace

        trace = device_trace(args.xla_trace)
    with trace:
        engine = run_session(log, cfg, args.device, resume=args.resume,
                             finalize=args.optimize_every > 1 or args.ingest_window > 1, mesh=mesh)
    try:
        grid = build_voxel_map(engine, carve=args.carve) if args.voxel else None
        summary = write_outputs(args.out, args.profile, cfg, engine, log, save_graph=args.save_graph,
                                checkpoint=args.checkpoint, dump_keyframes=args.dump_keyframes, grid=grid,
                                viz_bag=args.viz_bag, viz_bag_detections=args.viz_bag_detections)
    finally:
        engine.close()  # a mesh's workers stop with the session
    return engine, summary


def cmd_run(args) -> dict:
    _, summary = run_from_args(args, load_replay_log(args.log))
    print(json.dumps(summary, indent=1))
    return summary


def cmd_merge(args) -> dict:
    """Merge session checkpoints into one map and run the joint dense LM over
    it (``semantic_slam_tpu.cli merge``; with ``--plane-landmarks`` the
    plane LM over the merged plane nodes)."""
    from semantic_slam_tpu_torch.config import PROFILES
    from semantic_slam_tpu_torch.io import tum as tum_mod
    from semantic_slam_tpu_torch.io.checkpoint import load_checkpoint
    from semantic_slam_tpu_torch.io.g2o_io import save_g2o
    from semantic_slam_tpu_torch.runtime import multisession as ms
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    if args.profile not in PROFILES:
        sys.exit(f"unknown profile {args.profile!r}; have {sorted(PROFILES)}")
    cfg = PROFILES[args.profile]
    if args.plane_landmarks:
        cfg = cfg.replace(use_plane_landmarks=True)
    engines = []
    for path in args.checkpoints:
        eng = SlamEngine(cfg, device=args.device)
        load_checkpoint(path, eng)
        engines.append(eng)
    graphs, tables = [e.graph for e in engines], [e.table for e in engines]
    pn = None
    if cfg.use_plane_landmarks:
        merged, pn, _ = ms.merge_graphs_planes(graphs, tables, [e.plane_nodes for e in engines],
                                               merge_radius=args.merge_radius)
        g, pn, stats = ms.joint_bundle_adjust_planes(merged, pn, max_iterations=args.max_iterations)
    else:
        merged, _ = ms.merge_graphs(graphs, tables, merge_radius=args.merge_radius)
        g, stats = ms.joint_bundle_adjust(merged, max_iterations=args.max_iterations)

    os.makedirs(args.out, exist_ok=True)
    n_act = int(g.num_poses)
    tum_mod.write_tum(os.path.join(args.out, "merged_pose.txt"), np.arange(n_act, dtype=np.float64),
                      g.poses[:n_act].cpu().numpy().astype(np.float64))
    save_g2o(os.path.join(args.out, "merged_graph.g2o"), g, pn)
    summary = {
        "sessions": len(engines),
        "poses": n_act,
        "landmarks": int(g.num_landmarks),
        "edges": int(g.num_edges()) + (int(pn.num_pe) if pn is not None else 0),
        "landmarks_per_session": [int(e.table.count) for e in engines],
        "chi2_initial": float(stats.chi2_initial),
        "chi2_final": float(stats.chi2_final),
        "lm_iterations": int(stats.iterations),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


def cmd_baginfo(args) -> None:
    """Topic/type/count summary of a recorded ROS bag (rosbag-info analog)."""
    from semantic_slam_tpu_torch.io.rosbag import DEFAULT_TOPIC_MAP, bag_info

    info = bag_info(args.bag)
    width = max((len(t) for t in info), default=0)
    for topic in sorted(info):
        msg_type, count = info[topic]
        route = DEFAULT_TOPIC_MAP.get(topic)
        used = f" -> {route[0]}" + (f" ({route[1]})" if route and route[1] else "") if route else ""
        print(f"{topic:<{width}}  {count:>7} msgs  {msg_type}{used}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="semantic_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("synth", help="generate a synthetic replay log (no JAX needed)")
    s.add_argument("--out", required=True,
                   help=".npz / .slog replay log, or .bag (reference-ready rosbag 2.0 on the reference node's "
                        "subscription topics)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--steps", type=int, default=720)
    s.add_argument("--sensor-every", type=int, default=3)
    s.add_argument("--drift", type=float, default=0.006)
    s.add_argument("--loops", type=float, default=2.0)
    s.add_argument("--height", type=int, default=240)
    s.add_argument("--width", type=int, default=320)
    s.add_argument("--cam-pitch-deg", type=float, default=0.0)
    s.add_argument("--scene", default="lab", choices=["lab", "kitti", "dense_indoor", "corridor"])
    s.add_argument("--depth", action="store_true")

    r = sub.add_parser("run", help="replay a log (.npz / .slog / ROS .bag) through the engine")
    r.add_argument("--log", required=True)
    r.add_argument("--profile", default="yolo_detector")
    r.add_argument("--out", default="results")
    r.add_argument("--compute-ate", action="store_true")
    r.add_argument("--max-keyframes", type=int, default=0, help="cap graph capacities")
    r.add_argument("--crop-size", type=int, default=0, help="override bbox crop grid")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    r.add_argument(
        "--devices", type=int, default=1,
        help="run every optimize tick's solve sharded over an N-device mesh (multi-chip product path; "
        "1 = single-chip). Forces the pcg solver. With --device cuda NCCL over N GPUs; for CPU testing "
        "combine with --device cpu (N gloo ranks)",
    )
    r.add_argument("--solver", default="", choices=["", "dense", "pcg"],
                   help="linear solver (default: the profile's, dense)")
    r.add_argument("--precond", default="jacobi", choices=["jacobi", "tridiag"],
                   help="PCG preconditioner (tridiag = odometry-chain block tridiagonal via parallel cyclic "
                        "reduction)")
    r.add_argument("--ingest-window", type=int, default=1,
                   help="pool W keyframes and ingest them together (+ one solve per window): offline-throughput "
                        "mode; each run of detection keyframes takes one frontend call, association stays "
                        "sequential inside the window. 1 = reference per-tick drain. W larger than the per-tick "
                        "ingest cap wins over it (the whole window flushes at once)")
    r.add_argument("--adaptive-normals", action="store_true",
                   help="PCL-faithful adaptive normal windows near depth discontinuities")
    r.add_argument("--xla-trace", default="",
                   help="directory for a torch.profiler trace of the replay, host and CUDA activity: "
                        "<dir>/trace.json in Chrome trace format (chrome://tracing, ui.perfetto.dev); the JAX "
                        "package's flag name")
    r.add_argument("--fixed-lag", type=int, default=0,
                   help="fixed-lag smoothing window: marginalize keyframes beyond the last N into a prior "
                        "(0 = the reference's full-history behavior)")
    r.add_argument("--robust", default="none", choices=["none", "huber", "dcs"],
                   help="robust kernel on the observation edges")
    r.add_argument("--optimize-every", type=int, default=1,
                   help="run the LM every Nth tick (1 = the reference's every tick); a finalize pass runs at the end")
    r.add_argument("--plane-gate", action="store_true", help="plane-aware association gate (normal angle + offset)")
    r.add_argument("--plane-landmarks", action="store_true",
                   help="planar-patch landmarks: SE3-plane edges solved jointly with the points (the paper's planes)")
    r.add_argument("--save-graph", action="store_true", help="write <out>/semantic_graph.g2o")
    r.add_argument("--checkpoint", action="store_true", help="write <out>/checkpoint.npz")
    r.add_argument("--dump-keyframes", action="store_true",
                   help="per-keyframe text dumps in the KeyFrame::dump format under <out>/keyframes/")
    r.add_argument("--resume", default="", help="engine checkpoint .npz to restore before the replay")
    r.add_argument("--voxel", action="store_true",
                   help="occupancy voxel map of the keyframe clouds at their optimized poses (<out>/occupancy.ply)")
    r.add_argument("--carve", action="store_true", help="with --voxel: octomap-style free-space carving + log-odds")
    r.add_argument("--viz-bag", action="store_true",
                   help="also write <out>/viz.bag: the reference's publisher surface (paths, PoseArray, landmark "
                        "MarkerArray, map->odom /tf, occupancy CUBE_LIST) for rosbag play + stock rviz")
    r.add_argument("--viz-bag-detections", action="store_true",
                   help="include the per-frame /detected_landmarks MarkerArray stream in viz.bag "
                        "(publishDetectedLandmarks); detections are recomputed post-hoc from stored clouds, the "
                        "frontend once per detection keyframe here, zero cost on the live path (implies --viz-bag)")

    m = sub.add_parser("merge", help="merge session checkpoints into one map + joint BA")
    m.add_argument("checkpoints", nargs="+", help="engine checkpoint .npz files")
    m.add_argument("--out", required=True)
    m.add_argument("--profile", default="bucket_detector_workspace")
    m.add_argument("--merge-radius", type=float, default=1.0)
    m.add_argument("--max-iterations", type=int, default=64)
    m.add_argument("--plane-landmarks", action="store_true", help="merge the sessions' plane landmarks too")
    m.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    b = sub.add_parser("baginfo", help="list topics/types/counts of a recorded ROS bag")
    b.add_argument("bag", help="rosbag v2.0 file")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    {"synth": cmd_synth, "run": cmd_run, "merge": cmd_merge, "baginfo": cmd_baginfo}[args.cmd](args)


if __name__ == "__main__":
    main()
