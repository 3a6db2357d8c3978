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
writing ``merged_pose.txt``, ``merged_graph.g2o`` and ``summary.json``. ``synth`` writes the same ``.npz`` log as the JAX
package's command.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def make_config(args):
    from semantic_slam_tpu_torch.config import PROFILES, CapacityConfig

    if args.profile not in PROFILES:
        sys.exit(f"unknown profile {args.profile!r}; have {sorted(PROFILES)}")
    cfg = PROFILES[args.profile]
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
    if args.precond:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, pcg_precond=args.precond))
    if args.plane_landmarks:
        cfg = cfg.replace(use_plane_landmarks=True)
    if args.plane_gate:
        cfg = cfg.replace(association=dataclasses.replace(cfg.association, use_plane_gate=True))
    solver_kw = {}
    if args.robust != "none":
        solver_kw["robust_kernel"] = args.robust
    if args.optimize_every > 1:
        solver_kw["optimize_every_n_ticks"] = args.optimize_every
    if args.fixed_lag > 0:
        solver_kw["fixed_lag_window"] = args.fixed_lag
    if solver_kw:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, **solver_kw))
    return cfg


def load_replay_log(path: str):
    from semantic_slam_tpu_torch.io import replay as replay_mod

    if not path.endswith(".npz"):
        sys.exit(f"unsupported log {path!r}: the port reads .npz logs")
    return replay_mod.load_log(path)


def make_synthetic_log(**kwargs):
    """An in-process synthetic log (the generator ``synth`` writes to disk)."""
    from semantic_slam_tpu_torch.io import synthetic as synth_mod

    return synth_mod.make_synthetic_log(**kwargs)


def run_session(log, cfg, device: str, resume: str = "", finalize: bool = False):
    """Replay ``log`` through a fresh engine, restored from the checkpoint
    ``resume`` first if given, and with a closing ``finalize()`` pass if
    asked; returns the engine."""
    from semantic_slam_tpu_torch.io import replay as replay_mod
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    engine = SlamEngine(cfg, device=device)
    if resume:
        from semantic_slam_tpu_torch.io.checkpoint import load_checkpoint

        load_checkpoint(resume, engine)
    replay_mod.replay(log, engine)
    if finalize:
        engine.finalize()
    return engine


def write_outputs(out_dir: str, profile: str, cfg, engine, log, save_graph: bool = False,
                  checkpoint: bool = False, dump_keyframes: bool = False) -> dict:
    """The shutdown work of ``semantic_slam_tpu.cli run``, in its order: TUM
    dumps, the g2o graph, the checkpoint, the keyframe dumps, viz exports,
    summary.json and stats.jsonl. Returns the summary."""
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

    export_session(out_dir, engine)

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
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(out_dir, "stats.jsonl"), "w") as f:
        for s in history:
            f.write(json.dumps(s) + "\n")
    return summary


def cmd_synth(args) -> None:
    """Write a synthetic session to an ``.npz`` log."""
    import math

    from semantic_slam_tpu_torch.io import replay as replay_mod
    from semantic_slam_tpu_torch.io import synthetic as synth_mod

    if not args.out.endswith(".npz"):
        raise NotImplementedError(
            f"not ported to semantic_slam_tpu_torch yet: synth --out {args.out!r} (.slog/.bag writers); use .npz"
        )
    log = synth_mod.make_synthetic_log(
        seed=args.seed, n_steps=args.steps, sensor_every=args.sensor_every, drift_noise=args.drift,
        loops=args.loops, H=args.height, W=args.width, cam_pitch=math.radians(args.cam_pitch_deg),
        scene=args.scene,
    )
    if args.depth:
        log = synth_mod.clouds_to_depth(log)
    replay_mod.save_log(args.out, log)
    print(
        f"wrote {args.out}: {len(log.odom)} odom / {len(log.clouds)} clouds / "
        f"{len(log.depths)} depths / {len(log.detections)} detections / "
        f"{len(log.gt)} gt"
    )


def run_from_args(args, log):
    """``run`` on a log already in memory: the session, then its shutdown
    work. Returns (engine, summary)."""
    cfg = make_config(args)
    engine = run_session(log, cfg, args.device, resume=args.resume, finalize=args.optimize_every > 1)
    summary = write_outputs(args.out, args.profile, cfg, engine, log, save_graph=args.save_graph,
                            checkpoint=args.checkpoint, dump_keyframes=args.dump_keyframes)
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="semantic_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("synth", help="generate a synthetic replay log (no JAX needed)")
    s.add_argument("--out", required=True)
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

    r = sub.add_parser("run", help="replay a log through the engine")
    r.add_argument("--log", required=True)
    r.add_argument("--profile", default="yolo_detector")
    r.add_argument("--out", default="results")
    r.add_argument("--compute-ate", action="store_true")
    r.add_argument("--max-keyframes", type=int, default=0, help="cap graph capacities")
    r.add_argument("--crop-size", type=int, default=0, help="override bbox crop grid")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    r.add_argument("--solver", default="", choices=["", "dense", "pcg"],
                   help="linear solver (default: the profile's, dense)")
    r.add_argument("--precond", default="", choices=["", "jacobi"],
                   help="PCG preconditioner (default: the profile's, jacobi)")
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

    m = sub.add_parser("merge", help="merge session checkpoints into one map + joint BA")
    m.add_argument("checkpoints", nargs="+", help="engine checkpoint .npz files")
    m.add_argument("--out", required=True)
    m.add_argument("--profile", default="bucket_detector_workspace")
    m.add_argument("--merge-radius", type=float, default=1.0)
    m.add_argument("--max-iterations", type=int, default=64)
    m.add_argument("--plane-landmarks", action="store_true", help="merge the sessions' plane landmarks too")
    m.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    {"synth": cmd_synth, "run": cmd_run, "merge": cmd_merge}[args.cmd](args)


if __name__ == "__main__":
    main()
