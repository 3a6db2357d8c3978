"""Where a session's time goes: one traced, timed replay of the slice.

    python -m semantic_slam_tpu_torch.profile_slice --out chiprun_out/profile_slice
    python -m semantic_slam_tpu_torch.profile_slice --solver pcg --max-keyframes 4096 \
        --out <directory>
    python -m semantic_slam_tpu_torch.profile_slice --solver pcg --max-keyframes 8192 \
        --out <directory>
    python -m semantic_slam_tpu_torch.profile_slice --fixed-lag 64 [--solver pcg] --steps 1920 \
        --out <directory>
    python -m semantic_slam_tpu_torch.profile_slice --plane-landmarks [--solver pcg --max-keyframes 4096] \
        --out <directory>

Replays one of the ``chip_smoke.py`` sessions (the 640x480 synthetic log,
profile ``yolo_detector``: the dense session at its own capacities, with
``--solver pcg --max-keyframes 4096`` the pcg one on the resident loop, or
with ``--max-keyframes 8192`` the tiled one on the row-range loop; with
``--fixed-lag N`` the fixed-lag session of that solver, whose marginalization,
prior folds and prior part of the marginals are layers of their own; with
``--plane-landmarks`` the plane-landmark session, whose row-range plane half
is the layers ``plane_lin``, once per linearization, and ``plane_matvec``,
twice per CG step) three times in one process:

1. warm-up, which carries the lazy CUDA / cuBLAS / cuSOLVER set-up;
2. plain: no profiler and no extra syncs; gives the session wall and the
   tick times as a user sees them;
3. traced: under ``torch.profiler``, with each layer's function wrapped in a
   ``record_function`` range and a host timer that synchronizes the device
   on entry and on exit. Every column of the per-layer table comes from
   this one run.

A layer's device ms is the kernel time that the profiler attributes to the
ops inside its range. The hand-written kernels (K1-K10) are launched through
``ctypes``, so no op owns their launches: a wrapper's device ms comes from
the kernel events of its kernels' names (``CTYPES_KERNELS``). The busy
share is the union of all kernel intervals over the traced run's wall; the
timers' syncs and the profiler make that wall longer than the plain one.

Writes ``profile.json`` and the profiler's op table to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import time

import torch

# (module, function, label), outermost first; each is looked up through its
# module at call time, so replacing the module attribute wraps every call
# (the two PCG loops import the marginal recovery under one label)
LAYERS = (
    ("semantic_slam_tpu_torch.runtime.engine", "_optimize_tick", "_optimize_tick"),
    ("semantic_slam_tpu_torch.runtime.engine", "_process_keyframe", "_process_keyframe"),
    ("semantic_slam_tpu_torch.runtime.engine", "_optimize_tick_planes", "_optimize_tick"),
    ("semantic_slam_tpu_torch.graph.planes", "lm_optimize_with_planes", "lm_optimize_with_planes"),
    ("semantic_slam_tpu_torch.graph.planes", "linearize_with_planes", "linearize_with_planes"),
    ("semantic_slam_tpu_torch.solver.lm", "lm_optimize", "lm_optimize"),
    ("semantic_slam_tpu_torch.solver.lm", "linearize_arrays", "linearize_arrays"),
    ("semantic_slam_tpu_torch.solver.lm", "schur_solve", "schur_solve"),
    ("semantic_slam_tpu_torch.solver.lm", "_cholesky_or_nan", "cholesky_ex"),
    ("semantic_slam_tpu_torch.solver.lm", "marginals_from_lin", "marginals_from_lin"),
    ("semantic_slam_tpu_torch.solver.ellk_soa", "lm_optimize_soa", "lm_optimize_soa"),
    ("semantic_slam_tpu_torch.solver.ellk_soa", "build_soa_edges", "build_soa_edges"),
    ("semantic_slam_tpu_torch.solver.kernels", "resident_linearize", "resident_linearize"),
    ("semantic_slam_tpu_torch.solver.kernels", "resident_solve", "resident_solve"),
    ("semantic_slam_tpu_torch.solver.kernels", "resident_chi2", "resident_chi2"),
    ("semantic_slam_tpu_torch.solver.ellk_soa", "landmark_marginals_mf_ellk", "landmark_marginals_mf"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "lm_optimize_soa_tiled", "lm_optimize_soa_tiled"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "build_dist_edges", "build_dist_edges"),
    ("semantic_slam_tpu_torch.solver.tiled_kernels", "tiled_fused_linearize", "tiled_fused_linearize"),
    ("semantic_slam_tpu_torch.solver.tiled_kernels", "tiled_mv_fwd", "tiled_mv_fwd"),
    ("semantic_slam_tpu_torch.solver.tiled_kernels", "tiled_mv_bwd", "tiled_mv_bwd"),
    ("semantic_slam_tpu_torch.solver.tiled_kernels", "tiled_chi2", "tiled_chi2"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "landmark_marginals_mf_ellk", "landmark_marginals_mf"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "lm_optimize_soa_planes", "lm_optimize_soa_planes"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "plane_slot_blocks", "plane_lin"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "plane_wT_x", "plane_matvec"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "plane_w_z", "plane_matvec"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "ell_linearize_planes", "ell_linearize_planes"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "marginalize_planes", "marginalize"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "apply_prior_planes", "prior_fold"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "marginalize", "marginalize"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "lm_optimize_prior", "lm_optimize_prior"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "apply_prior", "prior_fold"),
    ("semantic_slam_tpu_torch.solver.ellk_soa", "apply_prior_blocks", "prior_fold"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "apply_prior_blocks", "prior_fold"),
    ("semantic_slam_tpu_torch.solver.soa_dist", "prior_matvec", "prior_matvec"),
    ("semantic_slam_tpu_torch.solver.pcg", "prior_woodbury", "prior_marginals"),
    ("semantic_slam_tpu_torch.solver.fixed_lag", "landmark_marginals_prior", "prior_marginals"),
    ("semantic_slam_tpu_torch.frontend.planes", "extract_planes", "extract_planes"),
    ("semantic_slam_tpu_torch.frontend.planes", "score_hypotheses", "score_hypotheses"),
    ("semantic_slam_tpu_torch.frontend.normals", "compute_normals", "compute_normals"),
    ("semantic_slam_tpu_torch.assoc.association", "associate", "associate"),
)
# wrapper label -> the names of the kernels it launches through ctypes (K1
# with K2's blocks, and K1 alone, launch the same two kernels; K6 with K7's
# blocks, and K6 alone, launch their bodies under names of their own, as K10
# launches K3's slot pass)
CTYPES_KERNELS = {
    "score_hypotheses": ("score_kernel",),
    "resident_linearize": ("lin_slots_kernel", "lin_fold_kernel"),
    "obs_linearize": ("lin_slots_kernel", "lin_fold_kernel"),
    "resident_chi2": ("chi2_slots_kernel",),
    "resident_solve": ("solve_cluster_kernel", "solve_grid_kernel"),
    "tiled_fused_linearize": ("rows_lin_slots", "rows_lin_fold"),
    "tiled_obs_linearize": ("rows_lin_slots", "rows_lin_fold"),
    "tiled_mv_fwd": ("rows_mvf_slot", "rows_mvf_lm"),
    "tiled_mv_bwd": ("rows_mvb_pose",),
    "tiled_chi2": ("rows_chi2_slots",),
}


# wrappers that also launch the shared one-block sum ``reduce2_kernel``
# (soa_common.cuh), which a session trace cannot assign to one of them
REDUCE2_LAUNCHERS = ("resident_chi2", "tiled_chi2")


# traces kernel_device_ms takes at most: CUPTI now and then hands back a
# trace without the kernel's events (seen once for K4's cooperative launch)
DEVICE_MS_TRACES = 3


def kernel_device_ms(fn, label: str, reps: int = 20) -> float:
    """Device ms per call of ``fn``, a call of the wrapper ``label`` alone:
    the summed intervals of its kernels (``CTYPES_KERNELS``, and
    ``reduce2_kernel`` where it launches one) in a ``torch.profiler`` trace
    of ``reps`` calls after three warm-up calls, traced again (up to
    ``DEVICE_MS_TRACES`` times) while a trace holds none of them. It leaves
    out the wrapper's host work between launches, which CUDA events around
    back-to-back calls include."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    names = CTYPES_KERNELS[label] + (("reduce2_kernel",) if label in REDUCE2_LAUNCHERS else ())
    for _ in range(DEVICE_MS_TRACES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA and any(f"{n}(" in e.name for n in names)]
        if evs:
            break
    else:
        raise RuntimeError(f"no kernel events of {names} in {DEVICE_MS_TRACES} traces of {reps} calls")
    # each kernel launches at most once a call; the mean per kernel name, summed,
    # also holds where the trace dropped some events
    by_name = {}
    for e in evs:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(sum(v) / len(v) for v in by_name.values()) / 1e3


def _sync_for(device: str):
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


@contextlib.contextmanager
def timed_layers(device: str):
    """Wrap every function of ``LAYERS`` in a ``record_function`` range and a
    synchronized host timer; yields {label: [calls, host seconds]}."""
    import importlib

    sync = _sync_for(device)
    totals = {label: [0, 0.0] for _, _, label in LAYERS}
    saved = []

    def wrap(fn, label):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
                sync()
            totals[label][0] += 1
            totals[label][1] += time.perf_counter() - t0
            return out

        return timed

    try:
        for mod_name, attr, label in LAYERS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(getattr(mod, attr), label))
        yield totals
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _tick_summary(engine) -> dict:
    ms = [1e3 * s["solve_seconds"] for s in engine.stats_history]
    iters = [s["iterations"] for s in engine.stats_history]

    def steady_median(ticks):
        rest = ticks[1:] or ticks  # the first tick of a kind carries set-up
        return statistics.median(rest) if rest else None

    return {
        "tick_ms": ms,
        "lm_iterations": iters,
        "median_optimizing_tick_ms": steady_median([t for t, it in zip(ms, iters) if it > 0]),
        "median_frontend_tick_ms": steady_median([t for t, it in zip(ms, iters) if it == 0]),
    }


def profile_session(log, cfg, device: str, out_dir: str | None = None) -> dict:
    """The three replays of ``log`` (module docstring); returns the report."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semantic_slam_tpu_torch import cli

    sync = _sync_for(device)
    cli.run_session(log, cfg, device)  # warm-up
    sync()

    t0 = time.perf_counter()
    plain = cli.run_session(log, cfg, device)
    sync()
    plain_wall = time.perf_counter() - t0

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with timed_layers(device) as totals, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        traced = cli.run_session(log, cfg, device)
        sync()
        traced_wall = time.perf_counter() - t0

    events = prof.events()
    labels = {label for _, _, label in LAYERS}
    device_us = {label: 0.0 for label in labels}
    kernels = []
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in device_us:
            device_us[e.name] += e.device_time_total
        elif e.device_type == DeviceType.CUDA and e.name not in labels:
            kernels.append(e)
    hand = {label: [e for e in kernels if any(f"{n}(" in e.name for n in names)]
            for label, names in CTYPES_KERNELS.items() if label in labels}
    for label, evs in hand.items():
        device_us[label] = sum(e.time_range.elapsed_us() for e in evs)
    # launches of each hand-written kernel by name, reduce2_kernel included
    names = sorted({n for ns in CTYPES_KERNELS.values() for n in ns} | {"reduce2_kernel"})
    launches = {n: sum(1 for e in kernels if f"{n}(" in e.name) for n in names}
    busy_us = _busy_us((e.time_range.start, e.time_range.end) for e in kernels)

    rows = []
    for label in dict.fromkeys(label for _, _, label in LAYERS):  # once each, outermost first
        calls, host_s = totals[label]
        rows.append({
            "layer": label,
            "calls": calls,
            "host_ms_total": 1e3 * host_s,
            "host_ms_per_call": 1e3 * host_s / calls if calls else None,
            "device_ms_total": 1e-3 * device_us[label] if on_card else None,
            "device_ms_per_call": 1e-3 * device_us[label] / calls if on_card and calls else None,
        })
    report = {
        "device": str(device),
        "plain": {"wall_s": plain_wall, **_tick_summary(plain)},
        "traced": {
            "wall_s": traced_wall,
            **_tick_summary(traced),
            "kernel_events": len(kernels),
            "hand_kernel_events": {label: len(evs) for label, evs in hand.items()},
            "hand_kernel_launches": launches,
            "device_busy_ms": 1e-3 * busy_us if on_card else None,
            "busy_share": 1e-3 * busy_us / (1e3 * traced_wall) if on_card else None,
        },
        "layers": rows,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile.json"), "w") as f:
            json.dump(report, f, indent=1)
        sort_by = "self_cuda_time_total" if on_card else "self_cpu_time_total"
        with open(os.path.join(out_dir, "ops.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))
    return report


def _print_report(report: dict) -> None:
    plain, traced = report["plain"], report["traced"]
    print(f"plain run: wall {plain['wall_s']:.4f} s; median optimizing tick "
          f"{plain['median_optimizing_tick_ms']} ms, frontend-only {plain['median_frontend_tick_ms']} ms; "
          f"LM iterations {plain['lm_iterations']}")
    print(f"traced run: wall {traced['wall_s']:.4f} s; LM iterations {traced['lm_iterations']}; "
          f"{traced['kernel_events']} kernel events (hand-written: {traced['hand_kernel_events']}; by kernel: "
          f"{traced['hand_kernel_launches']}); "
          f"device busy {traced['device_busy_ms']} ms, busy share {traced['busy_share']}")
    print(f"{'layer':<20} {'calls':>6} {'host ms':>10} {'host ms/call':>13} {'dev ms':>10} {'dev ms/call':>12}")
    for r in (r for r in report["layers"] if r["calls"]):
        def fmt(x, w):
            return f"{x:>{w}.4f}" if x is not None else f"{'-':>{w}}"

        print(f"{r['layer']:<20} {r['calls']:>6} {fmt(r['host_ms_total'], 10)} {fmt(r['host_ms_per_call'], 13)} "
              f"{fmt(r['device_ms_total'], 10)} {fmt(r['device_ms_per_call'], 12)}")


def main(argv=None) -> None:
    from semantic_slam_tpu_torch import cli

    ap = argparse.ArgumentParser(prog="python -m semantic_slam_tpu_torch.profile_slice")
    ap.add_argument("--out", default="chiprun_out/profile_slice")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--max-keyframes", type=int, default=0)
    ap.add_argument("--crop-size", type=int, default=0)
    ap.add_argument("--solver", default="", choices=["", "dense", "pcg"])
    ap.add_argument("--fixed-lag", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plane-landmarks", action="store_true")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip() or smi.stderr.strip())
    log = cli.make_synthetic_log(seed=args.seed, n_steps=args.steps, sensor_every=6,
                                 loops=max(args.steps / 240, 1.0), H=args.height, W=args.width)
    run_args = ["run", "--log", "in-process", "--profile", "yolo_detector", "--device", args.device,
                "--max-keyframes", str(args.max_keyframes), "--crop-size", str(args.crop_size),
                "--solver", args.solver, "--fixed-lag", str(args.fixed_lag)] + (
                    ["--plane-landmarks"] if args.plane_landmarks else [])
    cfg = cli.make_config(cli.build_parser().parse_args(run_args))
    report = profile_session(log, cfg, args.device, args.out)
    _print_report(report)


if __name__ == "__main__":
    main()
