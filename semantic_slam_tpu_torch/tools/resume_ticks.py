#!/usr/bin/env python3
"""Optimizing-tick times of a resumed session against an unbroken one, on
one NVIDIA GPU.

    python semantic_slam_tpu_torch/tools/resume_ticks.py --out FILE [--rounds 2]

The session is ``chip_smoke.py``'s fixed-lag pcg session (``FL_LOG``,
``--fixed-lag 64 --solver pcg``, profile ``yolo_detector`` at its own
capacities). "unbroken" replays the whole log; "split" replays the log's
first part (``chip_smoke.FL_SPLIT`` of its odometry stamps) with
``--checkpoint`` and then the rest with ``--resume`` from that checkpoint.
Each side runs in a process of its own, in turns (unbroken, split, split,
unbroken for two rounds), so that neither inherits the other's host state.
For the ticks after the split each run writes the median optimizing tick
(host clock, ``stats_history``), the LM iterations and the ms per LM
iteration; the card's name and power limit come with them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _later_ticks(history: list[dict], n_first: int) -> dict:
    later = [s for s in history[n_first:] if s["iterations"] > 0]
    ms = [1e3 * s["solve_seconds"] for s in later]
    iters = sum(s["iterations"] for s in later)
    return {"ticks": len(later), "median_tick_ms": statistics.median(ms), "lm_iterations": iters,
            "ms_per_iteration": sum(ms) / iters}


def run_side(side: str, out_dir: str) -> dict:
    """One side in this process: the log made from ``chip_smoke.FL_LOG``,
    the kernels built, the session(s) replayed through ``cli.run_from_args``."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from semantic_slam_tpu_torch import _build, cli

    _build.build()
    log = cli.make_synthetic_log(**cs.FL_LOG)
    first, second = cs._split_log(log, cs.FL_SPLIT)

    def run(part, label, *flags):
        args = cli.build_parser().parse_args(
            ["run", "--log", "in-process", "--profile", "yolo_detector", "--device", "cuda", "--out",
             os.path.join(out_dir, side, label), "--fixed-lag", str(cs.FL_WINDOW), "--solver", "pcg", *flags])
        t0 = time.perf_counter()
        engine, _ = cli.run_from_args(args, part)
        torch.cuda.synchronize()
        return engine, time.perf_counter() - t0

    if side == "unbroken":
        engine, wall = run(log, "whole")
        n_first = sum(1 for k in engine.keyframes if k.stamp < second.odom[0].t)  # one tick a keyframe
    else:
        first_engine, _ = run(first, "first", "--checkpoint")
        n_first = len(first_engine.stats_history)
        del first_engine
        engine, wall = run(second, "resumed", "--resume", os.path.join(out_dir, side, "first", "checkpoint.npz"))
    return {"side": side, "keyframes": len(engine.keyframes), "ticks_before_split": n_first,
            "wall_s": wall, **_later_ticks(engine.stats_history, n_first)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of (unbroken, split), the order alternating")
    ap.add_argument("--side", choices=("unbroken", "split"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)), "resume_ticks")
    if args.side:
        print(json.dumps(run_side(args.side, out_dir)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    runs = []
    for r in range(args.rounds):
        for side in (("unbroken", "split") if r % 2 == 0 else ("split", "unbroken")):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--out", args.out, "--side", side],
                               capture_output=True, text=True)
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                return p.returncode
            runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]))
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
