#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero
before the result line:

1. card   -- the card's name and power limit (nvidia-smi) and torch's name;
2. build  -- compile every kernel of ``semantic_slam_tpu_torch/csrc`` with nvcc;
3. kernel -- each kernel against its plain PyTorch version on the card, at the
             shapes the main path gives it and at ragged / empty edge cases,
             timed with CUDA events after warm-up;
4. slice  -- a 640x480 synthetic session through the port's ``cli run`` path
             (profile ``yolo_detector``, its own capacities K=512/L=128/E2=2048)
             on the card, with the launch counters reset just before it.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Artifacts of the session go to
``chiprun_out/chip_smoke/`` under the checkout.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# pairs within this distance of either threshold may count differently in the
# kernel (FMA chain) and the plain version (cuBLAS matmul)
THRESHOLD_BAND = 1e-6


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 1. card
# ---------------------------------------------------------------------------


def card_info(torch) -> dict:
    require(torch.cuda.is_available(), "torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": line, "kind": kind, "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------


def _planar_inputs(torch, D: int, N: int, S: int, gen):
    """Points on three noisy planes per detection, hypotheses seeded from
    evenly spread points as the plane extractor seeds them."""
    dev = "cuda"
    normals = torch.nn.functional.normalize(torch.randn(D, 3, 3, generator=gen, device=dev), dim=-1)
    offsets = torch.rand(D, 3, generator=gen, device=dev) * 2.0 + 0.5
    which = torch.randint(0, 3, (D, N), generator=gen, device=dev)
    n_pt = torch.gather(normals, 1, which[..., None].expand(D, N, 3))
    off = torch.gather(offsets, 1, which)
    raw = 0.5 * torch.randn(D, N, 3, generator=gen, device=dev)
    pts = raw - (torch.sum(raw * n_pt, -1) + off)[..., None] * n_pt
    pts = pts + 0.01 * torch.randn(D, N, 3, generator=gen, device=dev)
    nrm = torch.nn.functional.normalize(n_pt + 0.02 * torch.randn(D, N, 3, generator=gen, device=dev), dim=-1)
    cand = torch.rand(D, N, generator=gen, device=dev) > 0.2
    idx = (torch.arange(S, device=dev) * N) // S + N // (2 * S)
    hyp_n = nrm[:, idx].contiguous()
    hyp_d = -torch.sum(hyp_n * pts[:, idx], -1)
    return pts, nrm, cand, hyp_n, hyp_d


def _near_threshold(torch, pts, nrm, cand, hyp_n, hyp_d, dist_thres, cos_thres):
    """Per hypothesis: candidate pairs whose distance or alignment lies
    within THRESHOLD_BAND of its threshold."""
    hT = hyp_n.transpose(-1, -2).double()
    dist = torch.abs(pts.double() @ hT + hyp_d.double()[:, None, :])
    align = nrm.double() @ hT
    near = (torch.abs(dist - dist_thres) < THRESHOLD_BAND) | (torch.abs(align - cos_thres) < THRESHOLD_BAND)
    return torch.sum(near & cand[:, :, None], dim=1)


def _time_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_score_hypotheses(torch) -> dict:
    from semantic_slam_tpu_torch.frontend import kernels

    dist_thres, cos_thres = 0.02, math.cos(math.radians(2.0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for label, D, N, S, empty in (
        ("path shape", 8, 65536, 128, False),
        ("ragged N", 8, 4133, 128, False),
        ("no candidates", 8, 65536, 128, True),
    ):
        args = list(_planar_inputs(torch, D, N, S, gen))
        if empty:
            args[2] = torch.zeros_like(args[2])
        got = kernels.score_hypotheses(*args, dist_thres, cos_thres)
        ref = kernels.score_hypotheses_ref(*args, dist_thres, cos_thres)
        torch.cuda.synchronize()
        require(got.shape == (D, S) and got.dtype == torch.float32, f"{label}: bad output {got.shape} {got.dtype}")
        err = torch.abs(got - ref)
        near = _near_threshold(torch, *args, dist_thres, cos_thres).to(err.dtype)
        max_err = float(err.max())
        n_near = int(near.sum())
        print(
            f"score_hypotheses [{label}] D={D} N={N} S={S}: max|kernel-plain|={max_err:g}, "
            f"pairs within {THRESHOLD_BAND:g} of a threshold={n_near}, total inliers={float(ref.sum()):.0f}"
        )
        require(bool(torch.all(err <= near)), f"{label}: counts differ beyond the threshold band")
        if empty:
            require(float(got.abs().max()) == 0.0, "no candidates: non-zero counts")
        if label == "path shape":
            ms = _time_ms(torch, lambda: kernels.score_hypotheses(*args, dist_thres, cos_thres))
            plain_ms = _time_ms(torch, lambda: kernels.score_hypotheses_ref(*args, dist_thres, cos_thres))
            print(f"score_hypotheses [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, mean of 20)")
            result = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
    return result


# ---------------------------------------------------------------------------
# 4. the slice
# ---------------------------------------------------------------------------


def run_slice(torch) -> dict:
    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.frontend import kernels
    from semantic_slam_tpu_torch.runtime.engine import _is_det

    t0 = time.perf_counter()
    log = cli.make_synthetic_log(seed=0, n_steps=240, sensor_every=6, loops=1, H=480, W=640)
    print(f"synthetic log: {len(log.clouds)} clouds, {len(log.detections)} detection frames "
          f"({time.perf_counter() - t0:.1f} s on the host)")
    args = cli.build_parser().parse_args(
        ["run", "--log", "in-process", "--profile", "yolo_detector", "--device", "cuda",
         "--compute-ate", "--out", os.path.join(OUT_DIR, "session")]
    )
    cfg = cli.make_config(args)
    cap = cfg.capacity
    print(f"capacities K={cap.max_keyframes} L={cap.max_landmarks} E2={cap.max_landmark_edges} "
          f"D={cap.max_detections_per_frame}; crop {cfg.segmentation.crop_height}x{cfg.segmentation.crop_width}, "
          f"S={cfg.segmentation.num_hypotheses}")

    kernels.score_hypotheses.launches = 0
    t0 = time.perf_counter()
    engine = cli.run_session(log, cfg, args.device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.score_hypotheses.launches
    summary = cli.write_outputs(args.out, args.profile, cfg, engine, log)
    print("summary:", json.dumps(summary))

    g, t = engine.graph, engine.table
    tensors = [getattr(g, f) for f in ("poses", "landmarks", "lme_k", "num_lme")] + [t.world, t.cov, engine.marginals]
    require(all(x.device.type == "cuda" for x in tensors), "graph/table state is not on the card")
    require(g.poses.shape[0] == cap.max_keyframes, f"graph capacity {g.poses.shape[0]} != profile K")
    require(summary["keyframes"] > 0, "no keyframes")
    require(summary["landmarks"] > 0, "no landmarks mapped")
    opt = [s for s in engine.stats_history if s["iterations"] > 0]
    require(len(opt) > 0, "no optimizing tick")
    for s in opt:
        require(math.isfinite(s["chi2_final"]) and s["chi2_final"] <= s["chi2_initial"],
                f"LM tick went uphill or non-finite: {s}")
    require(math.isfinite(summary["ate_rmse_optimized"]), "ATE is not finite")
    poses = engine.get_keyframe_poses()
    require(poses.shape == (summary["keyframes"], 7) and bool((abs(poses) < 1e3).all()), "bad keyframe poses")

    n_det_kf = sum(1 for kf in engine.keyframes if _is_det(kf))
    rounds = cfg.segmentation.max_planes_per_detection
    print(f"score_hypotheses launches in the session: {launches} "
          f"({n_det_kf} detection keyframes x {rounds} extraction rounds = {n_det_kf * rounds})")
    require(launches > 0 and launches == n_det_kf * rounds, "kernel launches do not match the extraction rounds")

    tick_ms = [1e3 * s["solve_seconds"] for s in engine.stats_history]
    iters = [s["iterations"] for s in engine.stats_history]
    def steady_median(ticks):
        """Median after the first tick, which carries lazy CUDA / cuBLAS /
        cuSOLVER set-up."""
        rest = ticks[1:] or ticks
        return f"{statistics.median(rest):.2f} (n={len(rest)})" if rest else "none"

    print(f"ticks: {len(tick_ms)}; ms per tick (host clock, ends in the info fetch): "
          f"all = {[round(x, 2) for x in tick_ms]}")
    print("median ms per tick after the first of its kind: frontend-only "
          f"{steady_median([t for t, it in zip(tick_ms, iters) if it == 0])}, optimizing "
          f"{steady_median([t for t, it in zip(tick_ms, iters) if it > 0])}")
    print(f"LM iterations per tick: {iters}; session wall {wall:.2f} s")
    return {"launches": launches, "summary": summary}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "semantic_slam_tpu_torch")):
        print("chip_smoke: semantic_slam_tpu_torch/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    try:
        phase("card")
        card = card_info(torch)
        import semantic_slam_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
        from semantic_slam_tpu_torch import _build

        phase("build")
        t0 = time.perf_counter()
        lib = _build.build(verbose=True)
        _build.library()
        print(f"built {os.path.relpath(lib, ROOT)} from {[os.path.relpath(s, ROOT) for s in _build.sources()]} "
              f"in {time.perf_counter() - t0:.1f} s")

        phase("kernel against plain")
        k5 = check_score_hypotheses(torch)

        phase("slice on the card")
        os.makedirs(OUT_DIR, exist_ok=True)
        sl = run_slice(torch)

        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels_line = {
        "kernels": [
            {
                "name": "score_hypotheses",
                "route": "cuda",
                "source": "semantic_slam_tpu_torch/csrc/score_hypotheses.cu",
                "replaces": "semantic_slam_tpu/frontend/pallas_kernels.py:35",
                "launches": sl["launches"],
                "max_abs_err": k5["max_abs_err"],
                "ms": k5["ms"],
                "plain_ms": k5["plain_ms"],
            }
        ]
    }
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
