#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits non-zero
before the result line:

1. card   -- the card's name and power limit (nvidia-smi) and torch's name;
2. build  -- compile every kernel of ``semantic_slam_tpu_torch/csrc`` with nvcc,
             one process per source, all started together;
3. kernels against plain -- each kernel against its plain PyTorch version on
             the card, at the shapes the main paths give it and at ragged /
             empty edge cases, timed with CUDA events after warm-up (the
             wrapper's host work between launches included) and by its own
             intervals in a ``torch.profiler`` trace (device time):
             K5 (RANSAC scoring) at [D=8, N=65,536, S=128] and at the
             window's D' = 64, its bound counted in instructions a test;
             K1-K4 (the
             resident SoA Schur-PCG solver; K1 + K2 as the one call the LM
             makes, its chain outputs and its linearization each against
             the plain version, and K1 alone on given chain blocks) at the
             bench shape
             K=4096/L=1024/E2=16384 (R=4), at the engine's
             ``--max-keyframes 4096`` shape (R=32), at the fixed-lag pcg
             session's K=512/L=128/E2=2048 (R=32; K1 + K2, K1 alone and K3
             timed under each robust kernel) and at a ragged K=1000, under robust
             none/huber/dcs; K6-K10 (the row-range solver; K6 + K7 as the
             one call the loop makes, its chain outputs and its linearization
             each against the plain version, and K6 alone on given chain
             blocks) at the bench shape K=8192/L=2048/E2=32768 (R=4), at the
             engine's ``--max-keyframes 8192`` shape (R=32), at
             K=16384/L=4096 and at the plane fixed-lag session's
             K=512/L=128/E2=2048 (R=32), each on the whole row range and on
             rows [0, K/2) and [K/2, K);
4. two halves -- K6+K7 and K8 -> K9 on rows [0, K/2) and [K/2, K), summed,
             embedded and shifted, against the whole range (the row-range
             contract of a multi-device loop);
5. fixed-work LMs -- 8 LM iterations of 128 CG steps: the resident loop at
             K=4096 and the row-range loop at K=8192, each through the kernels
             and through the plain versions; and the two loops on the K=4096
             graph against each other;
5b. the fixed-lag prior -- a prior from ``fixed_lag.marginalize`` (drop 16,
             PB=8) on the bench graph at a perturbed state: K4 with it against
             its plain version at the pcg session's shape (K=4096/L=1024, R=32,
             K4's cooperative-grid shape) and at the fixed-lag session's
             (K=512/L=128, R=32, its thread-block-cluster shape), also with the
             prior's block moved onto free poses (the marginalized block sits
             on the gauge-fixed pose 0), timed with and without the prior, and
             by device time at 128 and at 0 CG steps (the time of a step); the
             resident LM with the prior through the kernels against the plain
             versions, and the row-range LM with the prior against the
             resident one, at K=4096;
6. dense slice -- a 640x480 synthetic session through the port's ``cli run``
             path (profile ``yolo_detector``, its own capacities
             K=512/L=128/E2=2048, dense Schur LM), counters reset just before;
7. pcg slice -- the same session with ``--solver pcg --max-keyframes 4096``
             (K=4096/L=1024/E2=16384, R=32): every LM iteration runs K1-K4;
8. tiled slice -- the same session with ``--solver pcg --max-keyframes 8192``
             (K=8192/L=2048/E2=32768, R=32): every LM iteration runs K6-K10,
             and the marginals' linearization K1 + K2;
9. fixed-lag slices -- a longer 640x480 session (seed 1, 1920 steps, ~120
             keyframes) with ``--fixed-lag 64``, dense and ``--solver pcg``
             (resident loop at K=512): at least 3 marginalizations, fewer than
             80 active poses, every keyframe exported, chi2 never rising, ATE
             no worse than raw VIO's, and every K4 launch carrying the prior;
             the pcg one's K1-K4 launch counts are printed;
10. session lifecycle -- the dense slice's log through ``cli run --solver pcg``
             at the profile's capacities (K=512, the resident loop, K4 in its
             cluster shape): split at its middle odometry stamp, the first half
             with --checkpoint --save-graph --dump-keyframes, the second half
             with --resume from that checkpoint, and the whole log unbroken
             (with --checkpoint); the resumed session's keyframes, landmarks,
             ATE and median optimizing tick printed beside the unbroken one's;
             the checkpoint loaded into a fresh engine on the card (every
             tensor bit for bit) and the .g2o read back (the saved graph's
             active rows); a --robust dcs --optimize-every 3 session ending in
             its finalize pass; and ``cli merge`` of the first half's
             checkpoint with the unbroken session's (chi2 not rising, no more
             landmarks than the sessions'); its wall time printed;
10b. the ROS surface -- the dense slice's log written as a rosbag (read back,
             ``baginfo``) and, from the bag's read-back, as a ``.slog``; ``cli
             run`` from each with ``--solver pcg --max-keyframes 4096 --voxel
             --carve --viz-bag-detections``: the counts of the read-back log
             replayed from memory and its ATE within 1%, the pcg slice's
             keyframes and ATE within 1%, K5 once more for each detection
             keyframe the viz bag re-runs, viz.bag read back; the two sessions' voxel maps equal
             (the .slog clouds, read after the reader closed, at the .bag
             poses: bit for bit), the card's map against a CPU rebuild (hits
             of every keyframe, one keyframe's carving: at most 0.1% of the
             voxels differ), its hits the valid points inside its chunks; the
             voxel ms per keyframe with and without carving and its peak
             device memory, the bag and .slog MB/s and the phase's wall time;
11. fixed-lag session lifecycle -- the fixed-lag pcg session's log split at
             three quarters (after its first marginalization): the first part
             with --checkpoint (LM-optimized state and a non-empty prior),
             that checkpoint loaded into a fresh engine on the card (every
             tensor bit for bit), the rest resumed from it; its keyframes,
             ATE and median optimizing tick printed beside the fixed-lag pcg
             slice's;
12. plane slices -- plane landmarks (``--plane-landmarks``) at full width:
             A, the dense slice's log on the dense plane LM (K=512); B, the
             same with ``--solver pcg --max-keyframes 4096`` (K=4096,
             L = Pl = 1024: the row-range loop with its plane half, K6-K10,
             and the marginals over L + Pl blocks through K1 + K2); C, the
             fixed-lag log with ``--fixed-lag 64 --solver pcg`` (K=512: K6-K10
             at Kl=512 with a prior that has a plane part), with
             --checkpoint --save-graph. Each: a plane per landmark, a plane
             edge per observation edge (C: at least 8; the dense log holds
             fewer observations), unit normals, chi2 never rising, ATE no worse
             than raw VIO's (the point session's printed beside), K5-K10
             and K1 + K2 launched as the ticks imply; A and B with the point
             sessions' keyframes; C with 2+ marginalizations, a non-zero
             plane prior, its checkpoint bit for bit on the card and its
             .g2o (plane records too) read back equal. At B's and C's final
             states, what a CG step costs with the plane half and without
             it (K8/K9 launches from their counters, one call of each a
             step; device events and ms from a trace that holds every one
             of those launches; host ms);
13. breadth -- the last single-device paths at full width: the window
             program alone on ``parallel/window_inputs.py``'s run (card
             against CPU, K5 once for the window); the plane log in point
             mode with ``--ingest-window 8`` (each run of detection
             keyframes one frontend call, K5 over its B x D detections a
             round) against phase 12's per-tick point session after both
             finalize (equal keyframes, landmarks, edges; poses within
             5e-4); ``--precond tridiag`` at the pcg slice's K=4096 (K1-K3,
             no K4) and the tiled slice's K=8192 (K6-K10; the CG stops at
             its tolerance), chi2 never rising and ATE no worse than raw
             VIO's, ms per LM iteration and CG steps to tolerance beside
             jacobi's; fitness-weighted odometry information and
             ``--adaptive-normals`` on the dense log; ``--xla-trace`` on the
             dense session, whose trace holds K5's kernel events;
14. several ranks on the card -- ``parallel/dist.py``'s meshes: NCCL at
             world size 1, then gloo ranks sharing the card (2 and 4; gloo
             stages CUDA tensors through the host), each worker checked to
             hold no JAX module. At the tiled session's graph (K=8192,
             L=2048, R=4) ``soa_dist.sharded_lm_optimize_soa`` at fixed
             work (8 LM iterations of 128 CG steps) on world size 1 against
             ``lm_optimize_soa_tiled`` and on 2 and 4 ranks (rows
             [r K/n, (r+1) K/n), off > 0) against world size 1, poses within
             1e-4 of scale; each rank's K6-K10 launches as the iterations
             imply, the collectives per CG step and their bytes, ms per LM
             iteration. On 2 ranks: the tiled session (``--solver pcg
             --max-keyframes 8192 --devices 2``, every rank's K6-K10 as its
             solves imply) with the tiled slice's keyframes, landmarks and
             edges and poses within 1e-4 of scale, its distributed
             checkpoint read back bit for bit; the sharded window step at
             full width (8 rows of 8 detections on 640x480 clouds, 256x256
             crops, 128 hypotheses: K5 at D' = 32, N = 65,536, S = 128 once a
             plane round on each rank) against the single-device window
             program; ``sharded_lm_optimize_soa_planes`` at fixed work with
             the marginals on plane sessions B's (K=4096) and C's (K=512,
             a fixed-lag prior with a plane part) final states against
             ``lm_optimize_soa_planes``, each rank's K6-K10 launches those
             of one device; ``joint_bundle_adjust`` of the lifecycle's two
             checkpoints on the mesh against one device (chi2 within 1e-3).
The counters are reset just before each session and checked against the LM's
iteration counts just after (a window's frontend call counted once).

The line before the last is a JSON object with one entry per kernel (launches
from the session whose path runs it, K1-K3 and K5 from the pcg slice (K1's and
K2's both the count of their one wrapper), K4 from the fixed-lag pcg slice,
K6-K10 from the tiled slice (K6's and K7's both the count of their one
wrapper); times and errors at the engine shapes, K4's with the prior at the
fixed-lag session's shape, K1's those of K1 alone, K2's device time the
pair's less K1's and its event time the pair's call, K6's and K7's likewise,
all measured here; each kernel's bound, and its device time; K4's also per CG
step); the last line
is ``{"ok": true, "device": {...}}``.
Artifacts of the sessions go to ``OUT_DIR`` under the checkout. Run
without the package beside it, the script exits 4, a code of its own
(1 is a failed phase).
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
# K1-K3, K6-K10 against plain: max |kernel - plain| over max |plain|, per output (f32,
# summation order only)
LIN_RTOL = 1e-4
# K4 against plain: ||kernel - plain|| / ||plain|| for dp and db, the repo's
# kernel-vs-XLA CG bound (tools/tpu_kernel_check.py)
SOLVE_RTOL = 5e-2
# fixed-work LM: final chi2, kernels against plain
LM_RTOL = 1e-3

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM rate, fp32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# instructions its lanes start a second (132 SMs x 4 schedulers x 32 lanes at
# the 1.98 GHz boost clock): the rate for work that is not mostly FMAs,
# which FP32_FLOP_PER_S counts as two operations each
INSTR_PER_S = 132 * 128 * 1.98e9
# K5's instructions a point-hypothesis test, from the SASS of the kernel as
# built for sm_90a (semantic_slam_tpu_torch/tools/k5_sass.py): 2 FMUL, 4 FFMA
# and an FADD for the two dot products and the offset, 2 FSETP for the
# compares with the predicate AND folded in, and the count's select and add;
# not the loop's loads, warp sums, lane select or counter
K5_INSTR_PER_TEST = 11

BENCH = dict(K=4096, L=1024, E2=16384)  # bench.py's mid cell, R = 4
ENGINE_R = 32  # yolo_detector: 8 detections x 4 planes per keyframe
RAGGED = dict(K=1000, L=250, E2=7992)  # K not a multiple of any block size, R = 8
TILED_BENCH = dict(K=8192, L=2048, E2=32768)  # bench.py's large cell, R = 4
TILED_LARGE = dict(K=16384, L=4096, E2=65536)  # the largest cell of the JAX package's tiled path, R = 4
LM_STEPS = 128  # CG steps per LM iteration in the fixed-work LMs
FL_ENGINE = dict(K=512, L=128, E2=2048)  # yolo_detector's own capacities: the fixed-lag session's graph
PRIOR_DROP = 16  # keyframes marginalized into the prior of the K4 and LM checks
# K4 with a prior block moved onto free poses: at those poses its error against
# the plain version, as a share of the block's own effect on the step there
# (~5e-7 on an H100 80GB HBM3; a product 10% off gives ~3e-2)
PRIOR_ROW_RTOL = 1e-3
FL_WINDOW = 64  # --fixed-lag of the fixed-lag sessions (chunk max(8, 64 // 4) = 16)
# the fixed-lag sessions' log: benchmarks/pipeline_bench.py's deployment (seed 1, loops = steps / 240), cut from
# 1800 steps with sensor_every=3 to 1920 with 6: ~120 keyframes, so that the window of 64 marginalizes 3 times
FL_LOG = dict(seed=1, n_steps=1920, sensor_every=6, loops=8.0, H=480, W=640)
WINDOW = 8  # --ingest-window of phase 13's window session; K5's window shape is D' = WINDOW x 8
# plane sessions A and B: the dense session's log (seed 0, a loop of 240 steps) run three times round, 45
# keyframes and 11 observations (5 on the dense log's one loop), so that at least 8 plane edges are checked
PLANE_LOG = dict(seed=0, n_steps=720, sensor_every=6, loops=3.0, H=480, W=640)
DEVICE = "cuda"  # every tensor of the phases lives here


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def bound(n_bytes: float, n_flops: float = 0.0, n_instr: float = 0.0) -> dict:
    """The least time for the work: the larger of bytes over the HBM rate and
    operations, fp32 flops over the fp32 rate or instructions over the instruction
    rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_flops / FP32_FLOP_PER_S, n_instr / INSTR_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": n_flops, "instructions": n_instr}


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


def _device_ms(torch, fn, label: str, reps: int = 20) -> float:
    """The kernels' own time per call of the wrapper ``label``, from a
    ``torch.profiler`` trace (``profile_slice.kernel_device_ms``): without the
    host's time between launches, which ``_time_ms`` includes."""
    from semantic_slam_tpu_torch.profile_slice import kernel_device_ms

    return kernel_device_ms(fn, label, reps)


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
# 3a. K5 against its plain version
# ---------------------------------------------------------------------------


def _planar_inputs(torch, D: int, N: int, S: int, gen):
    """Points on three noisy planes per detection, hypotheses seeded from
    evenly spread points as the plane extractor seeds them."""
    dev = DEVICE
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


def check_score_hypotheses(torch) -> dict:
    from semantic_slam_tpu_torch.frontend import kernels

    dist_thres, cos_thres = 0.02, math.cos(math.radians(2.0))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    result = {}
    for label, D, N, S, empty in (
        ("path shape", 8, 65536, 128, False),
        # window ingest (--ingest-window 8): one launch a round scores the
        # detections of the 8 keyframes of a run, D' = B * D
        ("window shape", WINDOW * 8, 65536, 128, False),
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
        if label in ("path shape", "window shape"):
            ms = _time_ms(torch, lambda: kernels.score_hypotheses(*args, dist_thres, cos_thres))
            plain_ms = _time_ms(torch, lambda: kernels.score_hypotheses_ref(*args, dist_thres, cos_thres))
            dev_ms = _device_ms(torch, lambda: kernels.score_hypotheses(*args, dist_thres, cos_thres),
                                "score_hypotheses")
            # bytes: points and normals (12 B each), the candidate mask (1 B),
            # hypotheses (16 B) and counts (4 B); operations: the test's own
            # instructions (K5_INSTR_PER_TEST) at the instruction rate
            b = bound(D * N * 25 + D * S * 20, n_instr=D * N * S * K5_INSTR_PER_TEST)
            print(f"score_hypotheses [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, mean "
                  f"of 20), kernel device time {dev_ms:.4f} ms (profiler); bound {b['bound_ms']:.4f} ms by "
                  f"{b['bound_by']} ({K5_INSTR_PER_TEST} instructions a test)")
            if label == "path shape":
                result.update({"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, **b})
            else:
                result.update({"window_D": D, "window_ms": ms, "window_plain_ms": plain_ms,
                               "window_device_ms": dev_ms, "window_bound_ms": b["bound_ms"],
                               "window_max_abs_err": max_err})
    return result


# ---------------------------------------------------------------------------
# 3b. K1-K4 against their plain versions
# ---------------------------------------------------------------------------


def _soa_case(torch, K: int, L: int, E2: int, R: int | None = None, perturb: bool = False):
    """A seeded ``graph/synthetic.py`` graph (noise 0.05) on the card, in f32,
    in SoA layout with R slots per pose (default: the graph's own bound);
    ``perturb`` moves every pose by ~5 cm and ~0.02 rad (seeded)."""
    from semantic_slam_tpu_torch.graph import synthetic as syn
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g = syn.build_graph(K, L, E2, torch.float32, seed=0, noise=0.05, device=DEVICE)
    R = R or syn.ell_rows_for(K, E2)[2]
    if perturb:
        # an LM iterate rather than the start: there every chain residual is
        # 0 up to rounding (the poses integrate the odometry), and outputs
        # made of rounding noise cannot be compared relative to themselves
        dev = g.poses.device
        gen = torch.Generator(device=dev).manual_seed(1)
        t = g.poses[:, :3] + 0.05 * torch.randn(K, 3, generator=gen, device=dev)
        q = torch.nn.functional.normalize(g.poses[:, 3:] + 0.01 * torch.randn(K, 4, generator=gen, device=dev), dim=-1)
        g = g.replace(poses=torch.cat([t, q], dim=1))
    se = soa.build_soa_edges(_edge_args(g), K, R, L)
    pf, lf = _free_masks(g)
    return g, se, pf, lf, R


# the linearization's outputs that K1 computes (Hii, Hij, Hjj are K2's)
LIN_FIELDS = ("v", "Ow", "Rt", "gp", "diag", "gl", "Hll", "chi2")


def _rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = float((got.double() - want.double()).abs().max())
    return d, d / max(float(want.double().abs().max()), 1e-30)


def _norm_err(torch, got, want) -> float:
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()).clamp_min(1e-30))


def _init_lambda(torch, lin):
    """The LM's first damping (``run_lm_loop_soa``'s seed)."""
    diag_max = torch.maximum(lin.diag.diagonal(dim1=0, dim2=1).abs().max(),
                             lin.Hll.diagonal(dim1=-2, dim2=-1).abs().max())
    return 1e-5 * torch.clamp(diag_max, min=1.0)


def _lin_bytes_flops(K: int, R: int, L: int, E_real: int) -> dict:
    """Bytes and fp32 operations of each SoA kernel at one shape (4-byte
    words; each input read once, each output written once). Operations are
    counted from the plain versions' op sequences, rounded: about 230 per
    observation slot to linearize, 3,000 per chain edge, 50 per slot and 520
    per chain edge for the objective alone."""
    E = K * R
    return {
        "chain_linearize": (4 * (50 * K + 120 * K + 1), 3000 * K),
        "obs_linearize": (4 * (7 * K + 3 * L + 14 * E + L + 1 + 84 * K + 1 + 12 * E + 51 * K + 12 * L + 1),
                          230 * E_real + 80 * K),
        "resident_chi2": (4 * (7 * K + 3 * L + 13 * E + 43 * K + 1), 50 * E_real + 520 * K),
    }


def _solve_bytes_flops(K: int, R: int, L: int, E_real: int, steps: int, PB: int = 0) -> tuple[float, float]:
    """K4: inputs v, O', the slot and CSR indices, Rt, the chain blocks and
    diagonal, gp, gl, Hll, both masks; outputs dp, db. Per CG step about 93
    operations per observation, 15 per landmark and 420 per pose (the two
    matvec halves, the chain's four 6x6 products, the update and the
    preconditioner), plus the set-up and back-substitution. A fixed-lag
    prior over PB slots adds Hp [6PB, 6PB] and its indices to the bytes and
    its product, 2 (6PB)^2 operations, to every CG step."""
    E = K * R
    n_bytes = 4 * (14 * E + 160 * K + 14 * L + 2 + 6 * K + 3 * L + 36 * PB * PB + PB)
    n_flops = steps * (93 * E_real + 15 * L + 420 * K + 72 * PB * PB) + 450 * K + 100 * L + 100 * E_real
    return n_bytes, n_flops


def check_soa_kernels(torch) -> dict:
    """K1-K4 against their plain versions at the bench, engine, fixed-lag and
    ragged shapes; returns the engine shape's numbers per kernel."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels

    out = {}
    cases = (
        ("bench R=4", BENCH, None, ("none", "huber", "dcs")),
        (f"engine R={ENGINE_R}", BENCH, ENGINE_R, ("none", "huber", "dcs")),
        (f"fixed-lag R={ENGINE_R}", FL_ENGINE, ENGINE_R, ("none", "huber", "dcs")),
        ("ragged K=1000", RAGGED, None, ("none", "huber", "dcs")),
    )
    for label, shape, R_arg, kinds in cases:
        g, se, pf, lf, R = _soa_case(torch, **shape, R=R_arg, perturb=True)
        K, L = shape["K"], shape["L"]
        E_real = int(se.lm_start[L])
        bf = _lin_bytes_flops(K, R, L, E_real)
        print(f"-- SoA kernels [{label}]: K={K} L={L} R={R}, {E_real} real slots of {K * R}")
        timed = not label.startswith("ragged")
        record = label.startswith("engine")
        for kind in kinds:
            # K1 + K2 as the LM calls them: the chain's own outputs, then the linearization that folds them in
            lk, ck = kernels.fused_linearize(g.poses, g.landmarks, se, kind, 1.0)
            cp = soa.soa_chain_linearize(g.poses, se)
            lp = soa.soa_obs_linearize(g.poses, g.landmarks, se, cp, kind, 1.0)
            e2 = {n: _rel_err(torch, a, b) for n, a, b in zip(cp._fields, ck, cp)}
            e1 = {n: _rel_err(torch, getattr(lk, n), getattr(lp, n)) for n in LIN_FIELDS}
            for what, errs in (("chain (K2)", e2), ("linearization (K1)", e1)):
                worst = max(e[1] for e in errs.values())
                print(f"  fused_linearize (K1 + K2) [{kind}] {what}: max rel err {worst:.3g} (bound {LIN_RTOL:g}) "
                      + ", ".join(f"{n} {e[1]:.2g}" for n, e in errs.items()))
                require(worst <= LIN_RTOL, f"{label} {kind}: K1 + K2's {what} disagrees with its plain version: {errs}")
            # K1 alone on the plain chain blocks, so that its own error shows
            la = kernels.obs_linearize(g.poses, g.landmarks, se, cp, kind, 1.0)
            errs = {n: _rel_err(torch, getattr(la, n), getattr(lp, n)) for n in LIN_FIELDS}
            worst = max(e[1] for e in errs.values())
            print(f"  obs_linearize (K1 alone) [{kind}]: max rel err {worst:.3g} (bound {LIN_RTOL:g})")
            require(worst <= LIN_RTOL, f"{label} {kind}: K1 alone disagrees with its plain version: {errs}")
            # K3
            xk = kernels.resident_chi2(g.poses, g.landmarks, se, kind, 1.0)
            xp = soa.soa_chi2(g.poses, g.landmarks, se, kind, 1.0)
            e3 = _rel_err(torch, xk, xp)
            print(f"  resident_chi2 (K3) [{kind}]: kernel {float(xk):.7g}, plain {float(xp):.7g}, rel err "
                  f"{e3[1]:.3g} (bound {LIN_RTOL:g})")
            require(e3[1] <= LIN_RTOL, f"{label} {kind}: K3 disagrees with its plain version")
            if record and kind == "none":
                out["chain_linearize"] = {"max_abs_err": max(e[0] for e in e2.values())}
                out["obs_linearize"] = {"max_abs_err": max(e[0] for e in e1.values())}
                out["resident_chi2"] = {"max_abs_err": e3[0]}

        # K4 on the plain linearization at the LM's first damping
        lin = soa.soa_linearize(g.poses, g.landmarks, se)
        lam = _init_lambda(torch, lin)
        for tol in (1e-8, 0.0):
            dk, bk = kernels.resident_solve(lin, se, lam, pf, lf, 128, tol)
            dpl, bpl = soa.soa_schur_step(lin, se, lam, pf, lf, 128, tol)
            ed, eb = _norm_err(torch, dk, dpl), _norm_err(torch, bk, bpl)
            finite = bool(torch.isfinite(dk).all() and torch.isfinite(bk).all())
            print(f"  resident_solve (K4) [cg_tol={tol:g}, lam={float(lam):.4g}]: dp rel norm err {ed:.3g}, "
                  f"db {eb:.3g} (bound {SOLVE_RTOL:g}); |dp| {float(torch.linalg.norm(dpl)):.4g}")
            require(finite and ed <= SOLVE_RTOL and eb <= SOLVE_RTOL,
                    f"{label} cg_tol={tol}: K4 disagrees with its plain version")
            if record and tol == 0.0:
                out["resident_solve"] = {"max_abs_err": max(_rel_err(torch, dk, dpl)[0], _rel_err(torch, bk, bpl)[0])}

        if not timed:
            continue
        # times: CUDA events after warm-up; K4 at fixed work (cg_tol=0, 128 steps), not at the fixed-lag shape,
        # where check_soa_prior times it with the prior; K1 + K2, K1 alone and K3 there under each robust kernel.
        # K2 has no launch of its own: its device time is the pair's less K1 alone's, its event time the pair's
        # call (the host's share of a call swamps the difference of two calls), its plain time the chain's own
        cp = soa.soa_chain_linearize(g.poses, se)
        fixed_lag = shape is FL_ENGINE
        runs = [("chain plain", "", None, lambda: soa.soa_chain_linearize(g.poses, se))]
        for kind in kinds if fixed_lag else ("none",):
            runs += [
                ("resident_linearize", kind,
                 lambda kind=kind: kernels.resident_linearize(g.poses, g.landmarks, se, kind),
                 lambda kind=kind: soa.soa_linearize(g.poses, g.landmarks, se, kind)),
                ("obs_linearize", kind, lambda kind=kind: kernels.obs_linearize(g.poses, g.landmarks, se, cp, kind),
                 lambda kind=kind: soa.soa_obs_linearize(g.poses, g.landmarks, se, cp, kind)),
                ("resident_chi2", kind, lambda kind=kind: kernels.resident_chi2(g.poses, g.landmarks, se, kind),
                 lambda kind=kind: soa.soa_chi2(g.poses, g.landmarks, se, kind)),
            ]
        if not fixed_lag:
            runs.append(("resident_solve", "", lambda: kernels.resident_solve(lin, se, lam, pf, lf, 128, 0.0),
                         lambda: soa.soa_schur_step(lin, se, lam, pf, lf, 128, 0.0)))
        bf["resident_solve"] = _solve_bytes_flops(K, R, L, E_real, 128)
        bf["resident_linearize"] = tuple(a + b for a, b in zip(bf["obs_linearize"], bf["chain_linearize"]))
        times = {}
        for name, kind, kern, plain in runs:
            reps = 5 if name == "resident_solve" else 20
            plain_ms = _time_ms(torch, plain, reps)
            if kern is None:
                times[name] = {"plain_ms": plain_ms}
                continue
            ms, dev_ms = _time_ms(torch, kern, reps), _device_ms(torch, kern, name, reps)
            times[(name, kind)] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms}
            b = bound(*bf[name])
            print(f"  {name} [{label}{', ' + kind if kind else ''}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(CUDA events, mean of {reps}), kernel device time {dev_ms:.4f} ms (profiler); bound "
                  f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e6:.1f} Mflop)")
        for kind in kinds if fixed_lag else ("none",):
            pair, k1 = times[("resident_linearize", kind)], times[("obs_linearize", kind)]
            k2 = {"ms": pair["ms"], "device_ms": pair["device_ms"] - k1["device_ms"],
                  "plain_ms": times["chain plain"]["plain_ms"]}
            b = bound(*bf["chain_linearize"])
            print(f"  chain_linearize (K2 in K1's launches) [{label}, {kind}]: device time {k2['device_ms']:.4f} "
                  f"ms (the pair's less K1 alone's), the pair's call {k2['ms']:.4f} ms (CUDA events); plain "
                  f"{k2['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
            if record and kind == "none":
                out["chain_linearize"].update(**k2, pair_device_ms=pair["device_ms"], **b)
                out["obs_linearize"].update(**k1, **bound(*bf["obs_linearize"]))
                out["resident_chi2"].update(**times[("resident_chi2", kind)], **bound(*bf["resident_chi2"]))
        if record:
            out["resident_solve"].update(**times[("resident_solve", "")], **bound(*bf["resident_solve"]))
    return out


# ---------------------------------------------------------------------------
# 3c. K6-K10 against their plain versions; 4. the two halves
# ---------------------------------------------------------------------------


class RowRange:
    """Rows [off, off + Kl) of a graph: the pose channels of the rows and of
    their chain successors, and the rows' edge store."""

    def __init__(self, torch, g, R: int, off: int, Kl: int):
        from semantic_slam_tpu_torch.solver import chain_soa as chs
        from semantic_slam_tpu_torch.solver import soa_dist as sd
        from semantic_slam_tpu_torch.solver.pcg import _edge_args

        K, L = g.poses.shape[0], g.landmarks.shape[0]
        self.off, self.Kl, self.K = off, Kl, K
        pc = g.poses.T
        self.pc, self.pj = pc[:, off:off + Kl].contiguous(), chs.roll_up_pose_ch(pc)[:, off:off + Kl].contiguous()
        self.de = sd.build_dist_edges(_edge_args(g), K, R, L, off, Kl)

    def rows(self, x):
        return x[..., self.off:self.off + self.Kl].contiguous()


def _tiled_bytes_flops(K: int, R: int, L: int, E_real: int) -> dict:
    """Bytes and fp32 operations of each row-range kernel over K rows (4-byte
    words; each input read once, each output written once; the landmark
    passes' scratch is not counted). Operations as for K1-K3, and per real
    slot about 42 for the matvec's first half and 48 for its second, plus
    264 per row for the chain's four 6x6 products."""
    E = K * R
    return {
        "tiled_chain_linearize": (4 * (57 * K + 120 * K + 1), 3000 * K),
        "tiled_obs_linearize": (4 * (7 * K + 3 * L + 14 * E + L + 1 + 42 * K + 1 + 12 * E + 51 * K + 12 * L + 1),
                                230 * E_real + 80 * K),
        "tiled_mv_fwd": (4 * (13 * E + 15 * K + L + 1 + 3 * E + 3 * L), 42 * E_real),
        "tiled_mv_bwd": (4 * (16 * E + 3 * L + 129 * K + 12 * K), 48 * E_real + 264 * K),
        "tiled_chi2": (4 * (7 * K + 3 * L + 13 * E + 50 * K + 1), 50 * E_real + 520 * K),
    }


def check_tiled_kernels(torch) -> dict:
    """K6-K10 against their plain versions at the bench, engine, K=16384 and
    plane fixed-lag session (K=512, L=128, R=32) shapes, on the whole row
    range and on rows [0, K/2) and [K/2, K): K6 + K7
    as the loop calls them (the chain's own outputs and the linearization),
    K6 alone, K8, K9 and K10 (the whole objective, and the chain's sum alone
    with the observations' information zeroed), under robust
    none/huber/dcs; returns the engine
    shape's whole-range numbers per kernel (K7's device time the pair's less
    K6 alone's)."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    out = {}
    cases = (
        ("bench R=4", TILED_BENCH, None),
        (f"engine R={ENGINE_R}", TILED_BENCH, ENGINE_R),
        ("K=16384", TILED_LARGE, None),
        # the plane fixed-lag pcg session's shape: the row-range loop at Kl=512
        (f"plane fixed-lag K={FL_ENGINE['K']} R={ENGINE_R}", FL_ENGINE, ENGINE_R),
    )
    for label, shape, R_arg in cases:
        g, _, _, _, R = _soa_case(torch, **shape, R=R_arg, perturb=True)
        K, L = shape["K"], shape["L"]
        record = label.startswith("engine")
        x_full = torch.randn(6, K, generator=torch.Generator(device=DEVICE).manual_seed(2), device=DEVICE)
        xj_full = torch.cat([x_full[:, 1:], x_full[:, :1]], dim=1)
        # the lower half's last row meets the upper half's first pose (its successor from the host) with real
        # information; the whole range's last row wraps to pose 0
        for where, off, Kl in (("rows [0, K)", 0, K), ("rows [0, K/2)", 0, K // 2), ("rows [K/2, K)", K // 2, K // 2)):
            rr = RowRange(torch, g, R, off, Kl)
            E_real = int(rr.de.lm_start[L])
            print(f"-- row-range kernels [{label}, {where}]: K={K} L={L} R={R}, {E_real} real slots of {Kl * R}")
            errs = {}
            cp = sd.chain_plain(rr.pc, rr.pj, rr.de)
            for kind in ("none", "huber", "dcs"):
                # K6 + K7 as the loop calls them: the chain's own outputs, then the linearization that folds
                # their i-side in
                lk, ck = tk.tiled_fused_linearize(rr.pc, rr.pj, g.landmarks, rr.de, kind, 1.0)
                lp = sd.obs_plain(rr.pc, g.landmarks, rr.de, cp, kind, 1.0)
                e7 = {n: _rel_err(torch, a, b) for n, a, b in zip(cp._fields, ck, cp)}
                ep = {n: _rel_err(torch, a, b) for n, a, b in zip(lp._fields, lk, lp)}
                # K6 alone on the plain chain blocks, so that its own error shows; K10
                la = tk.tiled_obs_linearize(rr.pc, g.landmarks, rr.de, cp, kind, 1.0)
                e6 = {n: _rel_err(torch, a, b) for n, a, b in zip(lp._fields, la, lp)}
                xk = tk.tiled_chi2(rr.pc, rr.pj, g.landmarks, rr.de, kind, 1.0)
                e10 = {"chi2": _rel_err(torch, xk, sd.chi2_plain(rr.pc, rr.pj, g.landmarks, rr.de, kind, 1.0))}
                # the chain's sum alone (the observations' information zeroed): in the whole objective it is
                # ~1e-5 of the observations' terms, below the bound
                no_obs = rr.de._replace(info=torch.zeros_like(rr.de.info))
                e10["chain chi2"] = _rel_err(torch, tk.tiled_chi2(rr.pc, rr.pj, g.landmarks, no_obs, kind, 1.0),
                                             sd.chi2_plain(rr.pc, rr.pj, g.landmarks, no_obs, kind, 1.0))
                for what, e in (("tiled_fused_linearize (K6 + K7) chain (K7)", e7),
                                ("tiled_fused_linearize (K6 + K7) linearization", ep),
                                ("tiled_obs_linearize (K6 alone)", e6), ("tiled_chi2 (K10)", e10)):
                    worst = max(v[1] for v in e.values())
                    print(f"  [{kind}] {what}: max rel err {worst:.3g} (bound {LIN_RTOL:g}) "
                          + ", ".join(f"{n} {v[1]:.2g}" for n, v in e.items()))
                    require(worst <= LIN_RTOL, f"{label} {where} {kind}: {what} disagrees with its plain version: {e}")
                if kind == "none":
                    errs["tiled_chain_linearize"], errs["tiled_obs_linearize"], errs["tiled_chi2"] = e7, e6, e10
            # K8 and K9 on the same inputs: the plain linearization, a seeded
            # direction, z = (Hll + I)^-1 T and the plain Oa
            lp = sd.obs_plain(rr.pc, g.landmarks, rr.de, cp)
            x, xj = rr.rows(x_full), rr.rows(xj_full)
            Ok, Tk = tk.tiled_mv_fwd(lp, rr.de, x)
            Op, Tp = sd.mv_fwd_plain(lp, rr.de, x)
            errs["tiled_mv_fwd"] = {"Oa": _rel_err(torch, Ok, Op), "T": _rel_err(torch, Tk, Tp)}
            z = torch.linalg.solve(lp.Hll + torch.eye(3, device=DEVICE), Tp[..., None])[..., 0]
            uk, vk = tk.tiled_mv_bwd(lp, rr.de, Op, z, x, xj)
            up, vp = sd.mv_bwd_plain(lp, rr.de, Op, z, x, xj)
            errs["tiled_mv_bwd"] = {"u": _rel_err(torch, uk, up), "vj": _rel_err(torch, vk, vp)}
            for name in ("tiled_mv_fwd", "tiled_mv_bwd"):
                e = errs[name]
                print(f"  {name}: max rel err {max(v[1] for v in e.values()):.3g} (bound {LIN_RTOL:g}) "
                      + ", ".join(f"{n} {v[1]:.2g}" for n, v in e.items()))
                require(max(v[1] for v in e.values()) <= LIN_RTOL,
                        f"{label} {where}: {name} disagrees with its plain version: {e}")
            if not (record and Kl == K):
                continue
            # times at the session's shape, whole range: CUDA events after warm-up. K7 has no launch of its own:
            # its device time is the pair's less K6 alone's, its event time the pair's call, its plain time the
            # chain's own
            bf = _tiled_bytes_flops(K, R, L, E_real)
            bf["tiled_fused_linearize"] = tuple(a + b for a, b in zip(bf["tiled_obs_linearize"],
                                                                      bf["tiled_chain_linearize"]))
            fns = {
                "tiled_fused_linearize": (lambda: tk.tiled_fused_linearize(rr.pc, rr.pj, g.landmarks, rr.de),
                                          lambda: sd.PLAIN_OPS.linearize(rr.pc, rr.pj, g.landmarks, rr.de)),
                "tiled_obs_linearize": (lambda: tk.tiled_obs_linearize(rr.pc, g.landmarks, rr.de, cp),
                                        lambda: sd.obs_plain(rr.pc, g.landmarks, rr.de, cp)),
                "tiled_mv_fwd": (lambda: tk.tiled_mv_fwd(lp, rr.de, x), lambda: sd.mv_fwd_plain(lp, rr.de, x)),
                "tiled_mv_bwd": (lambda: tk.tiled_mv_bwd(lp, rr.de, Op, z, x, xj),
                                 lambda: sd.mv_bwd_plain(lp, rr.de, Op, z, x, xj)),
                "tiled_chi2": (lambda: tk.tiled_chi2(rr.pc, rr.pj, g.landmarks, rr.de),
                               lambda: sd.chi2_plain(rr.pc, rr.pj, g.landmarks, rr.de)),
            }
            times = {}
            for name, (kern, plain) in fns.items():
                ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
                dev_ms = _device_ms(torch, kern, name)
                times[name] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms}
                b = bound(*bf[name])
                print(f"  {name} [{label}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, mean of 20), "
                      f"kernel device time {dev_ms:.4f} ms (profiler); bound {b['bound_ms']:.4f} ms by "
                      f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e6:.1f} Mflop)")
                if name != "tiled_fused_linearize":
                    out[name] = {"max_abs_err": max(v[0] for v in errs[name].values()), **times[name], **b}
            pair, k6 = times["tiled_fused_linearize"], times["tiled_obs_linearize"]
            k7 = {"ms": pair["ms"], "device_ms": pair["device_ms"] - k6["device_ms"],
                  "plain_ms": _time_ms(torch, lambda: sd.chain_plain(rr.pc, rr.pj, rr.de)),
                  "pair_device_ms": pair["device_ms"]}
            b = bound(*bf["tiled_chain_linearize"])
            print(f"  tiled_chain_linearize (K7 in K6's launches) [{label}]: device time {k7['device_ms']:.4f} ms "
                  f"(the pair's less K6 alone's), the pair's call {k7['ms']:.4f} ms (CUDA events); plain "
                  f"{k7['plain_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
            out["tiled_chain_linearize"] = {"max_abs_err": max(v[0] for v in errs["tiled_chain_linearize"].values()),
                                            **k7, **b}
    return out


def check_two_halves(torch) -> None:
    """Rows [0, K/2) and [K/2, K) through the kernels at the bench shape:
    the landmark tables and chi2 summed, the per-row arrays embedded at
    their offsets and summed, the chain's j-side shifted after the sum, and
    K8 -> K9 with T summed between them, against the whole range."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk

    g, _, _, _, R = _soa_case(torch, **TILED_BENCH, perturb=True)
    K = TILED_BENCH["K"]
    rrs = [RowRange(torch, g, R, off, Kl) for off, Kl in ((0, K), (0, K // 2), (K // 2, K // 2))]
    lins = [tk.tiled_linearize(r.pc, r.pj, g.landmarks, r.de, "huber", 1.0) for r in rrs]

    def emb(t, r):
        return sd._dus(t, r.off, K)

    w, a, b = lins
    errs = {n: _rel_err(torch, getattr(a, n) + getattr(b, n), getattr(w, n)) for n in ("gl", "Hll", "chi2")}
    for n in ("gp", "gj", "diag", "Hjj"):
        errs[n] = _rel_err(torch, emb(getattr(a, n), rrs[1]) + emb(getattr(b, n), rrs[2]), getattr(w, n))
    errs["gp folded"] = _rel_err(
        torch, emb(a.gp, rrs[1]) + emb(b.gp, rrs[2]) + sd._shift_down_soa(emb(a.gj, rrs[1]) + emb(b.gj, rrs[2])),
        w.gp + sd._shift_down_soa(w.gj))
    x = torch.randn(6, K, generator=torch.Generator(device=DEVICE).manual_seed(3), device=DEVICE)
    xj = torch.cat([x[:, 1:], x[:, :1]], dim=1)
    fwd = [tk.tiled_mv_fwd(lin, r.de, r.rows(x)) for r, lin in zip(rrs, lins)]
    errs["T"] = _rel_err(torch, fwd[1][1] + fwd[2][1], fwd[0][1])
    z = torch.linalg.solve(w.Hll + torch.eye(3, device=DEVICE), fwd[0][1][..., None])[..., 0]
    u, vj = [], []
    for r, lin, (Oa, _) in zip(rrs, lins, fwd):
        ur, vr = tk.tiled_mv_bwd(lin, r.de, Oa, z, r.rows(x), r.rows(xj))
        u.append(emb(ur, r))
        vj.append(emb(vr, r))
    errs["u folded"] = _rel_err(torch, u[1] + u[2] + sd._shift_down_soa(vj[1] + vj[2]),
                                u[0] + sd._shift_down_soa(vj[0]))
    worst = max(e[1] for e in errs.values())
    print(f"two halves against the whole range (K={K}, R={R}): max rel err {worst:.3g} (bound {LIN_RTOL:g}) "
          + ", ".join(f"{n} {e[1]:.2g}" for n, e in errs.items()))
    require(worst <= LIN_RTOL, f"two halves disagree with the whole range: {errs}")


# ---------------------------------------------------------------------------
# 4. fixed-work LM
# ---------------------------------------------------------------------------


def _run_lm(torch, loop: str, g, R: int, ops, prior=None) -> tuple:
    """8 LM iterations of LM_STEPS CG steps on ``g`` (with a fixed-lag
    ``prior``, if given), through the resident loop or the row-range one;
    returns (iterations, chi2 initial, chi2 final, ms per LM iteration on the
    host clock, synced)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    K, L = g.poses.shape[0], g.landmarks.shape[0]
    pf, lf = _free_masks(g)
    build, run = ((soa.build_soa_edges, soa.run_lm_loop_soa) if loop == "resident" else
                  (sd.build_dist_edges, sd.run_lm_loop_soa_dist))
    edges = build(_edge_args(g), K, R, L)
    args = (edges, pf, lf) if loop == "resident" else (pf, lf, edges)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run(g.poses, g.landmarks, *args, 8, 0.0, LM_STEPS, cg_tol=0.0, ops=ops, prior=prior)[2]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return stats.iterations, float(stats.chi2_initial), float(stats.chi2_final), 1e3 * wall / max(stats.iterations, 1)


def check_fixed_lm(torch) -> None:
    """The resident LM at K=4096 and the row-range LM at K=8192, each through
    the kernels and through the plain versions; then both loops through the
    kernels on the K=4096 graph."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import soa_dist as sd

    res = {}
    for loop, shape, ops_of in (("resident", BENCH, {"kernels": soa.kernel_ops(), "plain": soa.PLAIN_OPS}),
                                ("tiled", TILED_BENCH, {"kernels": sd.kernel_ops(), "plain": sd.PLAIN_OPS})):
        g, _, _, _, R = _soa_case(torch, **shape)
        for name, ops in ops_of.items():
            it, c0, c1, ms = res[(loop, shape["K"], name)] = _run_lm(torch, loop, g, R, ops)
            print(f"fixed-work LM [{loop} loop, {name}] K={shape['K']} L={shape['L']} R={R}: {it} iterations x "
                  f"{LM_STEPS} CG steps, chi2 {c0:.7g} -> {c1:.7g}, {ms:.3f} ms per LM iteration (host clock, synced)")
            require(it == 8 and math.isfinite(c1) and c1 < c0, f"fixed-work LM [{loop} {name}] failed")
        kern, plain = res[(loop, shape["K"], "kernels")], res[(loop, shape["K"], "plain")]
        rel = abs(kern[2] - plain[2]) / abs(plain[2])
        print(f"fixed-work LM [{loop} loop]: final chi2 rel diff kernels/plain {rel:.3g} (bound {LM_RTOL:g})")
        require(rel <= LM_RTOL, f"fixed-work LM [{loop}]: kernels and plain disagree on the final chi2")
    g, _, _, _, R = _soa_case(torch, **BENCH)
    it, c0, c1, ms = _run_lm(torch, "tiled", g, R, sd.kernel_ops())
    resident = res[("resident", BENCH["K"], "kernels")]
    rel = abs(c1 - resident[2]) / abs(resident[2])
    print(f"fixed-work LM [tiled loop, kernels] K={BENCH['K']}: chi2 {c0:.7g} -> {c1:.7g}, {ms:.3f} ms per LM "
          f"iteration against the resident loop's {resident[3]:.3f}; final chi2 rel diff {rel:.3g} (bound {LM_RTOL:g})")
    require(it == 8 and rel <= LM_RTOL, "fixed-work LM: the row-range and resident loops disagree at K=4096")


# ---------------------------------------------------------------------------
# 5b. the fixed-lag prior: K4 with it, and the fixed-work LMs
# ---------------------------------------------------------------------------


def _prior_case(torch, K: int, L: int, E2: int, R: int | None = None):
    """The perturbed ``_soa_case`` graph with its first PRIOR_DROP keyframes
    marginalized (``fixed_lag.marginalize``, PB=8): (graph, edges, masks,
    prior, boundary poses)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import fixed_lag as fl
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g, _, _, _, R = _soa_case(torch, K, L, E2, R=R, perturb=True)
    g, prior, num_b = fl.marginalize(g, fl.empty_prior(L, device=DEVICE), PRIOR_DROP)
    pf, lf = _free_masks(g)
    return g, soa.build_soa_edges(_edge_args(g), K, R, L), pf, lf, prior, int(num_b), R


def _moved_prior(torch, prior, poses, num_live: int, seed: int = 5):
    """``prior`` with its boundary block replaced by a dense seeded SPD block
    over the free poses (3, num_live // 2, num_live - 2), slots 0-2, at the
    scale of the marginalized boundary block (the mean of its slot-0
    diagonal); ``p_ref`` there is ``poses``. The marginalized block sits on
    the window's first pose, which the gauge fixes, so it meets only masked
    directions in the matvec; this one moves the step at its poses by about
    its own size. The same construction as the tests' ``moved_prior``."""
    import numpy as np

    idx = (3, num_live // 2, num_live - 2)
    n, dt, dev = len(idx), prior.Hp.dtype, prior.Hp.device
    scale = prior.Hp[:6, :6].diagonal().mean()
    A = torch.as_tensor(np.random.default_rng(seed).normal(size=(6 * n, 6 * n)), dtype=dt, device=dev)
    Hp = torch.zeros_like(prior.Hp)
    Hp[: 6 * n, : 6 * n] = scale * (A @ A.T / (6 * n) + torch.eye(6 * n, dtype=dt, device=dev))
    p_idx = torch.zeros_like(prior.p_idx)
    p_idx[:n] = torch.tensor(idx, dtype=p_idx.dtype, device=dev)
    p_ref = prior.p_ref.clone()
    p_ref[:n] = poses[p_idx[:n].long()]
    return prior._replace(Hp=Hp, p_idx=p_idx, p_ref=p_ref, num_p=torch.tensor(n, dtype=prior.num_p.dtype, device=dev))


def check_soa_prior(torch) -> dict:
    """K4 with a fixed-lag prior against its plain version at the pcg
    session's shape (the grid shape) and the fixed-lag session's (the cluster
    shape); returns the fixed-lag shape's numbers."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels
    from semantic_slam_tpu_torch.solver.pcg import apply_prior_blocks

    out = {}
    for label, shape, want in ((f"pcg session K={BENCH['K']} R={ENGINE_R}", BENCH, "grid"),
                               (f"fixed-lag session K={FL_ENGINE['K']} R={ENGINE_R}", FL_ENGINE, "cluster")):
        g, se, pf, lf, prior, num_b, R = _prior_case(torch, **shape, R=ENGINE_R)
        K, L = shape["K"], shape["L"]
        E_real = int(se.lm_start[L])
        shapes = dict(kernels.resident_solve.shapes)
        print(f"-- K4 with a fixed-lag prior [{label}]: drop {PRIOR_DROP}, {num_b} boundary pose(s), PB="
              f"{prior.max_poses}, p_idx {prior.p_idx.tolist()}, {int(g.num_poses)} live poses, {E_real} real slots")
        require(num_b >= 1 and float(prior.Hl.abs().sum()) > 0, f"{label}: the marginalized prior is empty")
        moved = _moved_prior(torch, prior, g.poses, int(g.num_poses))
        for which, pr in (("marginalized", prior), ("moved onto free poses", moved)):
            lin = apply_prior_blocks(soa.soa_linearize(g.poses, g.landmarks, se), pr, g.poses, g.landmarks)
            lam = _init_lambda(torch, lin)
            args = (lin, se, lam, pf, lf, 128)
            for tol in (1e-8, 0.0):
                dk, bk = kernels.resident_solve(*args, tol, pr.Hp, pr.p_idx)
                dpl, bpl = soa.soa_schur_step(*args, tol, pr.Hp, pr.p_idx)
                d0, _ = soa.soa_schur_step(*args, tol)
                ed, eb = _norm_err(torch, dk, dpl), _norm_err(torch, bk, bpl)
                # at the prior's poses: the kernel's error beside the block's own effect on the step
                rows = pr.p_idx[: int(pr.num_p)].long()
                row_err = float(torch.linalg.norm((dk[rows] - dpl[rows]).double()))
                row_effect = float(torch.linalg.norm((d0[rows] - dpl[rows]).double()))
                effect = row_effect / max(float(torch.linalg.norm(dpl[rows].double())), 1e-30)
                finite = bool(torch.isfinite(dk).all() and torch.isfinite(bk).all())
                print(f"  resident_solve (K4) + prior [{which}, cg_tol={tol:g}]: dp rel norm err {ed:.3g}, db {eb:.3g} "
                      f"(bound {SOLVE_RTOL:g}); at the prior's poses the block moves dp by {effect:.3g} of its norm "
                      f"there and the kernel's error is {row_err / max(row_effect, 1e-30):.3g} of that move "
                      f"(bound {PRIOR_ROW_RTOL:g})")
                require(finite and ed <= SOLVE_RTOL and eb <= SOLVE_RTOL,
                        f"{label} {which} cg_tol={tol}: K4 with a prior disagrees with its plain version")
                if which.startswith("moved"):
                    require(effect > 1e-2, f"{label}: the moved prior block does not change the step at its poses")
                    require(row_err <= PRIOR_ROW_RTOL * row_effect,
                            f"{label} cg_tol={tol}: K4 misses the moved prior block's effect at its poses")
                    if shape is FL_ENGINE and tol == 0.0:
                        out["max_abs_err"] = max(_rel_err(torch, dk, dpl)[0], _rel_err(torch, bk, bpl)[0])
            if which != "marginalized":
                continue
            # times at fixed work (cg_tol=0, 128 steps): with the prior, without it, and the plain version;
            # device time also at 0 steps, for the time of one CG step
            ms = _time_ms(torch, lambda: kernels.resident_solve(*args, 0.0, pr.Hp, pr.p_idx), 5)
            ms0 = _time_ms(torch, lambda: kernels.resident_solve(*args, 0.0), 5)
            plain_ms = _time_ms(torch, lambda: soa.soa_schur_step(*args, 0.0, pr.Hp, pr.p_idx), 5)
            dev_ms = _device_ms(torch, lambda: kernels.resident_solve(*args, 0.0, pr.Hp, pr.p_idx), "resident_solve", 5)
            dev0_ms = _device_ms(torch, lambda: kernels.resident_solve(lin, se, lam, pf, lf, 0, 0.0, pr.Hp, pr.p_idx),
                                 "resident_solve", 5)
            step_us = (dev_ms - dev0_ms) / 128 * 1e3
            b = bound(*_solve_bytes_flops(K, R, L, E_real, 128, pr.max_poses))
            print(f"  resident_solve [{label}]: kernel with the prior {ms:.4f} ms, without {ms0:.4f} ms, plain with "
                  f"the prior {plain_ms:.4f} ms (CUDA events, mean of 5); kernel device time with the prior "
                  f"{dev_ms:.4f} ms at 128 steps, {dev0_ms:.4f} ms at 0, {step_us:.3f} us a CG step (profiler); "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, "
                  f"{b['flops'] / 1e6:.1f} Mflop)")
            if shape is FL_ENGINE:
                out.update(ms=ms, plain_ms=plain_ms, ms_without_prior=ms0, device_ms=dev_ms,
                           device_us_per_step=step_us, **b)
        took = {k: n - shapes[k] for k, n in kernels.resident_solve.shapes.items()}
        print(f"  resident_solve [{label}]: launches per shape {took}")
        require(took[want] > 0 and sum(took.values()) == took[want], f"{label}: K4 did not run in the {want} shape")
    return out


def check_fixed_lm_prior(torch) -> None:
    """The resident LM with the marginalized prior at K=4096 through the
    kernels and through the plain versions, and the row-range LM with the
    prior through its kernels against the resident one."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import soa_dist as sd

    g, _, _, _, prior, _, R = _prior_case(torch, **BENCH)
    res = {}
    for loop, name, ops in (("resident", "kernels", soa.kernel_ops()), ("resident", "plain", soa.PLAIN_OPS),
                            ("tiled", "kernels", sd.kernel_ops())):
        before = _wrappers()["resident_solve"].prior_launches
        it, c0, c1, ms = res[(loop, name)] = _run_lm(torch, loop, g, R, ops, prior)
        print(f"fixed-work LM with the prior [{loop} loop, {name}] K={BENCH['K']} R={R}: {it} iterations x "
              f"{LM_STEPS} CG steps, chi2 {c0:.7g} -> {c1:.7g}, {ms:.3f} ms per LM iteration (host clock, synced)")
        require(it == 8 and math.isfinite(c1) and c1 < c0, f"fixed-work LM with the prior [{loop} {name}] failed")
        if loop == "resident" and name == "kernels":
            require(_wrappers()["resident_solve"].prior_launches - before == it,
                    "fixed-work LM with the prior: K4 did not take the prior on every iteration")
    for other in (("resident", "plain"), ("tiled", "kernels")):
        rel = abs(res[other][2] - res[("resident", "kernels")][2]) / abs(res[other][2])
        print(f"fixed-work LM with the prior: final chi2 rel diff resident kernels / {' '.join(other)} {rel:.3g} "
              f"(bound {LM_RTOL:g})")
        require(rel <= LM_RTOL, f"fixed-work LM with the prior: resident kernels and {other} disagree")


# ---------------------------------------------------------------------------
# 5./6. the slices
# ---------------------------------------------------------------------------

RESIDENT = ("fused_linearize", "resident_chi2", "resident_solve")
PAIR = ("obs_linearize", "chain_linearize")  # K1 and K2, the kernels line's names of the pair
TILED = ("tiled_fused_linearize", "tiled_mv_fwd", "tiled_mv_bwd", "tiled_chi2")
TILED_PAIR = ("tiled_obs_linearize", "tiled_chain_linearize")  # K6 and K7, the kernels line's names of the pair
# K5-K10 run on each rank of phase 14's meshes: the kernels line gives their launches per rank there
MESH_KERNELS = ("score_hypotheses",) + TILED_PAIR + ("tiled_mv_fwd", "tiled_mv_bwd", "tiled_chi2")


def _wrappers():
    import importlib

    from semantic_slam_tpu_torch.utils.profiling import KERNEL_WRAPPERS

    return {name: getattr(importlib.import_module(mod), name) for name, mod in KERNEL_WRAPPERS}


def run_slice(torch, log, extra: list[str], label: str, must_optimize: bool = True, min_margs: int = 3,
              mesh=None) -> dict:
    """``cli run`` with ``extra`` on ``log`` through ``cli.run_from_args`` (the
    replay, then the shutdown work), the launch counters set to 0 just before
    it and read just after. Checks this run's own ticks (a resumed engine also
    holds its checkpoint's): chi2 finite and never rising, at least one
    optimizing tick unless ``must_optimize`` is False, the kernels' launches
    as the LM iterations imply, and under a fixed-lag window at least
    ``min_margs`` marginalizations in this run. With ``mesh`` (a mesh the
    flags' ``--devices`` name) every solve runs on its ranks: each rank's
    counters are set to 0 and read too, and checked (``rank_launches``)."""
    import numpy as np

    from semantic_slam_tpu_torch import cli
    from semantic_slam_tpu_torch.runtime import engine as engine_mod
    from semantic_slam_tpu_torch.runtime.engine import _is_det
    from semantic_slam_tpu_torch.solver import ellk_soa

    args = cli.build_parser().parse_args(
        ["run", "--log", "in-process", "--profile", "yolo_detector", "--device", DEVICE,
         "--compute-ate", "--out", os.path.join(OUT_DIR, label), *extra]
    )
    cfg = cli.make_config(args)
    cap = cfg.capacity
    print(f"[{label}] flags {extra}; capacities K={cap.max_keyframes} L={cap.max_landmarks} "
          f"E2={cap.max_landmark_edges} D={cap.max_detections_per_frame}; crop {cfg.segmentation.crop_height}x"
          f"{cfg.segmentation.crop_width}, S={cfg.segmentation.num_hypotheses}; solver {cfg.solver.linear_solver}")
    # a resumed engine's stats_history begins with the checkpoint's entries
    n_before = len(json.loads(str(np.load(args.resume)["meta"]))["stats_history"]) if args.resume else 0

    # each PCG loop's iterations per call, to check the launch counts against
    from semantic_slam_tpu_torch.solver import soa_dist

    # (the plane LM, lm_optimize_soa_planes, is the row-range loop with its
    # plane half: its iterations join the row-range entry's)
    calls = {"resident": [], "tiled": []}
    entries = {("resident", 1): (ellk_soa, "lm_optimize_soa"), ("tiled", 1): (soa_dist, "lm_optimize_soa_tiled"),
               ("tiled", 2): (soa_dist, "lm_optimize_soa_planes")}
    if mesh is not None:
        # every solve is a sharded one (a gated solve runs the single-device
        # entry's gate on the controller, inside the sharded entry)
        entries = {("tiled", 1): (soa_dist, "sharded_lm_optimize_soa"),
                   ("tiled", 2): (soa_dist, "sharded_lm_optimize_soa_planes")}
        from semantic_slam_tpu_torch.utils.profiling import mesh_kernel_launches

        mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
    origs = {key: getattr(mod, fn) for key, (mod, fn) in entries.items()}

    def recording(key):
        def call(*a, **kw):
            res = origs[key](*a, **kw)
            calls[key[0]].append(res[key[1]].iterations)
            return res

        return call

    # each marginalization's host time, synced on both sides (the engine
    # fetches its counts right after it anyway)
    from semantic_slam_tpu_torch.solver import fixed_lag

    marg_ms = []
    orig_margs = {fn: getattr(fixed_lag, fn) for fn in ("marginalize", "marginalize_planes")}

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig_margs[fn](*a, **kw)
            torch.cuda.synchronize()
            marg_ms.append(1e3 * (time.perf_counter() - t))
            return out

        return call

    # each window's rows (--ingest-window: a run of detection keyframes, one
    # frontend call)
    windows = []
    orig_window = engine_mod._process_keyframes_window

    def window(*a, **kw):
        windows.append(int(kw["odoms"].shape[0]))
        return orig_window(*a, **kw)

    wrappers = _wrappers()
    for key, (mod, fn) in entries.items():
        setattr(mod, fn, recording(key))
    for fn in orig_margs:
        setattr(fixed_lag, fn, timed(fn))
    engine_mod._process_keyframes_window = window
    try:
        for w in wrappers.values():
            w.launches = 0
        wrappers["resident_solve"].prior_launches = 0
        wrappers["resident_solve"].shapes = {"cluster": 0, "grid": 0}
        t0 = time.perf_counter()
        engine, summary = cli.run_from_args(args, log, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        prior_launches = wrappers["resident_solve"].prior_launches
        k4_shapes = dict(wrappers["resident_solve"].shapes)
    finally:
        for key, (mod, fn) in entries.items():
            setattr(mod, fn, origs[key])
        for fn, orig in orig_margs.items():
            setattr(fixed_lag, fn, orig)
        engine_mod._process_keyframes_window = orig_window
    rank_launches = [launches]
    if mesh is not None:
        rank_launches += mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)[1:]
    print(f"[{label}] summary:", json.dumps(summary))

    g, t = engine.graph, engine.table
    tensors = [getattr(g, f) for f in ("poses", "landmarks", "lme_k", "num_lme")] + [t.world, t.cov, engine.marginals]
    require(all(x.device.type == DEVICE for x in tensors), f"[{label}] graph/table state is not on the card")
    # a window's batch may double the capacities up front (the engine sizes
    # them for W keyframes' worst-case landmarks, as the JAX engine does)
    require(g.poses.shape[0] == cap.max_keyframes or (cfg.solver.ingest_window > 1 and g.poses.shape[0] > 0),
            f"[{label}] graph capacity {g.poses.shape[0]} != K")
    require(summary["keyframes"] > 0, f"[{label}] no keyframes")
    require(summary["landmarks"] > 0, f"[{label}] no landmarks mapped")
    own = engine.stats_history[n_before:]
    opt = [s for s in own if s["iterations"] > 0]
    require(len(opt) > 0 or not must_optimize, f"[{label}] no optimizing tick")
    for s in opt:
        require(math.isfinite(s["chi2_final"]) and s["chi2_final"] <= s["chi2_initial"],
                f"[{label}] LM tick went uphill or non-finite: {s}")
    require(math.isfinite(summary["ate_rmse_optimized"]), f"[{label}] ATE is not finite")
    poses = engine.get_keyframe_poses()
    require(poses.shape == (summary["keyframes"], 7) and bool((abs(poses) < 1e3).all()), f"[{label}] bad poses")
    window = cfg.solver.fixed_lag_window
    if window:
        print(f"[{label}] fixed-lag window {window}: {len(marg_ms)} marginalizations, _kf_base {engine._kf_base}, "
              f"{engine._n_poses} active + {len(engine.archived_poses)} archived poses = {len(poses)} keyframes; "
              f"ATE optimized {summary['ate_rmse_optimized']:.6g} m, raw VIO {summary['ate_rmse_vio']:.6g} m")
        chunk = max(8, window // 4)
        require(len(marg_ms) >= min_margs and engine._kf_base >= chunk * min_margs,
                f"[{label}] fewer than {min_margs} marginalizations")
        require(engine._n_poses < window + chunk,
                f"[{label}] {engine._n_poses} active poses: the window is not bounded")
        require(engine._n_poses + len(engine.archived_poses) == len(engine.keyframes) == len(poses),
                f"[{label}] archived + active poses do not cover the keyframes")
        require(summary["ate_rmse_optimized"] <= summary["ate_rmse_vio"], f"[{label}] ATE worse than raw VIO's")
    else:
        require(not marg_ms, f"[{label}] marginalized without a fixed-lag window")

    n_det_kf = sum(1 for kf in engine.keyframes if _is_det(kf))  # restored keyframes carry no cloud
    rounds = cfg.segmentation.max_planes_per_detection
    # a window (a run of detection keyframes) takes one frontend call, and
    # --viz-bag-detections re-runs the frontend (segment_keyframe) on every
    # detection keyframe
    calls_fe = n_det_kf - sum(windows) + len(windows)
    passes = 2 if args.viz_bag_detections else 1
    want_k5 = rounds * (calls_fe + (passes - 1) * n_det_kf)
    print(f"[{label}] launches: {launches}; score_hypotheses expected {rounds} extraction rounds x ({calls_fe} "
          f"frontend calls for {n_det_kf} detection keyframes, {len(windows)} of them windows of {windows} rows"
          f" + {passes - 1} x {n_det_kf} re-runs) = {want_k5}")
    require(launches["score_hypotheses"] > 0 and launches["score_hypotheses"] == want_k5,
            f"[{label}] K5 launches do not match the extraction rounds")
    iters = [s["iterations"] for s in own]
    loop = None
    planes = cfg.use_plane_landmarks
    if cfg.solver.linear_solver == "pcg":
        # plane landmarks take the row-range loop at every K
        loop = "tiled" if mesh is not None or planes or cap.max_keyframes > soa_dist.TILED_FROM_K else "resident"
        other = "resident" if loop == "tiled" else "tiled"
        ran = [it for it in calls[loop] if it > 0]
        skipped = sum(1 for it in calls[loop] if it == 0)
        require(not calls[other] and ran == [it for it in iters if it > 0],
                f"[{label}] LM calls {calls} do not match the ticks {iters} on the {loop} loop")
        tridiag = cfg.solver.pcg_precond == "tridiag"
        if loop == "resident":
            expect = {
                "fused_linearize": sum(it + 2 for it in ran),
                "obs_linearize": 0,
                # the tridiag preconditioner's solve is plain PyTorch (K4 has none)
                "resident_solve": 0 if tridiag else sum(ran),
                "resident_chi2": sum(ran) + skipped,
                "tiled_obs_linearize": 0,
                **{name: 0 for name in TILED},
            }
            formula = (f"K1 + K2 = sum(it + 2) over solves, K1 alone = 0, K4 = {'0 (tridiag)' if tridiag else 'sum(it)'}"
                       ", K3 = sum(it) + skipped solves, K6-K10 (K6 + K7 one call, K6 alone) = 0")
        else:
            steps = cfg.solver.pcg_iters
            if tridiag:
                # the tridiagonal CG stops at its tolerance, checked every
                # TRIDIAG_CHECK_EVERY steps: K8/K9 launch (steps run + 1) times
                # an iteration, the steps run a multiple of the check
                every = ellk_soa.TRIDIAG_CHECK_EVERY
                n8 = launches["tiled_mv_fwd"]
                require(n8 == launches["tiled_mv_bwd"] and (n8 - sum(ran)) % every == 0
                        and sum(ran) <= n8 <= sum(it * (steps + 1) for it in ran),
                        f"[{label}] K8/K9 launches {n8} / {launches['tiled_mv_bwd']} do not match "
                        f"{sum(ran)} LM iterations of up to {steps} CG steps, a multiple of {every}")
                steps = (n8 - sum(ran)) // max(sum(ran), 1)  # the mean, printed
            # the marginals' final linearization: K1 + K2 over all rows on one
            # device; on a mesh K6 + K7 over each rank's rows
            margs = len(ran) if cfg.association.use_maha_dist else 0
            expect = {
                "tiled_fused_linearize": sum(ran) + (margs if mesh is not None else 0),
                "tiled_obs_linearize": 0,
                "tiled_mv_fwd": launches["tiled_mv_fwd"] if tridiag else sum(it * (steps + 1) for it in ran),
                "tiled_mv_bwd": launches["tiled_mv_bwd"] if tridiag else sum(it * (steps + 1) for it in ran),
                "tiled_chi2": sum(ran) + skipped,
                "fused_linearize": 0 if mesh is not None else margs,
                "obs_linearize": 0,
                "resident_solve": 0,
                "resident_chi2": 0,
            }
            formula = (f"K6 + K7 = sum(it) over solves (one call of two launches each)"
                       f"{' + one marginals linearization per solve on each rank' if mesh is not None else ''}, "
                       f"K6 alone = 0, K8/K9 = "
                       f"sum(it x ({'~' + str(steps) + ' CG steps run (tridiag, to tolerance)' if tridiag else steps} "
                       "CG steps + 1)), "
                       "K10 = sum(it) + skipped solves, K1 + K2 = "
                       f"{'0' if mesh is not None else 'one marginals linearization per solve'}, K1 alone, K3, K4 = 0")
        print(f"[{label}] {loop} LM calls (iterations): {calls[loop]}; expected launches: {formula} = {expect}")
        for name, n in expect.items():
            require(launches[name] == n, f"[{label}] {name}: {launches[name]} launches, expected {n}")
        want_prior = launches["resident_solve"] if window else 0
        print(f"[{label}] K4 launches with the fixed-lag prior: {prior_launches} (expected {want_prior}); K4 "
              f"launches per shape {k4_shapes}")
        require(prior_launches == want_prior, f"[{label}] K4 took the prior on {prior_launches} launches, "
                                              f"expected {want_prior}")
        if mesh is not None:
            # a worker runs every solve the controller does not gate, and no
            # frontend: K10 without the gated solves' calls, no K5
            want_w = dict(expect, tiled_chi2=sum(ran), score_hypotheses=0)
            print(f"[{label}] each worker rank's launches {rank_launches[1:]}; expected {want_w}")
            for r, got in enumerate(rank_launches[1:], start=1):
                for name, n in want_w.items():
                    require(got[name] == n, f"[{label}] rank {r}: {name} {got[name]} launches, expected {n}")
        on_path = RESIDENT if loop == "resident" else TILED + (() if mesh is not None else ("fused_linearize",))
        for name in [n for n in on_path if not (tridiag and n == "resident_solve")] if ran else ():
            require(launches[name] > 0, f"[{label}] {name} was launched no time on its path")
    else:
        require(not calls["resident"] and not calls["tiled"]
                and all(launches[n] == 0 for n in RESIDENT + TILED + ("tiled_obs_linearize",)),
                f"[{label}] the dense path ran SoA kernels: {launches}")

    tick_ms = [1e3 * s["solve_seconds"] for s in own]

    def steady_median(ticks):
        """Median after the first tick, which carries lazy CUDA / cuBLAS /
        cuSOLVER set-up."""
        rest = ticks[1:] or ticks
        return f"{statistics.median(rest):.2f} (n={len(rest)})" if rest else "none"

    opt_ms = [x for x, it in zip(tick_ms, iters) if it > 0]
    print(f"[{label}] ticks: {len(tick_ms)}; ms per tick (host clock, ends in the info fetch): "
          f"all = {[round(x, 2) for x in tick_ms]}")
    print(f"[{label}] median ms per tick after the first of its kind: frontend-only "
          f"{steady_median([x for x, it in zip(tick_ms, iters) if it == 0])}, optimizing {steady_median(opt_ms)}")
    print(f"[{label}] LM iterations per tick: {iters}; session wall (replay and shutdown work) {wall:.2f} s; "
          f"optimizing-tick ms per LM iteration {sum(opt_ms) / max(sum(iters), 1):.3f}")
    if window:
        print(f"[{label}] median optimizing tick ms over the first 30 {statistics.median(opt_ms[:30]):.2f} and the "
              f"last 30 {statistics.median(opt_ms[-30:]):.2f} (of {len(opt_ms)}); ms per marginalization "
              f"{[round(x, 2) for x in marg_ms]}, median {statistics.median(marg_ms):.2f}")
    return {"launches": launches, "rank_launches": rank_launches, "poses": poses,
            "summary": summary, "keyframes": len(engine.keyframes), "loop": loop,
            "k4_shapes": k4_shapes, "engine": engine, "out": args.out, "iterations": iters, "marg_ms": marg_ms,
            "windows": windows, "wall_s": wall, "tick_ms": tick_ms,
            "opt_ms_per_iteration": sum(opt_ms) / max(sum(iters), 1),
            "median_opt_ms": statistics.median(opt_ms[1:] or opt_ms) if opt_ms else float("nan")}


# ---------------------------------------------------------------------------
# 10. the session lifecycle
# ---------------------------------------------------------------------------


def _split_log(log, frac: float = 0.5):
    """The log's two parts at the odometry stamp a share ``frac`` of the way
    in (0.5: the middle, the split of ``tests/test_components.py``)."""
    import dataclasses

    t_split = log.odom[int(len(log.odom) * frac)].t

    def part(keep):
        return dataclasses.replace(log, **{f: [e for e in getattr(log, f) if keep(e.t)]
                                           for f in ("odom", "clouds", "depths", "detections", "gt")})

    return part(lambda t: t < t_split), part(lambda t: t >= t_split)


def _check_checkpoint(torch, ckpt: str, src, label: str) -> int:
    """The checkpoint ``ckpt`` of the engine ``src``, loaded into a fresh
    engine on the card: every tensor bit for bit (graph, table, plane nodes
    of a plane-landmark session, fixed-lag prior, marginals) and the host
    state (keyframes without clouds, archived poses, ``_kf_base``). Returns
    the number of tensors compared."""
    import numpy as np

    from semantic_slam_tpu_torch.io.checkpoint import load_checkpoint
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    fresh = SlamEngine(src.cfg, device=DEVICE)
    load_checkpoint(ckpt, fresh)
    pairs = [(f"graph.{f}", getattr(fresh.graph, f), getattr(src.graph, f)) for f in fresh.graph.__dataclass_fields__]
    pairs += [(f"table.{f}", getattr(fresh.table, f), getattr(src.table, f)) for f in fresh.table.__dataclass_fields__]
    pairs += [(f"prior.{f}", getattr(fresh.prior, f), getattr(src.prior, f)) for f in fresh.prior._fields]
    if src.plane_nodes is not None:
        pairs += [(f"plane_nodes.{f}", getattr(fresh.plane_nodes, f), getattr(src.plane_nodes, f))
                  for f in src.plane_nodes.__dataclass_fields__]
    pairs.append(("marginals", fresh.marginals, src.marginals))
    for name, a, b in pairs:
        require(a.device.type == DEVICE and a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b)),
                f"[{label}] checkpoint round trip on the card: {name} differs")
    require(np.array_equal(fresh.get_keyframe_poses(), src.get_keyframe_poses())
            and fresh._n_poses == src._n_poses and len(fresh.keyframes) == len(src.keyframes)
            and fresh._kf_base == src._kf_base and len(fresh.archived_poses) == len(src.archived_poses)
            and all(k.cloud is None for k in fresh.keyframes), f"[{label}] checkpoint round trip: host state differs")
    print(f"[{label}] checkpoint round trip on the card bit for bit ({len(pairs)} tensors; {src._n_poses} active + "
          f"{len(src.archived_poses)} archived poses, prior num_p {int(src.prior.num_p)})")
    return len(pairs)


def _resumed_against_unbroken(resumed: dict, whole: dict, later_log, label: str) -> None:
    """Prints, without asserting a value, the resumed session's counts, ATE
    and median optimizing tick beside the unbroken one's: sensor data pending
    at the split is not checkpointed, so the two may differ. ATE over the
    later part's ground truth for both (the resumed summary's covers only
    that part)."""
    import numpy as np

    from semantic_slam_tpu_torch.eval import ate as ate_mod

    gt_t = np.array([e.t for e in later_log.gt])
    gt_xyz = np.stack([e.pose7[:3] for e in later_log.gt])
    kf = {name: (np.array([k.stamp for k in r["engine"].keyframes]), r["engine"].get_keyframe_poses())
          for name, r in (("resumed", resumed), ("unbroken", whole))}
    ate2 = {name: ate_mod.ate_rmse(t, p[:, :3], gt_t, gt_xyz, align=False) for name, (t, p) in kf.items()}
    same_stamps = np.array_equal(kf["resumed"][0], kf["unbroken"][0])
    dpos = (float(np.linalg.norm(kf["resumed"][1][:, :3] - kf["unbroken"][1][:, :3], axis=1).max())
            if same_stamps else float("nan"))
    print(f"{label}: resumed against unbroken: " + ", ".join(
        f"{k} {resumed['summary'][k]} / {whole['summary'][k]}" for k in ("keyframes", "landmarks", "edges"))
          + f"; ATE over the later part's ground truth {ate2['resumed']:.6g} / {ate2['unbroken']:.6g} m; "
          f"keyframe stamps equal: {same_stamps}, largest keyframe position gap {dpos:.6g} m; median optimizing "
          f"tick {resumed['median_opt_ms']:.2f} / {whole['median_opt_ms']:.2f} ms")


def _check_g2o(torch, path: str, src, label: str) -> dict:
    """The .g2o file ``path`` that the engine ``src`` saved, read back on the
    card: the graph's active rows, and a plane-landmark session's plane
    nodes and plane edges, equal to the engine's (as f64 of its values).
    Returns the counts."""
    from semantic_slam_tpu_torch.io.g2o_io import load_g2o

    planes = src.plane_nodes is not None and src.cfg.use_plane_landmarks
    loaded = load_g2o(path, with_planes=planes, device=DEVICE)
    g2, pn2 = loaded if planes else (loaded, None)
    g = src.graph
    counts = {f: int(getattr(g, f)) for f in ("num_poses", "num_landmarks", "num_odom", "num_lme")}
    rows = [(g2, g, f, n) for f, n in (
        ("poses", "num_poses"), ("landmarks", "num_landmarks"), ("odom_i", "num_odom"), ("odom_j", "num_odom"),
        ("odom_meas", "num_odom"), ("odom_info", "num_odom"), ("lme_k", "num_lme"), ("lme_l", "num_lme"),
        ("lme_meas", "num_lme"), ("lme_info", "num_lme"))]
    if planes:
        pn = src.plane_nodes
        counts.update({f: int(getattr(pn, f)) for f in ("num_planes", "num_pe")})
        rows += [(pn2, pn, f, n) for f, n in (("planes", "num_planes"), ("pe_k", "num_pe"), ("pe_p", "num_pe"),
                                              ("pe_meas", "num_pe"), ("pe_info", "num_pe"))]
    require(all(int(getattr(pn2 if f in ("num_planes", "num_pe") else g2, f)) == n for f, n in counts.items()),
            f"[{label}] g2o read back: counts differ")
    for new, old, f, n in rows:
        a, b = getattr(new, f)[: counts[n]], getattr(old, f)[: counts[n]]
        require(bool(torch.equal(a, b.to(a.dtype))), f"[{label}] g2o read back: {f} differs from the saved rows")
    print(f"[{label}] .g2o read back equal ({counts})")
    return counts


def check_lifecycle(torch, log) -> dict:
    """The session lifecycle on the card, at the profile's own capacities
    (K=512: the resident loop, K4 in its cluster shape): the log split at its
    middle odometry stamp, its first half run with --checkpoint --save-graph
    --dump-keyframes and its second half resumed from that checkpoint, beside
    the whole log unbroken (with --checkpoint); the checkpoint and the .g2o
    read back on the card; a --robust dcs --optimize-every 3 session; and
    ``cli merge`` of the first half's checkpoint with the unbroken
    session's."""
    import numpy as np

    from semantic_slam_tpu_torch import cli

    t0 = time.perf_counter()
    first_log, second_log = _split_log(log)
    pcg = ["--solver", "pcg"]
    # the first half ends below the optimize gate (10 edges): K3 and K5 only
    first = run_slice(torch, first_log, pcg + ["--checkpoint", "--save-graph", "--dump-keyframes"], "life_first",
                      must_optimize=False)
    ckpt = os.path.join(first["out"], "checkpoint.npz")
    resumed = run_slice(torch, second_log, pcg + ["--resume", ckpt], "life_resumed")
    whole = run_slice(torch, log, pcg + ["--checkpoint"], "life_unbroken")
    for r in (first, resumed, whole):
        require(r["engine"].graph.max_poses == FL_ENGINE["K"] and r["k4_shapes"]["grid"] == 0,
                f"lifecycle: a session left K=512 or K4's cluster shape: {r['k4_shapes']}")
    n1 = first["summary"]["keyframes"]
    require(resumed["summary"]["keyframes"] > n1 > 0, "the resumed session lost or added no keyframes")
    _resumed_against_unbroken(resumed, whole, second_log, "lifecycle")
    ckpt_bytes = os.path.getsize(ckpt)
    print(f"lifecycle: checkpoint at K={first['engine'].graph.max_poses} ({n1} keyframes): {ckpt_bytes} bytes, "
          "compressed npz")

    n_tensors = _check_checkpoint(torch, ckpt, first["engine"], "life_first")
    _check_g2o(torch, os.path.join(first["out"], "semantic_graph.g2o"), first["engine"], "life_first")
    n_dumps = len(os.listdir(os.path.join(first["out"], "keyframes")))
    require(n_dumps == n1, f"{n_dumps} keyframe dumps for {n1} keyframes")
    print(f"lifecycle: {n_dumps} keyframe dumps")

    flags = run_slice(torch, log, pcg + ["--robust", "dcs", "--optimize-every", "3"], "life_flags")
    eng = flags["engine"]
    last = eng.stats_history[-1]
    require(len(eng.stats_history) == eng._ticks_done + 1 and last["iterations"] > 0
            and math.isfinite(last["chi2_final"]), f"--optimize-every 3: the last entry is not a finalize pass: {last}")
    require(any(s["iterations"] == 0 for s in eng.stats_history), "--optimize-every 3 skipped no tick")

    merge_out = os.path.join(OUT_DIR, "life_merge")
    merged = cli.cmd_merge(cli.build_parser().parse_args(
        ["merge", ckpt, os.path.join(whole["out"], "checkpoint.npz"), "--out", merge_out, "--profile",
         "yolo_detector", "--device", DEVICE]))
    require(merged["chi2_final"] <= merged["chi2_initial"] and math.isfinite(merged["chi2_final"]),
            f"merge: chi2 rose or is not finite: {merged}")
    require(merged["landmarks"] <= sum(merged["landmarks_per_session"]), f"merge: too many landmarks: {merged}")
    require(merged["poses"] == n1 + whole["summary"]["keyframes"], f"merge: poses {merged['poses']}")
    wall = time.perf_counter() - t0
    print(f"lifecycle: phase wall {wall:.2f} s")
    return {"wall_s": wall, "checkpoint_bytes": ckpt_bytes, "tensors": n_tensors,
            "checkpoints": (ckpt, os.path.join(whole["out"], "checkpoint.npz"))}


# ---------------------------------------------------------------------------
# 10b. the ROS surface
# ---------------------------------------------------------------------------

ROS_SOLVER = ["--solver", "pcg", "--max-keyframes", "4096"]  # the pcg slice's
ROS_OUTPUTS = ["--voxel", "--carve", "--viz-bag-detections"]
VOXEL_DIFF_SHARE = 1e-3  # card map against a CPU rebuild: voxels whose hits differ, share of occupied ones
ATE_RTOL = 1e-2  # a bag session's ATE against the pcg slice's


def _maps_equal(torch, a, b) -> bool:
    return list(a.chunks) == list(b.chunks) and all(
        torch.equal(a.chunks[cc].hits, g.hits) and torch.equal(a.chunks[cc].misses, g.misses)
        for cc, g in b.chunks.items())


def check_ros_surface(torch, log, pcg: dict) -> dict:
    """The ROS surface on the card, on the dense slice's log (640x480): the
    log written as a rosbag and read back, that read-back log written as a
    ``.slog`` (so both files hold the same inputs), ``baginfo``; then ``cli
    run`` from each file with ``--solver pcg --max-keyframes 4096 --voxel
    --carve --viz-bag-detections``, beside the read-back log in memory
    (``ros_mem``, what an ``.npz`` of it replays) with ``--solver pcg
    --max-keyframes 4096``. Each file's session: ``ros_mem``'s keyframe,
    landmark and edge counts and ATE within 1%; the pcg slice's keyframes and
    ATE within 1% (its counts printed beside: the bag's boxes are whole
    pixels, the log's are not); K1-K5 launched as its LM
    iterations and detection keyframes imply (K5 again for each detection
    keyframe the viz bag re-runs); viz.bag read back with the topic counts
    ``write_viz_bag`` returned. The two sessions' voxel maps: equal voxel for
    voxel where their poses are bit for bit equal (else within the CPU
    rebuild's share); the .slog session's clouds, read after its reader
    closed, at the .bag session's poses give the .bag session's map. The
    card's map against a CPU rebuild of its hits (every keyframe) and of
    one keyframe's carving: at most 0.1% of the occupied voxels differ; its
    hits are its valid points inside its chunks. Prints the voxel ms per
    keyframe with and without carving, the bag and .slog MB/s, and the
    phase's wall time."""
    t_phase = time.perf_counter()
    d = os.path.join(OUT_DIR, "ros")
    os.makedirs(d, exist_ok=True)
    bag, slog = os.path.join(d, "dense.bag"), os.path.join(d, "dense.slog")
    H, W = log.clouds[0].points.shape[:2]
    try:
        return _ros_sessions(torch, log, pcg, bag, slog, H, W, t_phase)
    finally:
        for f in (bag, slog):
            if os.path.exists(f):
                os.remove(f)


def _ros_sessions(torch, log, pcg: dict, bag: str, slog: str, H: int, W: int, t_phase: float) -> dict:
    """``check_ros_surface``'s body; the caller deletes the two log files."""
    import numpy as np

    from semantic_slam_tpu_torch import cli, native
    from semantic_slam_tpu_torch.io import rosbag, rosbag_write
    from semantic_slam_tpu_torch.mapping import voxel as vox

    rates = {}

    def timed(name, fn, path):
        t0 = time.perf_counter()
        out = fn()
        sec = time.perf_counter() - t0
        rates[name] = (os.path.getsize(path) / 1e6, sec)
        print(f"ros: {name} {os.path.getsize(path) / 1e6:.1f} MB in {sec:.2f} s = "
              f"{os.path.getsize(path) / 1e6 / sec:.1f} MB/s (host)")
        return out

    timed("bag write", lambda: rosbag_write.write_bag(bag, log), bag)
    blog = timed("bag read", lambda: rosbag.read_bag(bag), bag)
    require(len(blog.clouds) == len(log.clouds) and len(blog.odom) == len(log.odom)
            and len(blog.detections) == len(log.detections), "the bag read back other counts than the log")
    require(sum(int(np.isnan(c.points).any()) for c in blog.clouds) > 0, "the bag's clouds carry no NaN")
    timed("slog write", lambda: native.write_slog(slog, blog, height=H, width=W), slog)
    timed("slog read", lambda: sum(1 for _ in _slog_clouds(native, slog)), slog)
    print("ros: baginfo")
    cli.main(["baginfo", bag])
    mem = run_slice(torch, blog, ROS_SOLVER, "ros_mem")
    del mem["engine"]

    grids, vox_ms, vox_mb = {}, {}, {}
    orig = cli.build_voxel_map

    def recording(engine, carve=False):
        """``build_voxel_map``, synced and timed, with its peak device memory
        above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        g = orig(engine, carve)
        torch.cuda.synchronize()
        vox_ms[carve] = 1e3 * (time.perf_counter() - t0)
        vox_mb[carve] = (torch.cuda.max_memory_allocated() - base) / 1e6
        grids["last"] = g
        return g

    runs = {}
    cli.build_voxel_map = recording
    try:
        for fmt, path in (("bag", bag), ("slog", slog)):
            r = run_slice(torch, cli.load_replay_log(path), ROS_SOLVER + ROS_OUTPUTS, f"ros_{fmt}")
            r["grid"] = grids.pop("last")
            r["voxel_ms"] = vox_ms.pop(True)
            runs[fmt] = r
    finally:
        cli.build_voxel_map = orig

    for fmt, r in runs.items():
        s = r["summary"]
        for ref, label, keys in ((mem["summary"], "ros_mem", ("keyframes", "landmarks", "edges")),
                                 (pcg["summary"], "the pcg slice", ("keyframes",))):
            for k in keys:
                require(s[k] == ref[k], f"ros_{fmt}: {k} {s[k]} != {label}'s {ref[k]}")
            require(abs(s["ate_rmse_optimized"] - ref["ate_rmse_optimized"]) <= ATE_RTOL * ref["ate_rmse_optimized"],
                    f"ros_{fmt}: ATE {s['ate_rmse_optimized']} not within 1% of {label}'s {ref['ate_rmse_optimized']}")
        info = {t: n for t, (_, n) in rosbag.bag_info(os.path.join(r["out"], "viz.bag")).items()}
        require(info == s["viz_bag"], f"ros_{fmt}: viz.bag holds {info}, write_viz_bag returned {s['viz_bag']}")
        require(s["viz_bag"].get("/detected_landmarks", 0) >= 1 and s["viz_bag"].get("/occupancy") == 1,
                f"ros_{fmt}: viz.bag lacks detections or occupancy: {s['viz_bag']}")
        require(os.path.getsize(os.path.join(r["out"], "occupancy.ply")) > 0, f"ros_{fmt}: no occupancy.ply")
        print(f"ros_{fmt}: keyframes / landmarks / edges {s['keyframes']} / {s['landmarks']} / {s['edges']}, ATE "
              f"{s['ate_rmse_optimized']:.6g} m; ros_mem {mem['summary']['landmarks']} landmarks, "
              f"{mem['summary']['edges']} edges, ATE {mem['summary']['ate_rmse_optimized']:.6g}; the pcg slice "
              f"{pcg['summary']['landmarks']} / {pcg['summary']['edges']}, ATE "
              f"{pcg['summary']['ate_rmse_optimized']:.6g}; viz.bag {s['viz_bag']}")

    eb, es = runs["bag"]["engine"], runs["slog"]["engine"]
    gb, gs = runs["bag"]["grid"], runs["slog"]["grid"]
    pose_diff = float(np.abs(eb.get_keyframe_poses() - es.get_keyframe_poses()).max())
    # the .slog session's clouds (read after its reader closed) at the .bag session's poses
    cross = vox.ChunkedVoxelMap(carve=True, strict_frames=eb.cfg.strict_reference_frames, dtype=eb.dtype)
    for kb, ks in zip(eb.keyframes, es.keyframes):
        pts, valid = cli.voxel_inputs(es, ks)[:2]
        cross.insert_keyframe_cloud(pts, valid, *cli.voxel_inputs(eb, kb)[2:])
    require(_maps_equal(torch, cross, gb), "ros: the .slog clouds at the .bag poses map otherwise than the .bag")

    # the card's map against a CPU rebuild of its hits, and of the first keyframe's carving
    occupied = sum(int((g.hits >= 2).sum()) for g in gb.chunks.values())
    cpu_map = vox.ChunkedVoxelMap(strict_frames=eb.cfg.strict_reference_frames, dtype=eb.dtype)
    inside = 0  # valid points inside the card's chunks, counted by masks
    t0 = time.perf_counter()
    for kf in eb.keyframes:
        pts, valid, xyzrpy, cam = cli.voxel_inputs(eb, kf)
        cpu_map.insert_keyframe_cloud(pts.cpu(), valid.cpu(), xyzrpy.cpu(), cam.cpu())
        w, v = vox._world_points_aabb(pts, valid, xyzrpy, cam)[:2]
        for g in gb.chunks.values():
            idx = vox._indices(g, torch.where(v[:, None], w, g.origin).unbind(-1))
            inside += int((vox._in_bounds(g, idx) & v).sum())
    cpu_s = time.perf_counter() - t0
    differ = sum(int((gb.chunks[cc].hits.cpu() != g.hits).sum()) for cc, g in cpu_map.chunks.items())
    differ += sum(int(gb.chunks[cc].hits.sum() > 0) for cc in gb.chunks if cc not in cpu_map.chunks)
    maps_differ = -1  # other chunks
    if list(gs.chunks) == list(gb.chunks):
        maps_differ = sum(int((gb.chunks[cc].hits != g.hits).sum() + (gb.chunks[cc].misses != g.misses).sum())
                          for cc, g in gs.chunks.items())
    print(f"ros: voxel maps: {len(gb.chunks)} chunks, {occupied} occupied voxels, {gb.total_hits()} hits "
          f"({inside} valid points inside the chunks); the CPU rebuild's hits differ in {differ} voxels "
          f"({cpu_s:.1f} s on the host); .slog against .bag session: max pose difference {pose_diff:.3g}, "
          f"{maps_differ} voxels differ")
    require(occupied > 0 and differ <= VOXEL_DIFF_SHARE * occupied,
            f"ros: {differ} voxels differ from the CPU rebuild ({occupied} occupied)")
    require(gb.total_hits() == inside, f"ros: {gb.total_hits()} hits for {inside} valid points inside the chunks")
    if pose_diff == 0.0:
        require(maps_differ == 0, f"ros: the .slog and .bag sessions' maps differ ({maps_differ}) at equal poses")
    else:
        require(0 <= maps_differ <= VOXEL_DIFF_SHARE * occupied,
                f"ros: the .slog and .bag sessions' maps differ in {maps_differ} voxels")
    kf0 = next(kf for kf in eb.keyframes if kf.cloud is not None)
    one_card = vox.ChunkedVoxelMap(carve=True, strict_frames=eb.cfg.strict_reference_frames, dtype=eb.dtype)
    one_cpu = vox.ChunkedVoxelMap(carve=True, strict_frames=eb.cfg.strict_reference_frames, dtype=eb.dtype)
    pts, valid, xyzrpy, cam = cli.voxel_inputs(eb, kf0)
    one_card.insert_keyframe_cloud(pts, valid, xyzrpy, cam)
    t0 = time.perf_counter()
    one_cpu.insert_keyframe_cloud(pts.cpu(), valid.cpu(), xyzrpy.cpu(), cam.cpu())
    carve_cpu_s = time.perf_counter() - t0
    require(list(one_card.chunks) == list(one_cpu.chunks), "ros: one keyframe's carving made other chunks on the CPU")
    carved = sum(int((g.misses > 0).sum()) for g in one_cpu.chunks.values())
    carve_differ = sum(int((one_card.chunks[cc].misses.cpu() != g.misses).sum()) for cc, g in one_cpu.chunks.items())
    print(f"ros: one keyframe's carving on the CPU ({carve_cpu_s:.1f} s): {carved} carved voxels, {carve_differ} differ "
          f"from the card's")
    require(carved > 0 and carve_differ <= VOXEL_DIFF_SHARE * carved,
            f"ros: one keyframe's misses differ in {carve_differ} of {carved} carved voxels")

    n_kf = sum(1 for kf in eb.keyframes if kf.cloud is not None)
    recording(eb, carve=False)  # the map without carving, timed alone
    plain_ms = vox_ms.pop(False)
    wall = time.perf_counter() - t_phase
    mbs = {k: round(mb / sec, 1) for k, (mb, sec) in rates.items()}
    print(f"ros: voxel map ms per keyframe ({n_kf} keyframes, 640x480, synced): with carving "
          f"{runs['bag']['voxel_ms'] / n_kf:.2f} (.bag session) / {runs['slog']['voxel_ms'] / n_kf:.2f} (.slog), "
          f"without {plain_ms / n_kf:.2f}; peak device MB of the build above what was allocated: with carving "
          f"{vox_mb[True]:.1f}, without {vox_mb[False]:.1f} ({len(gb.chunks)} chunks of "
          f"{gb.chunks[next(iter(gb.chunks))].hits.numel() * 8 / 1e6:.1f} MB); MB/s {mbs}; phase wall {wall:.2f} s")
    for r in runs.values():
        del r["engine"], r["grid"]
    return {"wall_s": wall, "mb_per_s": mbs, "voxel_ms_per_kf_carve": runs["bag"]["voxel_ms"] / n_kf,
            "voxel_ms_per_kf": plain_ms / n_kf}


def _slog_clouds(native, path):
    """Every cloud of a ``.slog`` file, copied out of the mapped file."""
    with native.SlogReader(path) as r:
        for i in range(r.n_cloud):
            t, xyz, valid = r.cloud(i)
            yield t, xyz.copy(), valid


FL_SPLIT = 0.75  # ~90 of FL_LOG's 120 keyframes: a marginalization (at the 81st) before the split, two after


def check_lifecycle_fixed_lag(torch, fl_log, whole: dict) -> dict:
    """A checkpoint that carries LM-optimized state and a fixed-lag prior:
    the fixed-lag pcg session's log split after its first marginalization,
    the first part run with --checkpoint, that checkpoint held bit for bit
    on the card, and the rest resumed from it, beside the unbroken session
    ``whole`` (the fixed-lag pcg slice)."""
    import numpy as np

    t0 = time.perf_counter()
    first_log, second_log = _split_log(fl_log, FL_SPLIT)
    flags = ["--fixed-lag", str(FL_WINDOW), "--solver", "pcg"]
    first = run_slice(torch, first_log, flags + ["--checkpoint"], "fl_life_first", min_margs=1)
    ckpt = os.path.join(first["out"], "checkpoint.npz")
    z = np.load(ckpt)
    require(int(z["fl_num_p"]) > 0 and len(z["fl_archived"]) == first["engine"]._kf_base > 0
            and float(np.abs(z["fl_Hp"]).sum() + np.abs(z["fl_Hl"]).sum()) > 0,
            "fl_life_first: the checkpoint holds no fixed-lag prior")
    n_tensors = _check_checkpoint(torch, ckpt, first["engine"], "fl_life_first")
    resumed = run_slice(torch, second_log, flags + ["--resume", ckpt], "fl_life_resumed", min_margs=1)
    for r in (first, resumed):
        require(r["engine"].graph.max_poses == FL_ENGINE["K"] and r["k4_shapes"]["grid"] == 0,
                f"fixed-lag lifecycle: a session left K=512 or K4's cluster shape: {r['k4_shapes']}")
    require(resumed["summary"]["keyframes"] > first["summary"]["keyframes"],
            "fl_life_resumed: the resumed session lost or added no keyframes")
    _resumed_against_unbroken(resumed, whole, second_log, "fixed-lag lifecycle")
    ckpt_bytes = os.path.getsize(ckpt)
    wall = time.perf_counter() - t0
    eng = first["engine"]
    print(f"fixed-lag lifecycle: checkpoint at K={eng.graph.max_poses} ({first['summary']['keyframes']} keyframes, "
          f"{eng._kf_base} archived): {ckpt_bytes} bytes; phase wall {wall:.2f} s")
    return {"wall_s": wall, "checkpoint_bytes": ckpt_bytes, "tensors": n_tensors}


# ---------------------------------------------------------------------------
# 12. plane landmarks
# ---------------------------------------------------------------------------

PLANE_STEPS = (8, 40)  # CG steps of the two fixed-work LM iterations whose difference is a step's cost
PLANE_TRACES = 3  # traces of one run taken at most until one holds every K8/K9 launch the counters saw


def plane_cg_step_cost(torch, engine, label: str) -> dict:
    """What a CG step of the row-range loop costs with the plane half and
    without it, at ``engine``'s final state: one LM iteration at
    ``PLANE_STEPS`` fixed CG steps each, the difference over the steps'
    count. K8's and K9's launches a step come from their wrappers' counters
    (K8's call launches two kernels, K9's one) and must be one call of each,
    with the plane half as without it. The device numbers come from a
    ``torch.profiler`` trace of the run: device events (kernels, and the
    copies and fills the eager ops launch), the device ms of all of them and
    of K8 and K9. A trace whose K8/K9 kernel events differ from the counters'
    launches missed or repeated events and is taken again, at most
    ``PLANE_TRACES`` times; if none agrees, the device numbers are None (not
    measured). The host ms is the synced host clock's median of 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semantic_slam_tpu_torch.profile_slice import CTYPES_KERNELS
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g, pn = engine.graph, engine.plane_nodes
    K, L = g.poses.shape[0], g.landmarks.shape[0]
    rows = engine._ell_rows(planes=True)
    pf, lf = _free_masks(g)
    de = sd.build_dist_edges(_edge_args(g), K, rows[2], L)
    pe = sd.build_plane_dist(sd.plane_args(pn), K, rows[3])
    fwd, bwd = CTYPES_KERNELS["tiled_mv_fwd"], CTYPES_KERNELS["tiled_mv_bwd"]
    mv = fwd + bwd

    def lm(steps, planes):
        kw = dict(pe=pe, planes=pn.planes, plane_free=pn.plane_mask()) if planes else {}
        sd.run_lm_loop_soa_dist(g.poses, g.landmarks, pf, lf, de, 1, 0.0, steps, cg_tol=0.0, **kw)
        torch.cuda.synchronize()

    def counted(steps, planes):
        """The K8 and K9 wrapper calls of one run."""
        f0, b0 = tk.tiled_mv_fwd.launches, tk.tiled_mv_bwd.launches
        lm(steps, planes)
        return tk.tiled_mv_fwd.launches - f0, tk.tiled_mv_bwd.launches - b0

    def traced(steps, planes, want):
        """(device events, device ms, K8/K9 device ms, traces taken) of a
        trace holding ``want`` K8/K9 kernel events; the first three None if
        no trace of ``PLANE_TRACES`` did."""
        for n in range(1, PLANE_TRACES + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lm(steps, planes)
            evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            hand = [e for e in evs if any(f"{k}(" in e.name for k in mv)]
            if len(hand) == want:
                return (len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3,
                        sum(e.time_range.elapsed_us() for e in hand) / 1e3, n)
            print(f"[{label}] trace {n} of {steps} steps ({'planes' if planes else 'points'}) held {len(hand)} "
                  f"K8/K9 kernel events for {want} launches; taken again")
        return None, None, None, PLANE_TRACES

    out = {}
    for planes in (True, False):
        per = {}
        for steps in PLANE_STEPS:
            lm(steps, planes)  # warm-up
            hosts = []
            for _ in range(3):
                t = time.perf_counter()
                lm(steps, planes)
                hosts.append(time.perf_counter() - t)
            calls = counted(steps, planes)
            want = len(fwd) * calls[0] + len(bwd) * calls[1]
            n_ev, dev, hand_ms, tries = traced(steps, planes, want)
            per[steps] = dict(calls=calls, launches=want, events=n_ev, device=dev, hand=hand_ms, tries=tries,
                              host=1e3 * statistics.median(hosts))
        a, b = per[PLANE_STEPS[0]], per[PLANE_STEPS[1]]
        n = PLANE_STEPS[1] - PLANE_STEPS[0]

        def step(key):
            return None if a[key] is None or b[key] is None else (b[key] - a[key]) / n

        out["planes" if planes else "points"] = {
            "k8_calls": (b["calls"][0] - a["calls"][0]) / n, "k9_calls": (b["calls"][1] - a["calls"][1]) / n,
            "k8_k9_launches": step("launches"), "device_events": step("events"), "device_ms": step("device"),
            "k8_k9_device_ms": step("hand"), "host_ms": step("host"), "traces": a["tries"] + b["tries"]}
    p_, q_ = out["planes"], out["points"]

    def f(x, spec):
        return "not measured" if x is None else format(x, spec)

    def diff(key):
        return None if p_[key] is None or q_[key] is None else p_[key] - q_[key]

    print(f"[{label}] a CG step at K={K}, L={L}, Pl={pn.max_planes} (difference of {PLANE_STEPS} fixed steps): with "
          f"planes {f(p_['device_events'], '.1f')} device events ({p_['k8_k9_launches']:.1f} K8/K9 launches), "
          f"device {f(p_['device_ms'], '.4f')} ms (K8/K9 {f(p_['k8_k9_device_ms'], '.4f')}), host "
          f"{p_['host_ms']:.4f} ms; without {f(q_['device_events'], '.1f')} events ({q_['k8_k9_launches']:.1f}), "
          f"device {f(q_['device_ms'], '.4f')} ms (K8/K9 {f(q_['k8_k9_device_ms'], '.4f')}), host "
          f"{q_['host_ms']:.4f} ms; the plane half: {f(diff('device_events'), '.1f')} launches, "
          f"{f(diff('device_ms'), '.4f')} ms of device and {diff('host_ms'):.4f} ms of host a step "
          f"(traces taken {p_['traces']} + {q_['traces']} for 4 runs)")
    for k, v in (("planes", p_), ("points", q_)):
        require(v["k8_calls"] == 1.0 and v["k9_calls"] == 1.0,
                f"[{label}] a CG step ({k}) called K8 {v['k8_calls']} and K9 {v['k9_calls']} times, expected once each")
    return out


MIN_PLANE_EDGES = 8  # each plane session's least plane edges


def _check_plane_session(r: dict, point: dict, label: str, same_keyframes: bool) -> None:
    """A plane-landmark session against its point-landmark twin ``point``:
    a plane per landmark, a plane edge per observation edge and at least
    ``MIN_PLANE_EDGES`` of them, unit normals, ATE no worse than raw VIO's (the
    twin's printed beside it, not bounded) and, with ``same_keyframes``, the
    twin's keyframes."""
    eng, s = r["engine"], r["summary"]
    pn = eng.plane_nodes
    P, E3 = int(pn.num_planes), int(pn.num_pe)
    norms = pn.planes[:P, :3].double().norm(dim=-1)
    print(f"[{label}] {P} planes, {E3} plane edges, {s['landmarks']} landmarks; normals' |n| - 1 within "
          f"{float((norms - 1).abs().max()):.3g}; ATE {s['ate_rmse_optimized']:.6g} m (raw VIO "
          f"{s['ate_rmse_vio']:.6g}, "
          f"point landmarks {point['summary']['ate_rmse_optimized']:.6g}); keyframes {r['keyframes']} (point "
          f"{point['keyframes']}); median optimizing tick {r['median_opt_ms']:.2f} ms, LM iterations "
          f"{sum(r['iterations'])}, {r['opt_ms_per_iteration']:.3f} ms an LM iteration")
    require(P == int(eng.table.count) == s["landmarks"] > 0, f"[{label}] {P} planes for {s['landmarks']} landmarks")
    require(E3 == int(eng.graph.num_lme) and E3 >= MIN_PLANE_EDGES,
            f"[{label}] {E3} plane edges for {int(eng.graph.num_lme)} observations (at least {MIN_PLANE_EDGES} "
            "asked)")
    require(float((norms - 1).abs().max()) <= 1e-5, f"[{label}] plane normals are not unit")
    require(s["ate_rmse_optimized"] <= s["ate_rmse_vio"], f"[{label}] ATE worse than raw VIO's")
    if same_keyframes:
        require(r["keyframes"] == point["keyframes"], f"[{label}] keyframes {r['keyframes']} != {point['keyframes']}")


def check_plane_slices(torch, plane_log, fl_log, fl_point: dict) -> dict:
    """The plane-landmark sessions at full width: A, ``PLANE_LOG`` with
    --plane-landmarks (K=512, the dense plane LM); B, the same with
    --solver pcg --max-keyframes 4096 (K=4096, L = Pl = 1024: the row-range
    loop with its plane half, K6-K10, the marginals over L + Pl blocks); C,
    the fixed-lag log with --plane-landmarks --fixed-lag 64 --solver pcg
    (K=512: K6-K10 at Kl=512 with a prior that has a plane part), its
    checkpoint and .g2o read back. A and B are held to the point-landmark
    dense session on their log, run here first; C to ``fl_point``. B's and
    C's final states go to phase 14 (``states``)."""
    t0 = time.perf_counter()
    twin = run_slice(torch, plane_log, [], "plane_log_point_dense")
    a = run_slice(torch, plane_log, ["--plane-landmarks"], "plane_dense")
    _check_plane_session(a, twin, "plane_dense", same_keyframes=True)
    del a["engine"]
    b = run_slice(torch, plane_log, ["--plane-landmarks", "--solver", "pcg", "--max-keyframes", "4096"], "plane_pcg")
    require(b["loop"] == "tiled" and b["engine"].graph.max_poses == BENCH["K"]
            and b["engine"].plane_nodes.max_planes == BENCH["L"], f"plane_pcg: not the K=4096 row-range loop")
    _check_plane_session(b, twin, "plane_pcg", same_keyframes=True)
    step_b = plane_cg_step_cost(torch, b["engine"], "plane_pcg")
    states = {"plane_pcg": _plane_state(b["engine"], with_prior=False)}
    del b["engine"]
    c_flags = ["--plane-landmarks", "--fixed-lag", str(FL_WINDOW), "--solver", "pcg", "--checkpoint", "--save-graph"]
    c = run_slice(torch, fl_log, c_flags, "plane_fixed_lag_pcg", min_margs=2)
    eng = c["engine"]
    require(c["loop"] == "tiled" and eng.graph.max_poses == FL_ENGINE["K"], "plane_fixed_lag_pcg: not K=512 tiled")
    _check_plane_session(c, fl_point, "plane_fixed_lag_pcg", same_keyframes=False)
    require(float(eng.prior.Hpl.abs().sum()) > 0, "plane_fixed_lag_pcg: the prior's plane part is zero")
    _check_checkpoint(torch, os.path.join(c["out"], "checkpoint.npz"), eng, "plane_fixed_lag_pcg")
    _check_g2o(torch, os.path.join(c["out"], "semantic_graph.g2o"), eng, "plane_fixed_lag_pcg")
    step_c = plane_cg_step_cost(torch, eng, "plane_fixed_lag_pcg")
    states["plane_fixed_lag_pcg"] = _plane_state(eng, with_prior=True)
    del c["engine"]
    wall = time.perf_counter() - t0
    print(f"plane slices: phase wall {wall:.2f} s")
    return {"wall_s": wall, "step": {"plane_pcg": step_b, "plane_fixed_lag_pcg": step_c},
            "launches": {"plane_pcg": b["launches"], "plane_fixed_lag_pcg": c["launches"]}, "twin": twin,
            "states": states}


def _plane_state(engine, with_prior: bool) -> dict:
    """What phase 14 solves again on the mesh: a plane session's final
    graph, planes, ELL rows and (``with_prior``) its fixed-lag prior."""
    return {"g": engine.graph, "pn": engine.plane_nodes, "rows": engine._ell_rows(planes=True),
            "prior": engine.prior if with_prior else None}


# ---------------------------------------------------------------------------
# 13. breadth on the card
# ---------------------------------------------------------------------------

WINDOW_POSE_ATOL = 5e-4  # tests/test_ingest_window.py's bound on poses after finalize


def _cg_steps_to_tol(torch, engine, max_steps: int, cg_tol: float = 1e-8) -> dict:
    """CG steps the resident loop's damped Schur system takes to the loop's
    tolerance under each preconditioner, at ``engine``'s final state: one
    linearization (the plain version), lambda at the LM's seed, the solves
    ``soa_schur_step`` (jacobi, K4's plain version) and
    ``soa_schur_step_tridiag``, each step's residual recorded where the
    preconditioner reads it."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver.lm import _free_masks
    from semantic_slam_tpu_torch.solver.pcg import _edge_args

    g = engine.graph
    pf, lf = _free_masks(g)
    se = soa.build_soa_edges(_edge_args(g), g.poses.shape[0], engine._ell_rows()[2], g.landmarks.shape[0])
    lin = soa.PLAIN_OPS.linearize(g.poses, g.landmarks, se, "none", 1.0)
    lam = _init_lambda(torch, lin)
    orig, out = soa._schur_pcg, {}
    for name, solve in (("jacobi", soa.soa_schur_step), ("tridiag", soa.soa_schur_step_tridiag)):
        r2 = []

        def recording(lin_, se_, lam_, pf_, lmf_, precond, *rest, r2=r2, **kw):
            def rec(r):
                r2.append(torch.sum(r * r))
                return precond(r)

            return orig(lin_, se_, lam_, pf_, lmf_, rec, *rest, **kw)

        soa._schur_pcg = recording
        try:
            solve(lin, se, lam, pf, lf, max_steps, cg_tol)
        finally:
            soa._schur_pcg = orig
        r2 = torch.stack(r2).double().cpu()
        hit = torch.nonzero(r2 <= cg_tol * torch.clamp(r2[0], min=1e-30))
        out[name] = int(hit[0]) if len(hit) else max_steps
    return out


def check_breadth(torch, log, plane_log, twin: dict, pcg: dict, tiled: dict) -> None:
    """Phase 13, the last single-device paths at full width:

    * window: ``plane_log`` in point mode with ``--ingest-window 8``, held
      to the point dense session on it (``twin``, phase 12) after both
      ``finalize()``: equal keyframes, landmarks and edges, poses within
      ``WINDOW_POSE_ATOL``; K5 four launches a frontend call (``run_slice``);
    * tridiag: the pcg slice's shape (K=4096, resident loop: K1-K3, K4
      never) and the tiled slice's (K=8192, row-range loop: K6-K10) with
      ``--precond tridiag``: launches as the LM iterations imply, chi2 never
      rising (``run_slice``), ATE no worse than raw VIO's; ms per LM
      iteration and CG steps to tolerance beside jacobi's;
    * fitness information (a profile with ``use_const_inf_matrix=False``)
      and ``--adaptive-normals`` on the dense log;
    * ``--xla-trace`` on the dense session: its trace holds K5's kernel."""
    import dataclasses

    from semantic_slam_tpu_torch import config as tcfg

    t0 = time.perf_counter()
    # -- the window program alone on parallel/window_inputs.py's synthetic run
    # (WINDOW keyframes, one box each, one plane round): card against CPU, K5
    # once for the window's WINDOW detections
    from semantic_slam_tpu_torch.frontend import kernels as fk
    from semantic_slam_tpu_torch.parallel.window_inputs import make_window_inputs
    from semantic_slam_tpu_torch.runtime import engine as engine_mod

    prog = {}
    for dev in (DEVICE, "cpu"):
        g, tab, args, st = make_window_inputs(WINDOW, device=dev)
        n0 = fk.score_hypotheses.launches
        g, tab, _ = engine_mod._process_keyframes_window(g, tab, **args, **st)
        prog[dev] = ((int(tab.count), int(g.num_poses), int(g.num_lme)), fk.score_hypotheses.launches - n0,
                     g.landmarks[: int(g.num_landmarks)].cpu())
    (cnt, k5_card, lm_card), (cnt_cpu, _, lm_cpu) = prog[DEVICE], prog["cpu"]
    lm_gap = float((lm_card - lm_cpu).abs().max()) if len(lm_cpu) else 0.0
    print(f"[window program] window_inputs B={WINDOW}: landmarks, poses, observations {cnt} (CPU {cnt_cpu}); "
          f"landmarks within {lm_gap:.3g} of the CPU's; K5 {k5_card} launch(es) on the card")
    require(cnt == cnt_cpu and cnt[0] > 0 and k5_card == 1 and lm_gap <= 1e-3,
            "[window program] card and CPU disagree, or K5 did not score the window in one launch")

    # -- window ingest
    win = run_slice(torch, plane_log, ["--ingest-window", str(WINDOW)], "window")
    ws, ts = win["summary"], twin["summary"]
    for k in ("keyframes", "landmarks", "edges"):
        require(ws[k] == ts[k], f"[window] {k}: {ws[k]} against the per-tick session's {ts[k]}")
    require(win["windows"] and max(win["windows"]) >= 2, f"[window] no run of detection keyframes shared a "
                                                         f"frontend call: {win['windows']}")
    twin["engine"].finalize()
    gap = float(abs(win["engine"].get_keyframe_poses() - twin["engine"].get_keyframe_poses()).max())
    kf_s = {name: r["keyframes"] / r["wall_s"] for name, r in (("window", win), ("per_tick", twin))}
    flush = statistics.median(win["tick_ms"])
    print(f"[window] {ws['keyframes']} keyframes, {ws['landmarks']} landmarks, {ws['edges']} edges (per-tick "
          f"session: the same); {len(win['windows'])} windows of {win['windows']} rows; poses after finalize "
          f"within {gap:.3g} of the per-tick session's (bound {WINDOW_POSE_ATOL:g}); keyframes per second "
          f"(session wall) window {kf_s['window']:.2f}, per tick {kf_s['per_tick']:.2f}; ms per flush: median "
          f"{flush:.2f} over {len(win['tick_ms'])} flushes; K5 {win['launches']['score_hypotheses']} launches")
    require(gap <= WINDOW_POSE_ATOL, f"[window] poses {gap:.3g} from the per-tick session's")
    del win["engine"], twin["engine"]

    # -- the tridiagonal preconditioner on both loops
    for label, K, jac in (("tridiag_pcg", BENCH["K"], pcg), ("tridiag_tiled", TILED_BENCH["K"], tiled)):
        r = run_slice(torch, log, ["--solver", "pcg", "--max-keyframes", str(K), "--precond", "tridiag"], label)
        s = r["summary"]
        require(r["loop"] == ("resident" if K <= BENCH["K"] else "tiled"), f"[{label}] took the {r['loop']} loop")
        require(r["keyframes"] == jac["keyframes"], f"[{label}] keyframes {r['keyframes']} != {jac['keyframes']}")
        require(s["ate_rmse_optimized"] <= s["ate_rmse_vio"], f"[{label}] ATE worse than raw VIO's")
        steps = _cg_steps_to_tol(torch, r["engine"], r["engine"].cfg.solver.pcg_iters)
        print(f"[{label}] K={K}: ms per LM iteration {r['opt_ms_per_iteration']:.3f} (jacobi "
              f"{jac['opt_ms_per_iteration']:.3f}), LM iterations {sum(r['iterations'])} (jacobi "
              f"{sum(jac['iterations'])}), median optimizing tick {r['median_opt_ms']:.2f} ms (jacobi "
              f"{jac['median_opt_ms']:.2f}); CG steps to tolerance at the final state {steps}; ATE "
              f"{s['ate_rmse_optimized']:.6g} m (raw VIO {s['ate_rmse_vio']:.6g}, jacobi "
              f"{jac['summary']['ate_rmse_optimized']:.6g})")
        del r["engine"]

    # -- fitness information, adaptive normals
    base = tcfg.PROFILES["yolo_detector"]
    tcfg.PROFILES["yolo_detector_fitness"] = base.replace(
        information=dataclasses.replace(base.information, use_const_inf_matrix=False))
    try:
        fit = run_slice(torch, log, ["--profile", "yolo_detector_fitness"], "fitness")
    finally:
        del tcfg.PROFILES["yolo_detector_fitness"]
    eng = fit["engine"]
    info = eng.graph.odom_info[: eng._n_odom]
    d = info.diagonal(dim1=-2, dim2=-1)
    n_fit = int((info != eng._info6).flatten(1).any(dim=1).sum())
    print(f"[fitness] {len(info)} odometry edges, {n_fit} with fitness information; diagonal in "
          f"[{float(d.min()):.6g}, {float(d.max()):.6g}] (constant {float(eng._info6[0, 0]):.6g} / "
          f"{float(eng._info6[3, 3]):.6g}); median optimizing tick {fit['median_opt_ms']:.2f} ms; ATE "
          f"{fit['summary']['ate_rmse_optimized']:.6g} m (raw VIO {fit['summary']['ate_rmse_vio']:.6g})")
    require(bool(torch.isfinite(info).all()) and bool((d > 0).all()), "[fitness] information not finite and positive")
    require(n_fit > 0, "[fitness] every odometry block is the constant matrix")
    del fit["engine"]
    adp = run_slice(torch, log, ["--adaptive-normals"], "adaptive_normals")
    s = adp["summary"]
    print(f"[adaptive_normals] {s['landmarks']} landmarks; median optimizing tick {adp['median_opt_ms']:.2f} ms; "
          f"ATE {s['ate_rmse_optimized']:.6g} m (raw VIO {s['ate_rmse_vio']:.6g})")
    require(s["ate_rmse_optimized"] <= s["ate_rmse_vio"], "[adaptive_normals] ATE worse than raw VIO's")
    del adp["engine"]

    # -- --xla-trace: a torch.profiler trace of the dense session
    trace_dir = os.path.join(OUT_DIR, "xla_trace")
    tr = run_slice(torch, log, ["--xla-trace", trace_dir], "dense_trace")
    del tr["engine"]
    path = os.path.join(trace_dir, "trace.json")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    n_k5 = sum(1 for ev in events if "score_kernel(" in ev.get("name", "") and ev.get("cat") == "kernel")
    print(f"[dense_trace] trace.json {size / 1e6:.1f} MB, {len(events)} events, {n_k5} score_kernel (K5) kernel "
          f"events for {tr['launches']['score_hypotheses']} launches")
    require(n_k5 > 0, "[dense_trace] the trace holds no K5 kernel event")
    print(f"breadth: phase wall {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# 14. several ranks on the card
# ---------------------------------------------------------------------------

MESH_RANKS = (2, 4)  # gloo ranks sharing the card


def _fixed_lm(torch, g, R: int, mesh=None) -> tuple:
    """8 LM iterations of LM_STEPS CG steps on ``g``: ``sharded_lm_optimize_soa``
    on ``mesh``, else ``lm_optimize_soa_tiled``; returns (graph, LMStats, ms
    per LM iteration on the host clock, synced)."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd

    kw = dict(max_iterations=8, min_edges=0, rel_tol=0.0, max_cg_iters=LM_STEPS, cg_tol=0.0, ell_rows=(1, 1, R))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sd.lm_optimize_soa_tiled(g, **kw) if mesh is None else sd.sharded_lm_optimize_soa(g, mesh, **kw)
    torch.cuda.synchronize()
    return out[0], out[1], 1e3 * (time.perf_counter() - t0) / max(out[1].iterations, 1)


def _workers_clean(mesh, label: str) -> None:
    """No JAX module in any rank of ``mesh`` (rank 0 is this script)."""
    loaded = mesh.forbidden_modules()
    print(f"[{label}] JAX modules loaded per rank: {[len(x) for x in loaded]}")
    require(not any(loaded), f"[{label}] a rank loaded JAX or the JAX package: {[x[:4] for x in loaded]}")


def _pose_err(torch, got, want) -> float:
    """max |got - want| over the poses, relative to their largest entry."""
    return float((got - want).abs().max() / want.abs().max())


def _mesh_lm(torch, g, R: int, mesh, ref, label: str) -> dict:
    """The fixed-work LM on ``mesh`` against ``ref`` (graph, stats), each
    rank's K6-K10 launches against the iterations, and the collectives."""
    from semantic_slam_tpu_torch.utils.profiling import mesh_kernel_launches

    K, L = g.poses.shape[0], g.landmarks.shape[0]
    mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
    mesh.recording, mesh.log = True, []
    try:
        gm, sm, ms = _fixed_lm(torch, g, R, mesh)
    finally:
        mesh.recording = False
    ranks = mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
    err = _pose_err(torch, gm.poses, ref[0].poses)
    it = sm.iterations
    print(f"[{label}] {mesh.size} ranks ({mesh.backend}), Kl={K // mesh.size}: {it} LM iterations x {LM_STEPS} CG "
          f"steps, chi2 {float(sm.chi2_initial):.7g} -> {float(sm.chi2_final):.7g} (reference "
          f"{float(ref[1].chi2_final):.7g}); poses within {err:.3g} of scale of the reference (bound {LIN_RTOL:g}); "
          f"{ms:.3f} ms per LM iteration (host clock, synced)")
    require(it == 8 and err <= LIN_RTOL, f"[{label}] the sharded LM disagrees with its reference")
    want = {"tiled_fused_linearize": it, "tiled_mv_fwd": it * (LM_STEPS + 1), "tiled_mv_bwd": it * (LM_STEPS + 1),
            "tiled_chi2": it}
    print(f"[{label}] launches per rank (K6 + K7, K8, K9, K10): {[[r[k] for k in want] for r in ranks]}; "
          f"expected each {list(want.values())}")
    for r, got in enumerate(ranks):
        for k, n in want.items():
            require(got[k] == n, f"[{label}] rank {r}: {k} {got[k]} launches, expected {n}")
    per_step = [(k, n, b) for k, n, b in mesh.log if n in (3 * L, 12 * K)]
    n_t = sum(1 for _, n, _ in per_step if n == 3 * L)
    n_u = sum(1 for _, n, _ in per_step if n == 12 * K)
    step_bytes = 4 * (3 * L + 12 * K)
    print(f"[{label}] collectives of the solve: {len(mesh.log)} ({sum(b for _, _, b in mesh.log) / 2**20:.1f} MiB); "
          f"per CG step 2 all-reduces, [3L]={3 * L} and [12K]={12 * K} elements, {step_bytes} bytes "
          f"({n_t} and {n_u} in all: it x (steps + 1) and it x steps)")
    require(n_u == it * LM_STEPS and n_t == it * (LM_STEPS + 1), f"[{label}] collectives per CG step differ")
    return {"ms_per_lm_iteration": ms, "err": err, "ranks": ranks, "collectives": len(mesh.log),
            "step_bytes": step_bytes}


def check_mesh(torch, log, refs: dict) -> dict:
    """Phase 14 (module docstring). ``refs``: the tiled slice (its poses and
    summary), the lifecycle's two checkpoints and the final states of plane
    sessions B and C. Each CG step's two all-reduces go through the host
    under gloo (~2.7 ms a step at K=8192 on 2 ranks), so the plane and
    fixed-lag pcg sessions themselves, with 300-900 LM iterations of 129
    steps each, run on gloo CPU ranks in ``tests/test_torch_mesh_engine.py``;
    here their final states take a fixed-work plane LM on 2 ranks."""
    import numpy as np

    from semantic_slam_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    out = {"launches": {}}
    g, _, _, _, R = _soa_case(torch, **TILED_BENCH)
    ref = _fixed_lm(torch, g, R)
    print(f"[mesh] one device, lm_optimize_soa_tiled: {ref[1].iterations} LM iterations, chi2 "
          f"{float(ref[1].chi2_final):.7g}, {ref[2]:.3f} ms per LM iteration")
    m = dist.make_mesh(1, device="cuda")
    require(m.backend == "nccl", f"world size 1 took {m.backend}")
    try:
        nccl = _mesh_lm(torch, g, R, m, ref, "mesh_nccl_1")
        ws1 = _fixed_lm(torch, g, R, m)
    finally:
        m.close()
    out["lm"] = {1: nccl}

    m = dist.make_mesh(2, backend="gloo", devices=["cuda:0"] * 2)
    try:
        _workers_clean(m, "mesh_gloo_2")
        out["lm"][2] = _mesh_lm(torch, g, R, m, ws1, "mesh_gloo_2")
        out["launches"]["lm_2"] = out["lm"][2]["ranks"]

        tiled = run_slice(torch, log, ["--solver", "pcg", "--max-keyframes", "8192", "--devices", "2"],
                          "mesh_tiled", mesh=m)
        want = refs["tiled"]
        for k in ("keyframes", "landmarks", "edges"):
            require(tiled["summary"][k] == want["summary"][k], f"[mesh_tiled] {k}: {tiled['summary'][k]} != "
                                                               f"{want['summary'][k]} (tiled slice)")
        err = float(np.abs(tiled["poses"] - want["poses"]).max() / np.abs(want["poses"]).max())
        print(f"[mesh_tiled] the tiled slice's keyframes, landmarks and edges; poses within {err:.3g} of scale "
              f"(bound {LIN_RTOL:g}); ms per LM iteration {tiled['opt_ms_per_iteration']:.3f} against "
              f"{want['opt_ms_per_iteration']:.3f} on one device")
        require(err <= LIN_RTOL, "[mesh_tiled] poses differ from the tiled slice's")
        out["launches"]["mesh_tiled"] = tiled["rank_launches"]
        _mesh_checkpoint(torch, tiled["engine"], m)
        del tiled["engine"]

        out["launches"]["window_2"] = _mesh_window(torch, m)
        for label, ranks in _mesh_planes(torch, refs["planes"], m).items():
            out["launches"][f"{label}_2"] = ranks
        _mesh_merge(torch, refs["life_checkpoints"], m)
    finally:
        m.close()

    m = dist.make_mesh(4, backend="gloo", devices=["cuda:0"] * 4)
    try:
        _workers_clean(m, "mesh_gloo_4")
        out["lm"][4] = _mesh_lm(torch, g, R, m, ws1, "mesh_gloo_4")
        out["launches"]["lm_4"] = out["lm"][4]["ranks"]
    finally:
        m.close()
    out["wall_s"] = time.perf_counter() - t0
    print(f"mesh: ms per LM iteration at K=8192 (host clock; gloo staged through the host) one device "
          f"{ref[2]:.3f}, NCCL 1 rank {nccl['ms_per_lm_iteration']:.3f}, gloo 2 ranks "
          f"{out['lm'][2]['ms_per_lm_iteration']:.3f}, 4 ranks {out['lm'][4]['ms_per_lm_iteration']:.3f}; "
          f"phase wall {out['wall_s']:.2f} s")
    return out


def _mesh_checkpoint(torch, engine, mesh) -> None:
    """The mesh session's distributed checkpoint read back into a fresh
    engine on the mesh, every tensor bit for bit."""
    import dataclasses

    from semantic_slam_tpu_torch.io import checkpoint as ck
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    path = os.path.join(OUT_DIR, "mesh_checkpoint")
    t0 = time.perf_counter()
    ck.save_checkpoint_dist(path, engine)
    fresh = SlamEngine(engine.cfg, device=DEVICE, mesh=mesh)
    ck.load_checkpoint_dist(path, fresh)
    n = 0
    for name in ("graph", "table", "prior"):
        a, b = getattr(engine, name), getattr(fresh, name)
        names = [f.name for f in dataclasses.fields(a)] if dataclasses.is_dataclass(a) else a._fields
        for f in names:
            x, y = getattr(a, f), getattr(b, f)
            require(y.device.type == DEVICE and torch.equal(x, y), f"distributed checkpoint: {name}.{f} differs")
            n += 1
    require(torch.equal(engine.marginals, fresh.marginals), "distributed checkpoint: marginals differ")
    size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(path) for f in fs)
    print(f"[mesh_tiled] distributed checkpoint (torch.distributed.checkpoint + host_state.json): {n + 1} tensors "
          f"bit for bit on the card, {size} bytes, {time.perf_counter() - t0:.2f} s")


MESH_WINDOW_B = 8  # phase 14's window rows: WINDOW keyframes, B / n a rank
# its boxes: D = 8 a row (yolo_detector's max_detections_per_frame), a 4 x 2
# grid of 150 x 220 px boxes [tl_x, tl_y, w, h] over the 640x480 cloud, and
# their classes: the 7 whitelisted ones, the last box sharing the first's at
# the far corner; and the keyframes' spacing along x. The association matches
# a detection to a landmark of its class within 1.5 m of the landmark's first
# sighting: with one class for all boxes the grid's rows lie 1.5 m apart on
# the plane, and at window_inputs' 0.5 m spacing a box's track meets that
# distance 3 keyframes on, ties that float rounding decides either way. At
# 0.4 m the track's distances are 0.4 to 1.2 m, then 1.6 m (a new landmark)
MESH_WINDOW_BOXES = [[8.0 + 157.0 * c, 10.0 + 240.0 * r, 150.0, 220.0] for r in range(2) for c in range(4)]
MESH_WINDOW_CLASSES = [0, 1, 2, 3, 4, 5, 6, 0]
MESH_WINDOW_STEP = 0.4


def _full_width_window(torch):
    """``parallel/window_inputs.py``'s run of ``MESH_WINDOW_B`` keyframes at
    the dense log's shapes: 640x480 clouds, ``MESH_WINDOW_BOXES`` a row
    (classes ``MESH_WINDOW_CLASSES``), keyframes ``MESH_WINDOW_STEP`` apart, and
    the yolo_detector profile's frontend (256x256 crops, so K5 scores N =
    65,536 points against S = 128 hypotheses, 4 plane rounds, its
    segmentation thresholds and normal window), with a graph and table
    sized for every detection's planes. Returns (graph, table, args,
    statics) as ``make_window_inputs`` does."""
    from semantic_slam_tpu_torch.assoc import association as assoc_mod
    from semantic_slam_tpu_torch.config import PROFILES
    from semantic_slam_tpu_torch.graph import state as gs
    from semantic_slam_tpu_torch.parallel.window_inputs import make_window_inputs

    B, D = MESH_WINDOW_B, len(MESH_WINDOW_BOXES)
    prof = PROFILES["yolo_detector"]
    seg = prof.segmentation
    _, _, args, _ = make_window_inputs(B, torch.float32, device=DEVICE, H=seg.image_height, W=seg.image_width)
    obs = B * D * seg.max_planes_per_detection
    graph = gs.make_graph(16, obs, 16, obs, dtype=torch.float32, device=DEVICE)
    table = assoc_mod.make_table(obs, dtype=torch.float32, device=DEVICE)
    x = MESH_WINDOW_STEP * torch.arange(B, dtype=torch.float32, device=DEVICE)
    args["odoms"][:, 0] = x
    args["robot_xyzrpy"][:, 0] = x
    args.update(
        boxes=torch.tensor([MESH_WINDOW_BOXES] * B, dtype=torch.float32, device=DEVICE),
        class_ids=torch.tensor([MESH_WINDOW_CLASSES] * B, dtype=torch.int32, device=DEVICE),
        probs=args["probs"].expand(B, D).contiguous(),
        seg_params={"num_point_seg": float(seg.num_point_seg), "norm_point_thres": float(seg.norm_point_thres),
                    "planar_area": float(seg.planar_area), "distance_thres": float(seg.distance_thres),
                    "cos_angular_thres": math.cos(math.radians(seg.angular_thres_deg))},
    )
    statics = dict(samp_h=seg.crop_height, samp_w=seg.crop_width, max_planes=seg.max_planes_per_detection,
                   num_hypotheses=seg.num_hypotheses, smoothing_size=seg.normal_smoothing_size,
                   strict_frames=prof.strict_reference_frames, use_rtabmap_offset=False, depth_input=False)
    return graph, table, args, statics


def _mesh_window(torch, mesh) -> list:
    """``sharded_window_step`` on the mesh at full width (``_full_width_window``)
    against the single-device window program and row-range LM on the same
    inputs; K5 once a plane round on each rank, over that rank's B / n rows."""
    from semantic_slam_tpu_torch.parallel import sharded as psh
    from semantic_slam_tpu_torch.runtime import engine as eng
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.utils.profiling import mesh_kernel_launches

    graph, table, args, statics = _full_width_window(torch)
    B, D = args["boxes"].shape[:2]
    solve = dict(max_iterations=4, min_edges=1, rel_tol=1e-6, max_cg_iters=16)
    t0 = time.perf_counter()
    g1, t1, _ = eng._process_keyframes_window(graph, table, **args, **statics)
    g1, s1 = sd.lm_optimize_soa_tiled(g1, ell_rows=(1, 1, D * statics["max_planes"]), **solve)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    kw = {k: v for k, v in args.items() if k not in ("odoms", "cam_intr", "depth_scale")}
    st = {k: v for k, v in statics.items() if k != "depth_input"}
    mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
    t0 = time.perf_counter()
    gm, tm, sm = psh.sharded_window_step(graph, table, args["odoms"], torch.ones(B, dtype=torch.bool), **kw,
                                         mesh=mesh, **st, **solve)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    ranks = mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
    k5 = [r["score_hypotheses"] for r in ranks]
    err = _pose_err(torch, gm.poses, g1.poses)
    H, W = args["points"].shape[1:3]
    print(f"[mesh_window] sharded_window_step, B={B} rows of {D} detections, {W}x{H} clouds, "
          f"{statics['samp_w']}x{statics['samp_h']} crops on {mesh.size} ranks (K5 at D'={B // mesh.size * D}, N={statics['samp_h'] * statics['samp_w']}, "
          f"S={statics['num_hypotheses']} a rank): {int(gm.num_poses)} poses, {int(tm.count)} landmarks, "
          f"{int(gm.num_lme)} observations (one device: {int(g1.num_poses)}, {int(t1.count)}, {int(g1.num_lme)}); "
          f"LM iterations {sm.iterations} (one device {s1.iterations}); poses within {err:.3g} of scale (bound "
          f"{LIN_RTOL:g}); K5 launches per rank {k5}; {t_mesh:.2f} s on the mesh, {t_one:.2f} s on one device "
          f"(host clock, synced)")
    require(int(tm.count) == int(t1.count) > 0 and int(gm.num_lme) == int(g1.num_lme) and err <= LIN_RTOL,
            "[mesh_window] the sharded window step differs from one device's")
    require(k5 == [statics["max_planes"]] * mesh.size, f"[mesh_window] K5 launches per rank {k5}")
    return ranks


def _mesh_planes(torch, states: dict, mesh) -> dict:
    """``sharded_lm_optimize_soa_planes`` at fixed work on the final states
    of plane sessions B (K=4096, no prior) and C (K=512, a fixed-lag prior
    with a plane part), their live poses moved by ~5 cm and ~0.01 (seeded,
    so that the LM has steps to take), with the marginals, against
    ``lm_optimize_soa_planes`` on one device: poses and planes within
    LIN_RTOL of scale, chi2 within LM_RTOL, the marginals within LM_RTOL in
    norm, and every rank's launches those of the one-device loop (each rank
    runs it over its rows), but for the marginals' final linearization: K6 +
    K7 on each rank's range where one device takes K1 + K2. Returns the
    launches per rank by session."""
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.utils.profiling import kernel_launches, mesh_kernel_launches

    out = {}
    for label, st in states.items():
        g, pn, rows, prior = st["g"], st["pn"], st["rows"], st["prior"]
        n = int(g.num_poses)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        t = g.poses[:n, :3] + 0.05 * torch.randn(n, 3, generator=gen, device=DEVICE)
        q = torch.nn.functional.normalize(g.poses[:n, 3:] + 0.01 * torch.randn(n, 4, generator=gen, device=DEVICE),
                                          dim=-1)
        g = g.replace(poses=torch.cat([torch.cat([t, q], dim=1), g.poses[n:]]))
        kw = dict(max_iterations=4, min_edges=0, rel_tol=0.0, max_cg_iters=LM_STEPS, cg_tol=0.0, prior=prior,
                  with_marginals=True, ell_rows=rows)
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g1, pn1, s1, m1 = sd.lm_optimize_soa_planes(g, pn, **kw)
        torch.cuda.synchronize()
        ms1 = 1e3 * (time.perf_counter() - t0) / max(s1.iterations, 1)
        one = {k: n - before[k] for k, n in kernel_launches().items()}
        mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
        t0 = time.perf_counter()
        gm, pnm, sm, mm = sd.sharded_lm_optimize_soa_planes(g, pn, mesh, **kw)
        torch.cuda.synchronize()
        msm = 1e3 * (time.perf_counter() - t0) / max(sm.iterations, 1)
        ranks = mesh.run(mesh_kernel_launches, {}, gather=True, reset=True)
        P = int(pn.num_planes)
        e_pose = _pose_err(torch, gm.poses, g1.poses)
        e_plane = _pose_err(torch, pnm.planes[:P], pn1.planes[:P])
        e_chi2 = abs(float(sm.chi2_final) - float(s1.chi2_final)) / abs(float(s1.chi2_final))
        e_marg = float((mm - m1).norm() / m1.norm())
        K = g.poses.shape[0]
        print(f"[mesh_{label}] sharded_lm_optimize_soa_planes, K={K} (Kl={K // mesh.size}), {P} planes, "
              f"{int(pn.num_pe)} plane edges, prior {'with' if prior is not None else 'without'} a plane part, "
              f"marginals: {sm.iterations} LM iterations x {LM_STEPS} CG steps (one device {s1.iterations}), chi2 "
              f"{float(s1.chi2_initial):.7g} -> {float(sm.chi2_final):.7g} (one device {float(s1.chi2_final):.7g}, "
              f"rel {e_chi2:.3g}, bound {LM_RTOL:g}); poses within {e_pose:.3g}, planes {e_plane:.3g} of scale "
              f"(bound {LIN_RTOL:g}); marginals {e_marg:.3g} in norm (bound {LM_RTOL:g}); {msm:.3f} ms per LM "
              f"iteration on {mesh.size} ranks, {ms1:.3f} on one device (host clock, synced)")
        require(sm.iterations == s1.iterations > 0 and e_pose <= LIN_RTOL and e_plane <= LIN_RTOL
                and e_chi2 <= LM_RTOL and e_marg <= LM_RTOL, f"[mesh_{label}] the sharded plane LM differs")
        want = dict(one, fused_linearize=0, tiled_fused_linearize=one["tiled_fused_linearize"] + 1)
        print(f"[mesh_{label}] launches per rank {[[r[k] for k in TILED] for r in ranks]} of {list(TILED)} "
              f"(K6 + K7, K8, K9, K10); one device {[one[k] for k in TILED]} and K1 + K2 "
              f"{one['fused_linearize']} (the marginals' linearization, K6 + K7 on a rank)")
        require(all(one[k] > 0 for k in TILED) and one["fused_linearize"] == 1,
                f"[mesh_{label}] the one-device loop's launches: {one}")
        for r, got in enumerate(ranks):
            require(got == want, f"[mesh_{label}] rank {r}: launches {got}, expected {want}")
        out[label] = ranks
    return out


def _mesh_merge(torch, ckpts, mesh) -> None:
    """``joint_bundle_adjust`` of the lifecycle's two checkpoints on the
    mesh against one device: chi2 within LM_RTOL."""
    from semantic_slam_tpu_torch.config import PROFILES
    from semantic_slam_tpu_torch.io.checkpoint import load_checkpoint
    from semantic_slam_tpu_torch.runtime import multisession as ms
    from semantic_slam_tpu_torch.runtime.engine import SlamEngine

    engines = []
    for path in ckpts:
        e = SlamEngine(PROFILES["yolo_detector"], device=DEVICE)
        load_checkpoint(path, e)
        engines.append(e)
    merged, _ = ms.merge_graphs([e.graph for e in engines], [e.table for e in engines])
    g1, s1 = ms.joint_bundle_adjust(merged)
    gm, sm = ms.joint_bundle_adjust(merged, mesh=mesh)
    rel = abs(float(sm.chi2_final) - float(s1.chi2_final)) / abs(float(s1.chi2_final))
    print(f"[mesh_merge] joint BA of {int(merged.num_poses)} poses: one device chi2 {float(s1.chi2_initial):.7g} -> "
          f"{float(s1.chi2_final):.7g} ({s1.iterations} iterations), {mesh.size} ranks {float(sm.chi2_final):.7g} "
          f"({sm.iterations}); rel diff {rel:.3g} (bound {LM_RTOL:g})")
    require(rel <= LM_RTOL and math.isfinite(float(sm.chi2_final)), "[mesh_merge] the sharded merge differs")


def check_isolation() -> None:
    jaxish = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "__graft_entry__"
                    or m == "semantic_slam_tpu" or m.startswith("semantic_slam_tpu."))
    require(not jaxish, f"the JAX package or jax was imported: {jaxish[:8]}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "semantic_slam_tpu_torch")):
        print("chip_smoke: semantic_slam_tpu_torch/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 4
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    try:
        phase("card")
        card = card_info(torch)
        import semantic_slam_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
        from semantic_slam_tpu_torch import _build

        phase("build")
        t0 = time.perf_counter()
        libs = _build.build(verbose=True)
        for src in _build.sources():
            _build.library(src.stem)
        print(f"built {[os.path.relpath(p, ROOT) for p in libs]} in {time.perf_counter() - t0:.1f} s")

        phase("kernels against plain")
        k5 = check_score_hypotheses(torch)
        soa_k = check_soa_kernels(torch)
        tiled_k = check_tiled_kernels(torch)

        phase("two halves")
        check_two_halves(torch)

        phase("fixed-work LMs")
        check_fixed_lm(torch)

        phase("the fixed-lag prior")
        k4_prior = check_soa_prior(torch)
        check_fixed_lm_prior(torch)

        os.makedirs(OUT_DIR, exist_ok=True)
        from semantic_slam_tpu_torch import cli

        t0 = time.perf_counter()
        log = cli.make_synthetic_log(seed=0, n_steps=240, sensor_every=6, loops=1, H=480, W=640)
        print(f"synthetic log: {len(log.clouds)} clouds, {len(log.detections)} detection frames "
              f"({time.perf_counter() - t0:.1f} s on the host)")
        phase("dense slice on the card")
        dense = run_slice(torch, log, [], "dense")
        phase("pcg slice on the card")
        pcg = run_slice(torch, log, ["--solver", "pcg", "--max-keyframes", "4096"], "pcg")
        require(pcg["keyframes"] == dense["keyframes"] and pcg["loop"] == "resident",
                f"keyframes: pcg {pcg['keyframes']} != dense {dense['keyframes']}")
        require(pcg["k4_shapes"]["cluster"] == 0, f"pcg slice (K=4096): K4 left the grid shape: {pcg['k4_shapes']}")
        phase("tiled slice on the card")
        tiled = run_slice(torch, log, ["--solver", "pcg", "--max-keyframes", "8192"], "tiled")
        require(tiled["keyframes"] == dense["keyframes"] and tiled["loop"] == "tiled",
                f"keyframes: tiled {tiled['keyframes']} != dense {dense['keyframes']}")
        for r in (dense, pcg, tiled):  # free each engine before the next session
            del r["engine"]
        phase("session lifecycle on the card")
        life = check_lifecycle(torch, log)
        phase("the ROS surface on the card")
        check_ros_surface(torch, log, pcg)

        t0 = time.perf_counter()
        fl_log = cli.make_synthetic_log(**FL_LOG)
        print(f"fixed-lag log {FL_LOG}: {len(fl_log.clouds)} clouds, {len(fl_log.detections)} detection frames "
              f"({time.perf_counter() - t0:.1f} s on the host)")
        phase("fixed-lag dense slice on the card")
        fl_dense = run_slice(torch, fl_log, ["--fixed-lag", str(FL_WINDOW)], "fixed_lag_dense")
        del fl_dense["engine"]
        phase("fixed-lag pcg slice on the card")
        fl_pcg = run_slice(torch, fl_log, ["--fixed-lag", str(FL_WINDOW), "--solver", "pcg"], "fixed_lag_pcg")
        require(fl_pcg["keyframes"] == fl_dense["keyframes"] and fl_pcg["loop"] == "resident",
                f"keyframes: fixed-lag pcg {fl_pcg['keyframes']} != dense {fl_dense['keyframes']}")
        require(fl_pcg["k4_shapes"]["grid"] == 0,
                f"fixed-lag pcg slice (K=512): K4 left the cluster shape: {fl_pcg['k4_shapes']}")
        phase("fixed-lag session lifecycle on the card")
        check_lifecycle_fixed_lag(torch, fl_log, fl_pcg)
        del fl_pcg["engine"]
        n = fl_pcg["launches"]
        print(f"fixed-lag pcg session launches: K1 + K2 fused_linearize {n['fused_linearize']} (two kernel launches "
              f"each), K3 resident_chi2 {n['resident_chi2']}, K4 resident_solve {n['resident_solve']}")

        t0 = time.perf_counter()
        plane_log = cli.make_synthetic_log(**PLANE_LOG)
        print(f"plane log {PLANE_LOG}: {len(plane_log.clouds)} clouds, {len(plane_log.detections)} detection frames "
              f"({time.perf_counter() - t0:.1f} s on the host)")
        phase("plane slices on the card")
        planes = check_plane_slices(torch, plane_log, fl_log, fl_pcg)
        del fl_log
        phase("breadth on the card")
        check_breadth(torch, log, plane_log, planes["twin"], pcg, tiled)
        phase("several ranks on the card")
        mesh = check_mesh(torch, log, {"tiled": tiled, "life_checkpoints": life["checkpoints"],
                                       "planes": planes.pop("states")})
        del plane_log, log

        check_isolation()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    tiled_py = "semantic_slam_tpu/solver/pallas_tiled.py"

    def wrapper_of(name: str) -> str:
        return "fused_linearize" if name in PAIR else "tiled_fused_linearize" if name in TILED_PAIR else name

    meta = {  # name: (source, TPU kernel replaced, the session whose path runs it)
        "obs_linearize": ("soa_linearize.cu", "semantic_slam_tpu/solver/pallas_cg.py:603", pcg),
        "chain_linearize": ("soa_linearize.cu", "semantic_slam_tpu/solver/pallas_cg.py:747", pcg),
        "resident_chi2": ("soa_chi2.cu", "semantic_slam_tpu/solver/pallas_cg.py:920", pcg),
        # with its prior branch (pallas_cg.py:319-329, :420-442), on this slice's path
        "resident_solve": ("soa_solve.cu", "semantic_slam_tpu/solver/pallas_cg.py:230", fl_pcg),
        "score_hypotheses": ("score_hypotheses.cu", "semantic_slam_tpu/frontend/pallas_kernels.py:35", pcg),
        "tiled_obs_linearize": ("tiled_linearize.cu", f"{tiled_py}:154", tiled),
        "tiled_chain_linearize": ("tiled_linearize.cu", f"{tiled_py}:285", tiled),
        "tiled_mv_fwd": ("tiled_matvec.cu", f"{tiled_py}:323", tiled),
        "tiled_mv_bwd": ("tiled_matvec.cu", f"{tiled_py}:373", tiled),
        "tiled_chi2": ("tiled_chi2.cu", f"{tiled_py}:430", tiled),
    }
    numbers = {**soa_k, **tiled_k, "score_hypotheses": k5, "resident_solve": k4_prior}
    kernels_line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": f"semantic_slam_tpu_torch/csrc/{src}", "replaces": rep,
            # K1 and K2, and K6 and K7, launch only through the one wrapper of their pair on the path
            "launches": session["launches"][wrapper_of(name)],
            **{k: numbers[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **({"mesh_launches_per_rank": {label: [r[wrapper_of(name)] for r in ranks]
                                           for label, ranks in mesh["launches"].items()}}
               if name in MESH_KERNELS else {}),
            **{k: numbers[name][k] for k in ("device_ms", "device_us_per_step", "pair_device_ms", "window_D",
                                             "window_ms", "window_plain_ms", "window_device_ms", "window_bound_ms",
                                             "window_max_abs_err")
               if k in numbers[name]},
        }
        for name, (src, rep, session) in meta.items()
    ]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
