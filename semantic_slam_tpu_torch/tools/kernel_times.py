#!/usr/bin/env python3
"""Device times of K1-K3 (the resident loop's linearization and objective),
K4 (the resident Schur-PCG solve), K6 and K7 (the row-range linearization),
K9 (the row-range matvec's per-pose half) and K10 (the row-range objective)
on one NVIDIA GPU, for this checkout or another one.

    python semantic_slam_tpu_torch/tools/kernel_times.py [--root DIR] [--split] [--sweep] --out FILE
    python semantic_slam_tpu_torch/tools/kernel_times.py --baseline DIR --out FILE

``--root DIR`` measures the package of the checkout at DIR (default: this
one) through its own wrappers, built from its own sources. The shapes are
``chip_smoke.py``'s (imported from DIR): the pair K1 + K2 as the LM calls it
(``kernels.resident_linearize``: one entry point of two launches, or in
older checkouts K2's launches and then K1's), K1 alone on given chain
blocks, K2 alone where a checkout still has it, and K3, on the perturbed
graphs of the fixed-lag pcg session (K=512, L=128, R=32) and of the pcg
session (K=4096, L=1024, R=32), under robust none, huber and dcs; K4 with
the marginalized fixed-lag prior at the fixed-lag session's graph (K=512,
L=128, R=32) and at the pcg session's (K=4096, L=1024, R=32), also without
the prior, at 128 and at 0 fixed CG steps (the difference over 128 is the
time of a step); the pair K6 + K7 as the row-range loop calls it
(``tiled_kernels.tiled_linearize``: one entry point of two launches, or in
older checkouts K7's launches and then K6's), K6 alone on given chain
blocks, K7 as the pair less K6 alone (and by its own launches where a
checkout still has them), on all rows of the tiled session's graph (K=8192,
L=2048, R=32) and on rows [K/2, K) (Kl=4096); K9 on all its rows; and K10
on all rows of that graph and of the bench graph (R=4), under robust none,
huber and dcs.
Device time is the sum of the kernels' own intervals in a
``torch.profiler`` trace of ``--reps`` calls; event time is CUDA events
around the same calls (the wrapper's host work between launches included).

``--split`` also times copies of K4's source with one phase body emptied
(the early exit off, so that every copy runs all steps): what a step spends
per phase, and in barriers and reductions alone (every body emptied).

``--sweep`` also times the pair K1 + K2, K3, K6 alone and the pair K6 + K7
under other launch splits (slots a block RB, slot groups a block G) than
``kernels.lin_split`` picks, where the checkout runs K2 in K1's launches (and
K7 in K6's, for the pair K6 + K7).

``--sessions`` also replays the fixed-lag pcg session (chip_smoke.py's
``FL_LOG`` with ``--fixed-lag 64 --solver pcg``) and the tiled one (the
240-step log with ``--solver pcg --max-keyframes 8192``) once to warm up and
once under a ``torch.profiler`` trace of the device alone, and writes each
hand-written kernel's launches and summed device ms in the session, and
those of every other kernel together. With ``--plane-landmarks`` it replays
chip_smoke.py's plane sessions in their place: the 240-step log with
``--plane-landmarks --solver pcg --max-keyframes 4096`` (K6-K10 with the
plane half at K=4096) and ``FL_LOG`` with ``--plane-landmarks --fixed-lag 64
--solver pcg`` (K6-K10 at K=512 with a prior that has a plane part).

``--baseline DIR`` runs this script on DIR and on this checkout in turns
(baseline, this, this, baseline), each in a process of its own, and writes
both sides' numbers. Every number comes with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))
# kernel names a wrapper launches, in either version of the sources
K4_NAMES = ("solve_kernel", "solve_cluster_kernel", "solve_grid_kernel")
K9_NAMES = ("rows_mvb_pose",)
K1_NAMES = ("pose_kernel", "landmark_kernel", "reduce2_kernel", "lin_slots_kernel", "lin_fold_kernel")
K2_NAMES = ("chain_kernel", "reduce2_kernel")
PAIR_NAMES = tuple(dict.fromkeys(K1_NAMES + K2_NAMES))
K3_NAMES = ("chi2_kernel", "reduce2_kernel", "chi2_slots_kernel")
K6_NAMES = ("rows_obs_pose", "rows_obs_lm", "reduce2_kernel", "rows_lin_slots", "rows_lin_fold")
K7_NAMES = ("rows_chain", "reduce2_kernel")
TILED_PAIR_NAMES = tuple(dict.fromkeys(K6_NAMES + K7_NAMES))
K10_NAMES = ("rows_chi2", "rows_chi2_slots", "reduce2_kernel")
LIN_SHAPES = (("K=512 L=128 R=32", "FL_ENGINE"), ("K=4096 L=1024 R=32", "BENCH"))
# the tiled session's graph: all rows, and rows [K/2, K)
K6_SHAPES = (("Kl=8192 L=2048 R=32", 0), ("Kl=4096 L=2048 R=32 rows [K/2, K)", 1))
# K10 on all rows of the tiled session's graph (R=32) and of the bench graph (R=4)
K10_SHAPES = (("Kl=8192 L=2048 R=32", 32), ("Kl=8192 L=2048 R=4", 4))
# splits (RB slots a block, G slot groups a block) tried by --sweep: the pair
# and K3 at each of LIN_SHAPES, K6 at each of K6_SHAPES
SWEEP = {
    "K=512 L=128 R=32": ((2, 2), (3, 3), (4, 4), (8, 8), (16, 8), (32, 8)),
    "K=4096 L=1024 R=32": ((4, 4), (8, 8), (16, 4), (16, 8), (32, 4), (32, 8)),
    "Kl=8192 L=2048 R=32": ((4, 4), (8, 8), (16, 4), (16, 8), (32, 4), (32, 8)),
    "Kl=4096 L=2048 R=32 rows [K/2, K)": ((4, 4), (8, 8), (16, 4), (16, 8), (32, 4), (32, 8)),
}
# phase anchors of K4's source: (anchor, text after it, replacement); the
# first set is the earlier single-shape kernel's, the second the two-shape one's
SPLIT_EDITS = (
    {
        "A": [("// a. per slot", "e < E;", "e < (SKIP_A ? 0 : E);")],
        "B": [("// b. per landmark", "l < L;", "l < (SKIP_B ? 0 : L);")],
        "C": [("// c. per pose (K9)", "k < K;", "k < (SKIP_C ? 0 : K);")],
        "D": [("// d. per pose:", "k < K;", "k < (SKIP_D ? 0 : K);")],
    },
    {
        "A": [("// a. p = z + beta p", "slots_fwd<CLUSTER>(A, loc, k0, nk);", "if (!SKIP_A) slots_fwd<CLUSTER>(A, loc, k0, nk);")],
        "B": [("// b. per landmark: z_l", "l < L;", "l < (SKIP_B ? 0 : L);")],
        "C": [("// c. per pose", "float pap = pose_rows", "float pap = SKIP_C ? 0.f : pose_rows")],
        "D": [("// d. per own pose", "t < 6 * nk;", "t < (SKIP_D ? 0 : 6 * nk);"),
              ("float part[2] = {0.f, 0.f};  // r.z, r.r", "t < 6 * nk;", "t < (SKIP_D ? 0 : 6 * nk);")],
    },
)
EARLY_EXIT = "if (!(rr > A.tol * b2)) break;"
VARIANTS = {"full": "", "no a": "A", "no b": "B", "no c": "C", "no d": "D", "barriers only": "ABCD"}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def device_ms(torch, fn, names, reps: int, per_kernel: dict | None = None) -> tuple[float, float]:
    """(device ms, CUDA-event ms) per call of ``fn`` over ``reps`` calls after
    warm-up; device ms sums the intervals of the kernels named ``names``, and
    ``per_kernel``, where given, receives each kernel's own ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    for _ in range(3):  # traced again while a trace holds none of the kernels' events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(f"{n}(" in e.name for n in names)]
        if evs:
            break
    # each kernel launches at most once a call; the mean per kernel name, summed,
    # also holds where the trace dropped some events
    by_name = {}
    for e in evs:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        raise RuntimeError(f"no kernel events of {names} in a trace of {reps} calls")
    means = {next(n for n in names if f"{n}(" in name): sum(v) / len(v) / 1e3 for name, v in by_name.items()}
    if per_kernel is not None:
        per_kernel.update(means)
    return sum(means.values()), event_ms


def _variant_libs(root: str, build_dir: str) -> dict:
    """K4's source at ``root`` with phase bodies emptied, built in parallel."""
    src_dir = os.path.join(root, "semantic_slam_tpu_torch", "csrc")
    src = open(os.path.join(src_dir, "soa_solve.cu")).read()
    edits = next(e for e in SPLIT_EDITS if all(a in src for edit in e.values() for a, _, _ in edit))

    def cut(text, anchor, old, new):
        i = text.index(anchor)
        j = text.index(old, i)
        return text[:j] + new + text[j + len(old):]

    src = src.replace(EARLY_EXIT, "if (!(SKIP_A || SKIP_B || SKIP_C || SKIP_D) && !(rr > A.tol * b2)) break;")
    for phase_edits in edits.values():
        for anchor, old, new in phase_edits:
            src = cut(src, anchor, old, new)
    src = src.replace('#include "soa_common.cuh"', f'#include "{src_dir}/soa_common.cuh"')
    path = os.path.join(build_dir, "soa_solve_split.cu")
    with open(path, "w") as f:
        f.write(src)
    from semantic_slam_tpu_torch import _build

    procs = {}
    for name, skip in VARIANTS.items():
        lib = os.path.join(build_dir, f"libsplit_{name.replace(' ', '_')}.so")
        defs = [f"-DSKIP_{p}={int(p in skip)}" for p in "ABCD"]
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", lib, path]))
    libs = {}
    for name, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the variant {name!r}")
        cdll = ctypes.CDLL(lib)
        for fn, (argtypes, restype) in _build.SIGNATURES["soa_solve"].items():
            getattr(cdll, fn).argtypes, getattr(cdll, fn).restype = argtypes, restype
        cdll.slam_cuda_error_string.argtypes, cdll.slam_cuda_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = cdll
    return libs


def _sms(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _timed(torch, out: dict, key: str, fn, names, reps: int, smi: str, **extra) -> dict:
    per = {}
    dev, ev = device_ms(torch, fn, names, reps, per)
    out[key] = {"device_ms": dev, "event_ms": ev, "per_kernel_ms": per, **extra}
    split = ", ".join(f"{n} {t:.5f}" for n, t in per.items())
    print(f"{key}: device {dev:.5f} ms ({split}), event {ev:.5f} ms ({smi})", flush=True)
    return out[key]


def _with_split(kernels, sp):
    """``kernels.lin_split`` fixed to ``sp`` inside the block (a context)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        rule = kernels.lin_split
        kernels.lin_split = lambda K, R, sms, chain=True: sp
        try:
            yield
        finally:
            kernels.lin_split = rule

    return ctx()


def measure_lin(torch, cs, kernels, reps: int, sweep: bool, smi: str) -> dict:
    """The pair K1 + K2, K1 alone, K2 alone (where it exists) and K3 at
    LIN_SHAPES: device and event ms (and, with ``sweep``, the pair and K3
    under other launch splits)."""
    from semantic_slam_tpu_torch.solver import ellk_soa as soa

    out = {}
    fused = hasattr(kernels, "fused_linearize")
    for label, shape in LIN_SHAPES:
        g, se, _, _, _ = cs._soa_case(torch, **getattr(cs, shape), R=cs.ENGINE_R, perturb=True)
        K = g.poses.shape[0]
        cp = soa.soa_chain_linearize(g.poses, se)
        split = list(kernels.lin_split(K, cs.ENGINE_R, _sms(torch)))  # the pair's (and K1 alone's)
        for kind in ("none", "huber", "dcs"):
            pair = _timed(torch, out, f"K1+K2 {kind} [{label}]",
                          lambda kind=kind: kernels.resident_linearize(g.poses, g.landmarks, se, kind), PAIR_NAMES,
                          reps, smi, split=split)
            k1 = _timed(torch, out, f"K1 {kind} [{label}]",
                        lambda kind=kind: kernels.obs_linearize(g.poses, g.landmarks, se, cp, kind), K1_NAMES, reps,
                        smi, split=split)
            if fused:  # K2 has no launch of its own: the pair less K1 alone
                k2 = out[f"K2 {kind} [{label}]"] = {"device_ms": pair["device_ms"] - k1["device_ms"],
                                                     "event_ms": pair["event_ms"] - k1["event_ms"]}
                print(f"K2 {kind} [{label}]: the pair less K1 alone, device {k2['device_ms']:.5f} ms ({smi})",
                      flush=True)
            elif kind == "none":
                _timed(torch, out, f"K2 [{label}]", lambda: kernels.chain_linearize(g.poses, se), K2_NAMES, reps, smi)
            _timed(torch, out, f"K3 {kind} [{label}]",
                   lambda kind=kind: kernels.resident_chi2(g.poses, g.landmarks, se, kind), K3_NAMES, reps, smi,
                   split=list(kernels.lin_split(K, cs.ENGINE_R, _sms(torch), **({"chain": False} if fused else {}))))
        if not (sweep and fused):
            continue
        for sp in SWEEP[label]:
            with _with_split(kernels, sp):
                _timed(torch, out, f"K1+K2 none [{label}] split {sp}",
                       lambda: kernels.resident_linearize(g.poses, g.landmarks, se), PAIR_NAMES, reps, smi)
                _timed(torch, out, f"K3 none [{label}] split {sp}",
                       lambda: kernels.resident_chi2(g.poses, g.landmarks, se), K3_NAMES, reps, smi)
    return out


def measure_tiled(torch, cs, kernels, tk, sd, reps: int, sweep: bool, smi: str) -> dict:
    """The pair K6 + K7 as the row-range loop calls it (``tiled_linearize``:
    one entry point of two launches, or in older checkouts K7's launches and
    then K6's), K6 alone on the plain chain blocks, K7 (the pair less K6
    alone; and its own launches where a checkout still has them) at
    K6_SHAPES, and K10 at K10_SHAPES under robust none, huber and dcs (and,
    with ``sweep``, K6 alone and the pair under other launch splits)."""
    out = {}
    fused = hasattr(tk, "tiled_fused_linearize")
    g, _, _, _, R = cs._soa_case(torch, **cs.TILED_BENCH, R=cs.ENGINE_R, perturb=True)
    K = cs.TILED_BENCH["K"]
    for label, half in K6_SHAPES:
        rr = cs.RowRange(torch, g, R, K // 2 if half else 0, K // 2 if half else K)
        cp = sd.chain_plain(rr.pc, rr.pj, rr.de)
        fn = lambda: tk.tiled_obs_linearize(rr.pc, g.landmarks, rr.de, cp)  # noqa: E731
        # this checkout's K6 alone takes the pair's split; the parent's took the split without chain blocks
        split = list(kernels.lin_split(rr.Kl, R, _sms(torch), chain=fused))
        pair = _timed(torch, out, f"K6+K7 none [{label}]",
                      lambda: tk.tiled_linearize(rr.pc, rr.pj, g.landmarks, rr.de), TILED_PAIR_NAMES, reps, smi,
                      split=split)
        k6 = _timed(torch, out, f"K6 none [{label}]", fn, K6_NAMES, reps, smi, split=split)
        k7 = out[f"K7 none [{label}]"] = {"device_ms": pair["device_ms"] - k6["device_ms"],
                                          "event_ms": pair["event_ms"] - k6["event_ms"]}
        print(f"K7 none [{label}]: the pair less K6 alone, device {k7['device_ms']:.5f} ms ({smi})", flush=True)
        if not fused:
            _timed(torch, out, f"K7 own launches [{label}]", lambda: tk.tiled_chain_linearize(rr.pc, rr.pj, rr.de),
                   K7_NAMES, reps, smi)
        if sweep:
            for sp in SWEEP[label]:
                with _with_split(kernels, sp):
                    _timed(torch, out, f"K6 none [{label}] split {sp}", fn, K6_NAMES, reps, smi)
                    if fused:
                        _timed(torch, out, f"K6+K7 none [{label}] split {sp}",
                               lambda: tk.tiled_linearize(rr.pc, rr.pj, g.landmarks, rr.de), TILED_PAIR_NAMES, reps,
                               smi)
    for label, R10 in K10_SHAPES:
        g10, _, _, _, _ = cs._soa_case(torch, **cs.TILED_BENCH, R=R10, perturb=True)
        rr = cs.RowRange(torch, g10, R10, 0, K)
        for kind in ("none", "huber", "dcs"):
            _timed(torch, out, f"K10 {kind} [{label}]",
                   lambda kind=kind: tk.tiled_chi2(rr.pc, rr.pj, g10.landmarks, rr.de, kind), K10_NAMES, reps, smi)
    return out


# every hand-written kernel of either version of the sources, for --sessions
SESSION_NAMES = tuple(dict.fromkeys(K1_NAMES + K2_NAMES + K3_NAMES + K4_NAMES + TILED_PAIR_NAMES + K10_NAMES + (
    "rows_mvf_slot", "rows_mvf_lm", "rows_mvb_pose", "score_kernel")))


def measure_sessions(torch, cs, smi: str, planes: bool = False) -> dict:
    """Launches and summed device ms of each hand-written kernel, and of the
    other kernels together, in the fixed-lag pcg and tiled sessions, or with
    ``planes`` the plane pcg and plane fixed-lag pcg sessions (one warm-up
    replay, then one traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semantic_slam_tpu_torch import cli

    tiled_log = dict(seed=0, n_steps=240, sensor_every=6, loops=1, H=480, W=640)
    sessions = {"fixed-lag pcg": (cs.FL_LOG, ["--fixed-lag", str(cs.FL_WINDOW), "--solver", "pcg"]),
                "tiled": (tiled_log, ["--solver", "pcg", "--max-keyframes", "8192"])}
    if planes:
        sessions = {"plane pcg": (tiled_log, ["--plane-landmarks", "--solver", "pcg", "--max-keyframes", "4096"]),
                    "plane fixed-lag pcg": (cs.FL_LOG, ["--plane-landmarks", "--fixed-lag", str(cs.FL_WINDOW),
                                                        "--solver", "pcg"])}
    out = {}
    for label, (log_kw, extra) in sessions.items():
        log = cli.make_synthetic_log(**log_kw)
        cfg = cli.make_config(cli.build_parser().parse_args(
            ["run", "--log", "in-process", "--profile", "yolo_detector", "--device", "cuda", *extra]))
        cli.run_session(log, cfg, "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine = cli.run_session(log, cfg, "cuda")
            torch.cuda.synchronize()
        row = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            name = next((n for n in SESSION_NAMES if f"{n}(" in e.name), "other kernels")
            launches, ms = row.get(name, (0, 0.0))
            row[name] = (launches + 1, ms + e.time_range.elapsed_us() / 1e3)
        if not row:
            raise RuntimeError(f"no hand-written kernel events in the trace of the {label} session")
        out[label] = {"lm_iterations": [s["iterations"] for s in engine.stats_history],
                      "kernels": {n: {"launches": c, "device_ms": t} for n, (c, t) in row.items()}}
        print(f"session [{label}]: " + ", ".join(f"{n} {c} launches {t:.4f} ms" for n, (c, t) in row.items())
              + f" ({smi})", flush=True)
    return out


def measure(root: str, reps: int, split: bool, sweep: bool, sessions: bool = False, planes: bool = False) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import semantic_slam_tpu_torch  # noqa: F401  (full-f32 matmuls)
    from semantic_slam_tpu_torch import _build
    from semantic_slam_tpu_torch.solver import ellk_soa as soa
    from semantic_slam_tpu_torch.solver import kernels
    from semantic_slam_tpu_torch.solver import soa_dist as sd
    from semantic_slam_tpu_torch.solver import tiled_kernels as tk
    from semantic_slam_tpu_torch.solver.pcg import apply_prior_blocks

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    _build.build()
    out = {"root": root, "card": card(), "k4": {}, "k9": {}}
    out["lin"] = measure_lin(torch, cs, kernels, reps, sweep, out["card"])
    out["tiled"] = measure_tiled(torch, cs, kernels, tk, sd, reps, sweep, out["card"])
    cases = {}
    for label, shape in (("K=512 L=128 R=32", cs.FL_ENGINE), ("K=4096 L=1024 R=32", cs.BENCH)):
        g, se, pf, lf, prior, _, R = cs._prior_case(torch, **shape, R=cs.ENGINE_R)
        lin = apply_prior_blocks(soa.soa_linearize(g.poses, g.landmarks, se), prior, g.poses, g.landmarks)
        cases[label] = (lin, se, cs._init_lambda(torch, lin), pf, lf, prior)
    for label, (lin, se, lam, pf, lf, prior) in cases.items():
        for with_prior in (True, False):
            pr = (prior.Hp, prior.p_idx) if with_prior else ()
            row = {}
            for n in (128, 0):
                row[n] = device_ms(torch, lambda: kernels.resident_solve(lin, se, lam, pf, lf, n, 0.0, *pr),
                                   K4_NAMES, reps)
            key = f"{label}{' prior' if with_prior else ''}"
            out["k4"][key] = {"device_ms": row[128][0], "event_ms": row[128][1], "device_ms_0_steps": row[0][0],
                              "device_us_per_step": (row[128][0] - row[0][0]) / 128 * 1e3}
            print(f"K4 [{key}]: {json.dumps(out['k4'][key])} ({out['card']})", flush=True)
    g, _, _, _, R = cs._soa_case(torch, **cs.TILED_BENCH, R=cs.ENGINE_R, perturb=True)
    K = cs.TILED_BENCH["K"]
    rr = cs.RowRange(torch, g, R, 0, K)
    lp = sd.obs_plain(rr.pc, g.landmarks, rr.de, sd.chain_plain(rr.pc, rr.pj, rr.de))
    x = torch.randn(6, K, generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    xj = torch.cat([x[:, 1:], x[:, :1]], dim=1)
    Op, Tp = sd.mv_fwd_plain(lp, rr.de, x)
    z = torch.linalg.solve(lp.Hll + torch.eye(3, device="cuda"), Tp[..., None])[..., 0]
    dev, ev = device_ms(torch, lambda: tk.tiled_mv_bwd(lp, rr.de, Op, z, x, xj), K9_NAMES, 10 * reps)
    out["k9"]["K=8192 L=2048 R=32"] = {"device_ms": dev, "event_ms": ev}
    print(f"K9 [K=8192 L=2048 R=32]: device {dev:.5f} ms, event {ev:.5f} ms ({out['card']})", flush=True)

    if sessions:
        out["sessions"] = measure_sessions(torch, cs, out["card"], planes)
    if split:
        out["split"] = {}
        with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
            libs = _variant_libs(root, tmp)
            real = _build._libs.get("soa_solve")
            try:
                for label, (lin, se, lam, pf, lf, prior) in cases.items():
                    for name, lib in libs.items():
                        _build._libs["soa_solve"] = lib
                        t = {n: device_ms(torch, lambda: kernels.resident_solve(lin, se, lam, pf, lf, n, 0.0, prior.Hp,
                                                                                  prior.p_idx), K4_NAMES, reps)[0]
                             for n in (128, 0)}
                        us = (t[128] - t[0]) / 128 * 1e3
                        out["split"][f"{label} prior, {name}"] = us
                        print(f"K4 split [{label} prior, {name}]: {us:.3f} us per step", flush=True)
            finally:
                _build._libs["soa_solve"] = real
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=THIS_ROOT, help="checkout whose package is measured")
    ap.add_argument("--baseline", help="another checkout, measured in turns with this one")
    ap.add_argument("--split", action="store_true", help="also the per-phase split of a K4 step")
    ap.add_argument("--sweep", action="store_true", help="also K1 + K2, K3, K6 and K6 + K7 under other launch splits")
    ap.add_argument("--sessions", action="store_true",
                    help="also each kernel's launches and device ms in the fixed-lag pcg and tiled sessions")
    ap.add_argument("--plane-landmarks", action="store_true",
                    help="with --sessions: the plane pcg and plane fixed-lag pcg sessions instead")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", required=True, help="JSON file to write")
    args = ap.parse_args()
    if args.plane_landmarks and (args.baseline or not args.sessions):
        ap.error("--plane-landmarks goes with --sessions and without --baseline (a parent may have no planes)")
    if not args.baseline:
        res = measure(os.path.abspath(args.root), args.reps, args.split, args.sweep, args.sessions,
                      args.plane_landmarks)
    else:
        runs = []
        for i, root in enumerate((args.baseline, THIS_ROOT, THIS_ROOT, args.baseline)):
            part = f"{args.out}.{i}"
            cmd = [sys.executable, os.path.abspath(__file__), "--root", os.path.abspath(root), "--reps",
                   str(args.reps), "--out", part] + (["--split"] if args.split and i in (0, 1) else []) + (
                       ["--sweep"] if args.sweep and i in (0, 1) else []) + (
                       ["--sessions"] if args.sessions and i in (0, 1) else [])
            print(f"== {' '.join(cmd)}", flush=True)
            subprocess.run(cmd, check=True)
            with open(part) as f:
                runs.append(json.load(f))
        res = {"order": ["baseline", "this", "this", "baseline"], "runs": runs}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
