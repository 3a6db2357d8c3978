"""One run of one benchmark cell of the port ``semantic_slam_tpu_torch``:

    python3 -m slam_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run makes its inputs from the seed (``scene.py``), builds the port's
kernels (or finds them built in ``build/`` of the checkout), warms up on
the cell's own shapes, feeds the engine closed loop for ``--seconds``, and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a profiler trace of the
window and from host spans. Afterwards a sample of the window's ticks is
held to the plain reference (``check.py``); the numbers compared and their
limits are the last lines on standard error and the last key of the line.

The cell's configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), correctness limits (``limits/<cell>.json``)
and per-layer metrics (``metrics/<name>.py``) are found by name from
``BENCHMARK.json``. It exits with 2, and prints no result, where torch sees
no CUDA device or fewer than the cell asks for, and with 3 where JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "semantic_slam_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def p95(values: list[float]) -> float:
    """The 95th percentile (linear interpolation between order statistics)."""
    xs = sorted(values)
    k = 0.95 * (len(xs) - 1)
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def slam_config(config: dict, traffic: dict):
    """The engine's ``SlamConfig``: the profile, with the configuration's
    solver, capacity and segmentation keys and the mix's ingest window."""
    from semantic_slam_tpu_torch.config import PROFILES

    cfg = PROFILES[config["profile"]]
    solver = dataclasses.replace(cfg.solver, **config.get("solver", {}), ingest_window=traffic["ingest_window"])
    return cfg.replace(
        verbose=False, solver=solver, capacity=dataclasses.replace(cfg.capacity, **config["capacity"]),
        segmentation=dataclasses.replace(cfg.segmentation, **config.get("segmentation", {})),
    )


def _judge(stream, cfg, device):
    import numpy as np

    from slam_bench.check import Judge

    s, a = cfg.segmentation, cfg.association
    seg = {"smoothing_size": s.normal_smoothing_size, "crop_height": s.crop_height, "crop_width": s.crop_width,
           "max_planes": s.max_planes_per_detection, "num_hypotheses": s.num_hypotheses,
           "distance_thres": s.distance_thres, "cos_angular_thres": float(np.cos(np.deg2rad(s.angular_thres_deg))),
           "num_point_seg": s.num_point_seg, "planar_area": s.planar_area, "norm_point_thres": s.norm_point_thres}
    front = {"D": cfg.capacity.max_detections_per_frame, "cam_angle": cfg.camera_angle_rad,
             "strict": cfg.strict_reference_frames}
    return Judge(stream, seg, front, {"use_plane_gate": a.use_plane_gate}, device)


@dataclasses.dataclass
class Window:
    """What the window produced: ticks, sessions' ATE, keyframes, seconds."""

    ticks: list = dataclasses.field(default_factory=list)
    ate_cm: list = dataclasses.field(default_factory=list)
    keyframes: int = 0
    seconds: float = 0.0
    sessions: int = 0
    drive_ended: bool = False


class Sessions:
    """Traffic ``mode: sessions``: sessions back to back, each a fresh engine
    ended by ``finalize``, each replaying the same log under a world motion
    of its own (``scene.placed``). Set-up runs one whole session; ``ate_cm``
    is the mean over the sessions the window completes (one at least: a
    window that closes inside the first runs it on, untimed)."""

    def __init__(self, run):
        self.r = run
        self.last = None

    def warm(self) -> None:
        r = self.r
        engine = r.new_engine()
        for _ in r.feeder.ticks(engine, r.scene.placed(r.stream, r.seed, 0)):
            pass
        engine.finalize()

    def window(self, win: Window, take, expired) -> None:
        r = self.r
        while True:
            engine = r.new_engine()
            session = r.scene.placed(r.stream, r.seed, win.sessions + 1)
            ticks = r.feeder.ticks(engine, session)
            self.last = (engine, ticks, session)
            for tick in ticks:
                take(engine, tick)
                if expired():
                    return
            r.checker.disarm()
            n = len(engine.keyframes)
            engine.finalize()
            win.keyframes += len(engine.keyframes) - n
            win.sessions += 1
            win.ate_cm.append(r.feeder_mod.keyframe_ate_cm(engine, session))
            if expired():
                return

    def finish(self, win: Window) -> None:
        if win.ate_cm:
            return
        engine, ticks, session = self.last
        self.r.checker.disarm()
        for _ in ticks:
            pass
        engine.finalize()
        win.ate_cm.append(self.r.feeder_mod.keyframe_ate_cm(engine, session))


class Drive:
    """Traffic ``mode: drive``: one engine over the whole log. Set-up drives
    until the first marginalization has run; ``ate_cm`` is taken over the
    mix's ``ate_keyframes`` keyframes right after set-up, at the window's
    end (the drive runs on, untimed, to reach them)."""

    def __init__(self, run):
        self.r = run

    def warm(self) -> None:
        r = self.r
        self.engine = r.new_engine()
        self.gen = r.feeder.ticks(self.engine)
        for _ in self.gen:
            if self.engine._kf_base > 0:
                break
        self.n0 = len(self.engine.keyframes)

    def window(self, win: Window, take, expired) -> None:
        for tick in self.gen:
            take(self.engine, tick)
            if expired():
                return
        win.drive_ended = True

    def finish(self, win: Window) -> None:
        e, n0, S = self.engine, self.n0, self.r.traffic["ate_keyframes"]
        while len(e.keyframes) < n0 + S and not win.drive_ended:
            if next(self.gen, None) is None:
                win.drive_ended = True
        win.ate_cm.append(self.r.feeder_mod.keyframe_ate_cm(e, self.r.stream, e.keyframes[n0:n0 + S]))


MODES = {"sessions": Sessions, "drive": Drive}


def run_cell(cell: str, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
             limits: dict, per_layer: list | None = None, judge_low: bool = False) -> dict:
    """One run; returns the result (``correct``, ``metrics``, ``device``,
    ``checks``, ...). ``device`` "cpu" runs the kernels' plain versions (the
    tests); a chip run passes "cuda"."""
    import types

    import numpy as np
    import torch

    from semantic_slam_tpu_torch.runtime.engine import SlamEngine
    from slam_bench import check as check_mod
    from slam_bench import feeder as feeder_mod
    from slam_bench import scene as scene_mod
    from slam_bench import trace as trace_mod

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stderr = []
    t = time.perf_counter()
    if on_card:
        from semantic_slam_tpu_torch import _build

        _build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = slam_config(config, traffic)
    t_build = time.perf_counter()
    stream = scene_mod.make_stream(config["scene"], seed, dev)
    stderr.append(f"set-up: to here {t - T_PROCESS} s, build {t_build - t} s, inputs {time.perf_counter() - t_build} s")
    checker = check_mod.Checker(seed, traffic["check_every"], traffic["check_max"])
    feeder = feeder_mod.Feeder(stream, before_run=checker.before_run)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    ctx = types.SimpleNamespace(stream=stream, seed=seed, traffic=traffic, feeder=feeder, checker=checker,
                                scene=scene_mod, feeder_mod=feeder_mod, new_engine=lambda: SlamEngine(cfg, dev))
    mode = MODES[traffic["mode"]](ctx)
    win = Window()

    def take(engine, tick):
        checker.after_tick(engine.keyframes, tick["kf"], feeder.source)
        win.ticks.append(tick)
        win.keyframes += tick["kf"]

    with checker.installed():
        mode.warm()
        sync()
        setup_s = time.perf_counter() - T_PROCESS
        spans = trace_mod.Spans(on_card)
        traced = trace_mod.device_trace(dev) if trace and on_card else contextlib.nullcontext({})
        with (spans.installed() if trace else contextlib.nullcontext()), traced as found:
            checker.enabled = True
            t0 = time.perf_counter()
            mode.window(win, take, lambda: time.perf_counter() - t0 >= seconds)
            sync()
            win.seconds = time.perf_counter() - t0
            checker.enabled = False
        spans.resolve()
        mode.finish(win)
    engine = mode = ctx = None

    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    opt = [t["ms"] for t in win.ticks if t["iters"] > 0]
    metrics = {
        "kf_per_s": {"value": win.keyframes / win.seconds, "unit": "kf/s"},
        "ate_cm": {"value": float(np.mean(win.ate_cm)), "unit": "cm"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    if opt:
        metrics["tick_ms_p95"] = {"value": p95(opt), "unit": "ms"}
        stderr.append(f"optimizing ticks in the window: {len(opt)}, median {statistics.median(opt)} ms, "
                      f"p95 {p95(opt)} ms; all ticks {len(win.ticks)}; sessions completed {win.sessions}; "
                      f"keyframes {win.keyframes} in {win.seconds} s")
    if win.drive_ended:
        stderr.append("the drive ended inside the window")
    stderr.append(f"setup_s {setup_s}; window {win.seconds} s")
    for line in stderr:
        print(line, file=sys.stderr, flush=True)
    out_device = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": mem_peak}
    result = {"metrics": metrics, "device": out_device}
    if trace:
        from slam_bench.record import Record

        ops = found.get("ops", [])
        rec = Record(window_s=win.seconds, ticks=win.ticks, ops=ops, spans=spans.spans, cfg=cfg)
        out_device["busy_s"] = trace_mod.busy_us((s, e) for _, s, e in ops) / 1e6
        out_device["window_s"] = win.seconds
        layer = {}
        for m in per_layer or []:
            from slam_bench import registry

            v = registry.metric_reader(m["name"]).read(rec)
            if v is not None:
                layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = layer
        result["breakdown"] = trace_mod.breakdown(ops, spans)

    # the reference runs after the program's state is freed
    records = checker.records
    if on_card:
        torch.cuda.empty_cache()
    judge = _judge(stream, cfg, dev)
    numbers = judge.numbers(records)
    result["control"] = judge.numbers(records, prog=False, low=True) if judge_low else None
    ok, shown = check_mod.verdict(numbers, limits)
    result["correct"] = ok
    result["attempted"] = len(win.ticks)
    result["failed"] = 0 if ok else 1
    result["numbers"] = numbers
    result["checks"] = shown
    result["sampled_ticks"] = len(records)
    result["stderr"] = stderr
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slam_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    from slam_bench import registry

    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from slam_bench import check as check_mod

    per_layer = registry.cell_metrics(bench, cell["name"], "per_layer") if args.trace else None
    res = run_cell(cell["name"], registry.config(cell["config"]), registry.traffic(cell["traffic"]), args.seed,
                   args.seconds, bool(args.trace), "cuda", check_mod.load_limits(cell["name"]), per_layer)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process, which must not load them: {bad}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    print(f"correct: {res['correct']} over {res['sampled_ticks']} sampled ticks", file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    if not args.trace:
        names = [m["name"] for m in registry.cell_metrics(bench, cell["name"], "end_to_end")]
        res["metrics"] = {k: v for k, v in res["metrics"].items() if k in names}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": res["device"]}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
