"""Observability: timers, counters and a profiler trace (port of
``semantic_slam_tpu.utils.profiling``).

``Metrics`` and ``log_optimize`` are copies of the JAX package's jax-free
originals (``tests/test_torch_isolation.py`` holds them equal). The trace
context is the port's own: the JAX package captures an XLA profiler trace,
the port a ``torch.profiler`` trace of the host and, on a machine with a
card, its CUDA activity (every kernel launch and copy), written as a Chrome
trace file. The per-layer breakdowns of a session are in
``semantic_slam_tpu_torch.profile_slice``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

TRACE_FILE = "trace.json"


class Metrics:
    """Lightweight accumulating timers/counters (host-side)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def summary(self) -> dict:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(set(self.totals) | set(self.counts))
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block: host operators and,
    when torch sees a CUDA device, the card's kernels and copies. On exit it
    writes ``<log_dir>/trace.json`` (Chrome trace format: chrome://tracing
    or ui.perfetto.dev) and yields nothing else."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def log_optimize(verbose: bool, stats, solve_seconds: float, num_nodes: int, num_edges: int) -> None:
    """The reference's verbose optimize print (graph_slam.cpp:188-216)."""
    if not verbose or int(stats.iterations) == 0:
        return
    print(
        "--- pose graph optimization ---\n"
        f"nodes: {num_nodes}   edges: {num_edges}\n"
        f"iterations: {int(stats.iterations)}\n"
        f"chi2: (before){float(stats.chi2_initial):.6g} -> "
        f"(after){float(stats.chi2_final):.6g}\n"
        f"time: {solve_seconds:.3f}[sec]"
    )


# each kernel wrapper counts the calls that launch its kernel in ``.launches``
KERNEL_WRAPPERS = (
    ("score_hypotheses", "semantic_slam_tpu_torch.frontend.kernels"),
    ("fused_linearize", "semantic_slam_tpu_torch.solver.kernels"),
    ("obs_linearize", "semantic_slam_tpu_torch.solver.kernels"),
    ("resident_chi2", "semantic_slam_tpu_torch.solver.kernels"),
    ("resident_solve", "semantic_slam_tpu_torch.solver.kernels"),
    ("tiled_fused_linearize", "semantic_slam_tpu_torch.solver.tiled_kernels"),
    ("tiled_obs_linearize", "semantic_slam_tpu_torch.solver.tiled_kernels"),
    ("tiled_mv_fwd", "semantic_slam_tpu_torch.solver.tiled_kernels"),
    ("tiled_mv_bwd", "semantic_slam_tpu_torch.solver.tiled_kernels"),
    ("tiled_chi2", "semantic_slam_tpu_torch.solver.tiled_kernels"),
)


def kernel_launches(reset: bool = False) -> dict[str, int]:
    """This process's kernel launch counters by wrapper (read, then set to
    0 if ``reset``)."""
    import importlib

    out = {}
    for name, mod in KERNEL_WRAPPERS:
        w = getattr(importlib.import_module(mod), name)
        out[name] = w.launches
        if reset:
            w.launches = 0
    return out


def mesh_kernel_launches(mesh, payload: dict, reset: bool = False) -> dict[str, int]:
    """``kernel_launches`` on a rank of a mesh (``Mesh.run(...,
    gather=True)`` collects every rank's)."""
    return kernel_launches(reset)
