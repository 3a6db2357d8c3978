"""The reference's verbose optimize print (the port's copy of
``log_optimize`` from ``semantic_slam_tpu.utils.profiling``; the port's
timing and tracing live in ``semantic_slam_tpu_torch.profile_slice``)."""

from __future__ import annotations


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
