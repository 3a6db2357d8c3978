"""CUDA kernel launches an optimizing tick: every kernel in the traced
window (eager PyTorch operations and the hand-written kernels; no copies
or sets), over the window's optimizing ticks."""

READS = ("device_trace",)


def read(rec):
    n = len(rec.optimizing_ticks())
    kernels = rec.kernels()
    return len(kernels) / n if n and kernels else None
