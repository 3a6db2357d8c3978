"""What a ``--trace 1`` run reads: the device's operations from a
``torch.profiler`` trace of the window (CUDA activity only, read in memory;
no trace file is written), and host spans placed from the benchmark's side
around calls into the program's layers.

A span wraps a module-level function of the port, looked up through its
module at call time (as the port's ``profile_slice`` does), so nothing in
the program changes. A span never synchronizes the device, so that the
traced window keeps the program's own overlap of host and device work and
its idle share is the program's: on the card it records a CUDA event at
the call and at the return, and ``Spans.resolve`` (after the window's
closing synchronization) takes as the call's time the longer of the host's
(call to return) and the device's (the first event to the second, where
the call's device work outlasts its return). What a span reads of the
program's device state is kept on the device and read in ``resolve``.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

# span name -> the (module, function) it wraps
SPANS = {
    "frontend.window": ("semantic_slam_tpu_torch.runtime.engine", "_process_keyframes_window"),
    "frontend.keyframe": ("semantic_slam_tpu_torch.runtime.engine", "_process_keyframe"),
    "segment": ("semantic_slam_tpu_torch.runtime.engine", "_segment_only"),
    "optimize": ("semantic_slam_tpu_torch.runtime.engine", "_optimize_tick"),
    "lm.pcg": ("semantic_slam_tpu_torch.solver.ellk_soa", "lm_optimize_soa"),
    "marginalize": ("semantic_slam_tpu_torch.solver.fixed_lag", "marginalize"),
}


COUNTS = ("poses", "landmarks", "odom_edges", "lm_edges")


def _graph_counts(g) -> dict:
    """The graph's live sizes, as device scalars copied (no kernel, no
    synchronization); ``resolve`` reads them."""
    return dict(zip(COUNTS, (t.clone() for t in (g.num_poses, g.num_landmarks, g.num_odom, g.num_lme))))


def _launches() -> dict:
    from semantic_slam_tpu_torch.utils.profiling import kernel_launches

    return kernel_launches()


def _info_before(name, args, kwargs) -> dict:
    """What a span records on entry, besides its times."""
    if name == "frontend.window":
        return {"rows": int(kwargs["odoms"].shape[0])}
    if name == "segment":
        cids = kwargs["class_ids"] if "class_ids" in kwargs else args[5]
        boxes = kwargs["boxes"] if "boxes" in kwargs else args[4]
        return {"detections": cids, "rows": int(boxes.reshape(-1, boxes.shape[-2], 4).shape[0])}
    if name == "lm.pcg":
        return {"counts": _graph_counts(args[0] if args else kwargs["g"]), "launches0": _launches()}
    return {}


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Spans:
    """Host spans: ``spans[name]`` lists one dict a call, with ``t0`` and
    ``t1`` (``time.time_ns`` at the call and at its return), after
    ``resolve`` ``s`` (the call's seconds), and what ``_info_before``
    records. ``on_card``: record CUDA events beside the host times."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.spans: dict[str, list[dict]] = {name: [] for name in SPANS}

    def _event(self):
        if not self.on_card:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            info = _info_before(name, args, kwargs)
            info["t0"] = time.time_ns()
            info["e0"] = self._event()
            out = fn(*args, **kwargs)
            info["e1"] = self._event()
            info["t1"] = time.time_ns()
            if "launches0" in info:
                after = _launches()
                info["launches"] = {k: after[k] - v for k, v in info.pop("launches0").items()}
            self.spans[name].append(info)
            return out

        return spanned

    def resolve(self) -> None:
        """Each call's seconds and device readings, once the device has
        finished the window's work."""
        for calls in self.spans.values():
            for c in calls:
                e0, e1 = c.pop("e0"), c.pop("e1")
                host = (c["t1"] - c["t0"]) / 1e9
                c["s"] = max(host, e0.elapsed_time(e1) / 1e3) if e0 is not None else host
                if "counts" in c:
                    c["counts"] = {k: int(v) for k, v in c["counts"].items()}
                if isinstance(c.get("detections"), torch.Tensor):
                    c["detections"] = int((c["detections"] >= 0).sum())

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for name, (mod_name, attr) in SPANS.items():
                mod = importlib.import_module(mod_name)
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, self._wrap(name, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


def _kineto_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every device operation of the trace."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                s = e.start_ns() / 1e3
                out.append((e.name(), s, s + e.duration_ns() / 1e3))
        return out
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


@contextlib.contextmanager
def device_trace(device):
    """Yields a dict; on exit it holds ``ops``: (name, start us, end us) of
    each device operation in the block (kernels, copies, sets)."""
    from torch.profiler import ProfilerActivity, profile

    found: dict = {}
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        yield found
    finally:
        torch.cuda.synchronize(device)
        prof.stop()
    found["ops"] = _kineto_events(prof)


def breakdown(ops, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps between device operations, each named by the host span open
    at its middle (``host`` where none is: the feeder, the engine's host
    loop between layers)."""
    by_name: dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ivals = sorted((s, e) for _, s, e in ops)
    gaps, end = [], None
    for s, e in ivals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid_ns = 1e3 * (a + b) / 2
        host = "host"
        for name, calls in spans.spans.items():
            if any(c["t0"] <= mid_ns <= c["t1"] for c in calls):
                host = name
                break
        named.append([host, (b - a) / 1e6])
    return {"device_ops": [[n, v] for n, v in device_ops], "idle_gaps": named}
