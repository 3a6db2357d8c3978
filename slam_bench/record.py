"""What a per-layer metric reads from a traced run: the window's length
and ticks, the device's operations (name, start us, end us) from the
profiler trace, and the host spans (``trace.SPANS``) with what each call
recorded."""

from __future__ import annotations

import dataclasses

from slam_bench import flops, peaks
from slam_bench.trace import busy_us, is_kernel


@dataclasses.dataclass
class Record:
    window_s: float
    ticks: list
    ops: list
    spans: dict
    cfg: object  # the engine's SlamConfig

    def optimizing_ticks(self) -> list:
        return [t for t in self.ticks if t["iters"] > 0]

    def kernels(self) -> list:
        return [o for o in self.ops if is_kernel(o[0])]

    def device_s(self, names: tuple[str, ...]) -> float:
        """Seconds of the kernels whose name holds one of ``names`` + "("."""
        return sum(e - s for n, s, e in self.ops if any(f"{k}(" in n for k in names)) / 1e6

    def idle_share(self) -> float | None:
        if not self.ops or self.window_s <= 0:
            return None
        return 1.0 - busy_us((s, e) for _, s, e in self.ops) / 1e6 / self.window_s

    def span_s(self, name: str) -> float:
        return sum(c["s"] for c in self.spans.get(name, []))

    def k5_share(self) -> float | None:
        """K5's share of its roofline (%): the least time the chip could
        take for the RANSAC scoring these inputs need (``flops.k5``: every
        real detection's crop points against every hypothesis, a launch a
        plane round of each frontend call) over the device time of K5's
        kernel (``score_kernel``)."""
        dev = self.device_s(("score_kernel",))
        calls = self.spans.get("segment", [])
        if dev <= 0 or not calls:
            return None
        s = self.cfg.segmentation
        n = s.crop_height * s.crop_width
        bound = sum(s.max_planes_per_detection * peaks.bound_s(*flops.k5(c["detections"], n, s.num_hypotheses))
                    for c in calls)
        return 100.0 * bound / dev
