"""The feeder: a ``Stream`` replayed into a ``SlamEngine`` through its public
entry points, closed loop.

This is the harness's copy of the port's ``io.replay.replay``: events in
time order (within a timestamp the frame and the detections before the
VIO message, so that a keyframe sees that step's sensors), ``engine.run()``
on a simulated ``TICK_HZ`` grid of log time (the node's 30 Hz loop), and no pacing on the wall
clock: the next events go in as soon as ``run()`` returns. A ``run()`` that
returns True is a tick; its host time, from the call to the return, holds
the tick's synchronizing ``info`` fetch and, under fixed lag, the
marginalization that follows it.
"""

from __future__ import annotations

import time

import numpy as np

from slam_bench.scene import Stream

CLOUD, DETS, ODOM = 0, 1, 2
TICK_HZ = 30.0


def event_order(stream: Stream) -> list[tuple[float, int, int]]:
    """(time, kind, index) of every event, in the order ``replay`` delivers
    them: frames 0.1 ms and detections 0.05 ms before their step's VIO."""
    ev = [(float(stream.odom_t[k]), ODOM, k) for k in range(len(stream.odom_t))]
    for s, k in enumerate(stream.sensor_step):
        t = float(stream.odom_t[k])
        ev.append((t - 1e-4, CLOUD, s))
        if stream.dets[s] is not None:
            ev.append((t - 5e-5, DETS, s))
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


class Feeder:
    """Replays ``stream`` into engines. ``ticks(engine)`` yields one dict a
    tick: ``ms`` (host time of the ``run()`` call), ``iters`` (LM
    iterations; 0 for a tick below the optimize gate), ``kf`` (keyframes the
    tick took in), ``marg`` (keyframes it marginalized). ``source[stamp]`` is
    the (sensor step of the frame, sensor step of the detections or None) a
    keyframe took, for the reference. ``before_run(engine)`` is called
    before every ``run()``."""

    def __init__(self, stream: Stream, before_run=None):
        self.stream = stream
        self.events = event_order(stream)
        self.before_run = before_run or (lambda engine: None)
        self.source: dict[float, tuple[int, int | None]] = {}

    def _deliver(self, engine, st: Stream, kind: int, i: int, state: dict) -> None:
        if kind == CLOUD:
            frame = st.frames[st.frame_of[i]]
            if st.depth_input:
                engine.set_depth_image(frame, st.camera.intrinsics, st.depth_scale)
            else:
                engine.set_point_cloud(*frame)
            state["frame"] = i
        elif kind == DETS:
            engine.set_detections(*st.dets[i])
            state["dets"] = i
        else:
            n = len(engine.keyframe_queue)
            engine.vio_callback(float(st.odom_t[i]), st.odom[i], None)
            if len(engine.keyframe_queue) > n:
                kf = engine.keyframe_queue[-1]
                self.source[kf.stamp] = (state["frame"], state["dets"] if kf.boxes is not None else None)

    def _run(self, engine):
        self.before_run(engine)
        n_stats, n_kf, base = len(engine.stats_history), len(engine.keyframes), engine._kf_base
        t0 = time.perf_counter()
        ran = engine.run()
        ms = 1e3 * (time.perf_counter() - t0)
        if not ran:
            return None
        iters = engine.stats_history[-1]["iterations"] if len(engine.stats_history) > n_stats else 0
        return {"ms": ms, "iters": iters, "kf": len(engine.keyframes) - n_kf, "marg": engine._kf_base - base}

    def ticks(self, engine, stream: Stream | None = None):
        """The ticks of ``stream`` (by default the feeder's own; a session's
        ``scene.placed`` copy carries other VIO) replayed into ``engine``."""
        st = stream or self.stream
        state = {"frame": None, "dets": None}
        next_tick = None
        for t, kind, i in self.events:
            if next_tick is None:
                next_tick = t
            while t >= next_tick:
                tick = self._run(engine)
                next_tick += 1.0 / TICK_HZ
                if tick is not None:
                    yield tick
            self._deliver(engine, st, kind, i, state)
        tick = self._run(engine)
        if tick is not None:
            yield tick


def keyframe_ate_cm(engine, stream: Stream, keyframes=None) -> float:
    """ATE (cm, Umeyama-aligned) of the given keyframes' current estimates
    (all of the engine's by default) against the log's ground truth."""
    from slam_bench.ate import ate_rmse

    kfs = engine.keyframes if keyframes is None else keyframes
    est = np.stack([engine.get_keyframe_pose(k) for k in kfs])
    stamps = np.array([k.stamp for k in kfs])
    return 100.0 * ate_rmse(stamps, est[:, :3], stream.odom_t, stream.gt[:, :3], align=True, max_dt=1e-6)
