"""How ``correct`` is decided: a sample of the window's ticks, drawn from the
seed, is captured as the timed path runs it, and after the window each
captured stage is held to the plain reference (``reference/``), computed
from the inputs the harness made.

Captured, by wrapping the port's module-level functions at call time (the
program itself is unchanged):

* ``engine._segment_only``: the frontend of a keyframe or of a window of
  them (its observations, the K5 scores' outcome included);
* ``association.associate``: the landmark ids given to each observation;
* ``engine._optimize_tick``: the graph going into the tick's solve and the
  one coming out;
* ``fixed_lag.marginalize``: the graph and prior going in and coming out
  (the window's first ``MAX_MARGINALIZATIONS``, whichever ticks are sampled).

The reference follows the program step by step: each stage starts from the
program's state before it (the robot-pose snapshot a keyframe carries, the
landmark table, the graph after ingest, the prior), which it cannot derive
without running the whole session itself; each stage is judged alone.
Numbers compared (each against ``limits/<cell>.json``):

* ``plane_gap``: the widest gap between a plane the program extracts and
  the reference's plane of the same detection (normal components, offset
  in m), planes paired nearest first;
* ``centroid_gap_m``: the widest gap between the centroid of a plane's
  inliers (the landmark observation, camera frame) and the reference's;
* ``det_miss``: the planes that one side reports and the other does not,
  or that the two sides type differently, leaving out planes within
  ``BORDER`` of the gates (inlier count, area), where float32 rounding may
  tip them either way; an exact comparison;
* ``assoc_miss``: the program's observations whose landmark id (or
  newness) the reference gives otherwise; an exact comparison;
* ``ingest_gap_m``: the widest gap between a new landmark edge's
  measurement (robot frame) and the reference's, made from the program's
  observation that the frontend numbers hold;
* ``ingest_miss``: new landmark edges that are missing, extra, or carry
  another keyframe or landmark than the reference gives; exact;
* ``odom_gap``: the widest gap of a new odometry edge (translation in m,
  quaternion components) from the reference's, made from the keyframes'
  VIO poses;
* ``state_gap_m``: the widest gap of a free pose's translation or a
  landmark between the program's solve and the reference's;
* ``chi2_gap``: the program's objective after the solve above the
  reference's, over the decrease the reference achieves;
* ``prior_gap``: the relative gap of the prior's information (pose block and
  landmark blocks) after a marginalization.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect
import json
from pathlib import Path

import numpy as np
import torch

from slam_bench import np_geometry as npg
from slam_bench.reference import assoc as ref_assoc
from slam_bench.reference import frontend as ref_front
from slam_bench.reference import lm as ref_lm
from slam_bench.reference import marginalize as ref_marg

CAPTURE = {
    "frontend": ("semantic_slam_tpu_torch.runtime.engine", "_segment_only"),
    "assoc": ("semantic_slam_tpu_torch.assoc.association", "associate"),
    "solve": ("semantic_slam_tpu_torch.runtime.engine", "_optimize_tick"),
    "marginalize": ("semantic_slam_tpu_torch.solver.fixed_lag", "marginalize"),
}
NUMBERS = ("plane_gap", "centroid_gap_m", "det_miss", "assoc_miss", "ingest_gap_m", "ingest_miss", "odom_gap",
           "state_gap_m", "chi2_gap", "prior_gap")
MAX_MARGINALIZATIONS = 4
LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def snap(x):
    """A detached copy of a tensor or of a structure of them."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snap(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: snap(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(snap(v) for v in x)
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    return x


def host(x):
    """A structure of tensors as float64 / int64 numpy arrays."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu()
        return a.to(torch.float64).numpy() if a.is_floating_point() else a.numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: host(v) for k, v in x._asdict().items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x


class Checker:
    """Captures the stages of every ``every``-th tick (from an offset drawn
    from the seed), at most ``max_ticks`` of them, while ``installed``."""

    def __init__(self, seed: int, every: int, max_ticks: int):
        self.every, self.max_ticks = every, max_ticks
        self.offset = int(np.random.default_rng([seed, 7]).integers(every))
        self.ticks = 0
        self.armed = False
        self.current: list | None = None
        self.records: list[dict] = []
        self.enabled = False
        self.marginalizations = 0

    def before_run(self, engine) -> None:
        self.armed = self.enabled and self.ticks % self.every == self.offset and len(self.records) < self.max_ticks
        if self.armed and self.current is None:
            self.current = []

    def disarm(self) -> None:
        """No capture until the next ``before_run`` (a session's finalize)."""
        self.armed = False
        self.current = None

    def after_tick(self, keyframes: list, n_new: int, source: dict) -> None:
        """``keyframes``: the engine's, the last ``n_new`` of them taken in
        by the tick."""
        if self.current:
            first = len(keyframes) - n_new
            kfs = [(k.stamp, source.get(k.stamp), k.boxes is not None and len(k.boxes) > 0) for k in keyframes[first:]]
            prev = keyframes[first - 1].stamp if first > 0 else None
            self.records.append({"calls": self.current, "keyframes": kfs, "prev": prev})
        self.current = None
        self.armed = False
        if self.enabled:
            self.ticks += 1

    def _wrap(self, kind, fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def captured(*args, **kwargs):
            marg = kind == "marginalize" and self.enabled and self.marginalizations < MAX_MARGINALIZATIONS
            if not (self.armed or marg):
                return fn(*args, **kwargs)
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            inputs = {k: snap(v) for k, v in a.arguments.items() if k not in ("points", "cloud_valid", "mesh")}
            out = fn(*args, **kwargs)
            if marg:
                self.marginalizations += 1
                self.records.append({"calls": [(kind, inputs, snap(out))], "keyframes": [], "prev": None})
            else:
                self.current.append((kind, inputs, snap(out)))
            return out

        return captured

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for kind, (mod_name, attr) in CAPTURE.items():
                mod = importlib.import_module(mod_name)
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, self._wrap(kind, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)


def load_limits(cell: str) -> dict:
    path = LIMITS_DIR / f"{cell}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


@dataclasses.dataclass
class Judge:
    """Holds the captured records to the reference. ``low`` puts the
    reference at bfloat16 in the program's place (the control)."""

    stream: object
    seg: dict
    cfg_frontend: dict
    assoc_params: dict
    device: torch.device
    _vio: dict | None = dataclasses.field(default=None, init=False, repr=False)

    def frames(self, stamp_src):
        st = self.stream
        frame_s, det_s = stamp_src
        frame = st.frames[st.frame_of[frame_s]]
        if st.depth_input:
            cloud = ref_front.backproject(frame, st.camera.intrinsics, st.depth_scale, self.device)
        else:
            cloud = (torch.as_tensor(frame[0], device=self.device).to(torch.float64),
                     torch.as_tensor(frame[1], device=self.device))
        D = self.cfg_frontend["D"]
        boxes = np.zeros((D, 4))
        cids = np.full(D, -1, np.int64)
        if det_s is not None:
            b, c, _ = st.dets[det_s]
            n = min(len(b), D)
            boxes[:n], cids[:n] = b[:n], c[:n]
        return cloud, boxes, cids

    def frontend(self, rec, prog: bool, low: bool, acc: dict) -> None:
        det_kfs = [k for k in rec["keyframes"] if k[2]]
        row = 0
        for kind, inp, out in rec["calls"]:
            if kind != "frontend":
                continue
            xyz = host(inp["robot_xyzrpy"])
            dets = host(out)
            batched = xyz.ndim == 2
            for b in range(xyz.shape[0] if batched else 1):
                if row >= len(det_kfs) or det_kfs[row][1] is None:
                    return
                cloud, boxes, cids = self.frames(det_kfs[row][1])
                row += 1
                x = xyz[b] if batched else xyz
                f = self.cfg_frontend
                ref = ref_front.keyframe(cloud, boxes, cids, x, f["cam_angle"], self.seg, f["strict"])
                if prog:
                    other = {k: (dets[k][b] if batched else dets[k])
                             for k in ("valid", "plane_type", "normal_cam", "pose_cam")}
                    ov, ot = other["valid"].astype(bool), other["plane_type"]
                    on, oc = other["normal_cam"], other["pose_cam"]
                else:
                    low_ref = ref_front.keyframe(cloud, boxes, cids, x, f["cam_angle"], self.seg, f["strict"], low=low)
                    ov, ot = low_ref["valid"].numpy(), low_ref["type"].numpy()
                    on, oc = low_ref["normal_cam"].numpy(), low_ref["pose_cam"].numpy()
                misses, gap, cgap = match_planes(ov, ot, on, oc, ref, self.seg["max_planes"])
                acc["det_miss"] += misses
                acc["rows"] += 1
                if gap is not None:
                    acc["plane_gap"] = max(acc["plane_gap"] or 0.0, gap)
                    acc["centroid_gap_m"] = max(acc["centroid_gap_m"] or 0.0, cgap)

    def association(self, rec, acc: dict) -> None:
        for kind, inp, out in rec["calls"]:
            if kind != "assoc":
                continue
            table, dets = host(inp["table"]), host(inp["dets"])
            res = host(out[1])
            p = dict(self.assoc_params, use_maha=inp["use_maha"], maha_thres=inp["maha_thres"],
                     eq_thres=inp["eq_thres"], land_noise=inp["land_noise"], strict=inp["strict_frames"],
                     rtabmap=inp["rtabmap_y_offset"])
            dd = {"valid": dets["valid"].astype(bool), "class_id": dets["class_id"], "plane_type": dets["plane_type"],
                  "pose_cam": dets["pose_cam"]}
            ids, new = ref_assoc.associate(table, dd, host(inp["robot_xyzrpy"]), float(host(inp["cam_angle"])), p)
            v = dd["valid"]
            acc["edges"].append((ids[v], dd["pose_cam"][v], float(host(inp["cam_angle"]))))
            acc["assoc_miss"] += int(np.sum(v & ((ids != res["lm_id"]) | (new != res["is_new"].astype(bool)))))
            acc["assoc_n"] += int(v.sum())

    def vio(self, stamp: float) -> np.ndarray:
        if self._vio is None:
            self._vio = {float(t): i for i, t in enumerate(self.stream.odom_t)}
        return self.stream.odom[self._vio[stamp]]

    def ingest(self, rec, prog: bool, low: bool, acc: dict) -> None:
        """The tick's new odometry edges against ``prev^-1 * cur`` of the
        keyframes' VIO poses (a session's rigid world motion cancels), and
        its new landmark edges against the reference's: the keyframe, the
        landmark id that ``association`` gave and the observation's centroid
        in the robot frame. The program's are the last rows of the graph
        its solve starts from; the control computes them at bfloat16."""
        solves = [inp for kind, inp, _ in rec["calls"] if kind == "solve"]
        edges, acc["edges"] = acc["edges"], []
        if not solves or not rec["keyframes"]:
            return
        g = host(solves[0]["graph"])
        q = _np_rounder(low)
        stamps = [rec["prev"]] + [k[0] for k in rec["keyframes"]]
        want = [npg.pose_mul(npg.pose_inv(self.vio(a)), self.vio(b)) for a, b in zip(stamps[:-1], stamps[1:])
                if a is not None]
        if want:
            E1 = int(g["num_odom"])
            got = (g["odom_meas"][E1 - len(want):E1] if prog else
                   [q(npg.pose_mul(npg.pose_inv(q(self.vio(a))), q(self.vio(b))))
                    for a, b in zip(stamps[:-1], stamps[1:]) if a is not None])
            for w, o in zip(want, got):
                qg = min(np.abs(o[3:] - w[3:]).max(), np.abs(o[3:] + w[3:]).max())
                acc["odom_gap"] = max(acc["odom_gap"] or 0.0, float(np.abs(o[:3] - w[:3]).max()), float(qg))
        if not prog:
            for _, pc, cam in edges or []:
                T = npg.t_cam_robot(cam)
                for p in pc:
                    w = (T @ np.append(p, 1.0))[:3]
                    acc["ingest_gap_m"] = max(acc["ingest_gap_m"] or 0.0,
                                              float(np.abs(q(q(T) @ np.append(q(p), 1.0))[:3] - w).max()))
            return
        K, E2 = int(g["num_poses"]), int(g["num_lme"])
        det_rows = [i for i, k in enumerate(rec["keyframes"]) if k[2]]
        n_new = sum(len(ids) for ids, _, _ in edges)
        acc["ingest_n"] += n_new
        if len(edges) != len(det_rows) or n_new > E2:
            acc["ingest_miss"] += max(n_new, 1)
            return
        e = E2 - n_new
        for (ids, pc, cam), row in zip(edges, det_rows):
            k = K - len(rec["keyframes"]) + row
            T = npg.t_cam_robot(cam)
            for lid, p in zip(ids, pc):
                if int(g["lme_k"][e]) != k or int(g["lme_l"][e]) != int(lid):
                    acc["ingest_miss"] += 1
                w = (T @ np.append(p, 1.0))[:3]
                acc["ingest_gap_m"] = max(acc["ingest_gap_m"] or 0.0, float(np.abs(g["lme_meas"][e] - w).max()))
                e += 1

    def control_edges(self, rec, acc: dict) -> None:
        """The observations whose edges the control makes (the program's,
        as the association saw them)."""
        for kind, inp, _ in rec["calls"]:
            if kind == "assoc":
                d = host(inp["dets"])
                acc["edges"].append((None, d["pose_cam"][d["valid"].astype(bool)], float(host(inp["cam_angle"]))))

    def problem(self, g: dict, prior) -> ref_lm.Problem:
        dev = self.device
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        K, L = int(g["num_poses"]), int(g["num_landmarks"])
        E1, E2 = int(g["num_odom"]), int(g["num_lme"])
        pr = None
        if prior is not None:
            P = host(prior)
            n_p = int(P["num_p"])
            pr = {"p_idx": t(P["p_idx"][:n_p]).long(), "p_ref": t(P["p_ref"][:n_p]),
                  "Hp": t(P["Hp"][:6 * n_p, :6 * n_p]), "gp0": t(P["gp0"][:6 * n_p]), "Hl": t(P["Hl"][:L]),
                  "l_ref": t(P["l_ref"][:L]), "gl0": t(P["gl0"][:L]), "c0": t(P["c0"])}
        return ref_lm.Problem(
            poses=t(g["poses"][:K]), landmarks=t(g["landmarks"][:L]),
            oi=t(g["odom_i"][:E1]).long(), oj=t(g["odom_j"][:E1]).long(), o_meas=t(g["odom_meas"][:E1]),
            o_info=t(g["odom_info"][:E1]), lk=t(g["lme_k"][:E2]).long(), ll=t(g["lme_l"][:E2]).long(),
            l_meas=t(g["lme_meas"][:E2]), l_info=t(g["lme_info"][:E2]), robust="none", delta=1.0, prior=pr,
        )

    def solve(self, rec, prog: bool, low: bool, acc: dict) -> None:
        for kind, inp, out in rec["calls"]:
            if kind != "solve" or not inp["do_opt"]:
                continue
            iters = out[4]
            if prog and iters == 0:
                continue
            g = host(inp["graph"])
            pr = self.problem(g, inp["prior"])
            pr.robust, pr.delta = inp["robust_kind"], float(inp["robust_delta"])
            if inp["min_edges"] > 0 and len(pr.oi) + len(pr.ll) < inp["min_edges"]:
                continue
            kw = dict(max_iterations=inp["max_iterations"], rel_tol=inp["rel_tol"], init_lambda=inp["init_lambda"])
            rp, rl, _, f_in, f_ref = ref_lm.solve(pr, **kw)
            K, L = rp.shape[0], rl.shape[0]
            if prog:
                go = host(out[0])
                pp = torch.as_tensor(go["poses"][:K], device=self.device)
                pl = torch.as_tensor(go["landmarks"][:L], device=self.device)
            else:
                pp, pl, _, _, _ = ref_lm.solve(pr, low=low, **kw)
            f_prog = float(ref_lm.objective(pr, pp, pl))
            gap = max(float((pp[1:, :3] - rp[1:, :3]).abs().max()) if K > 1 else 0.0,
                      float((pl - rl).abs().max()) if L else 0.0)
            acc["state_gap_m"] = max(acc["state_gap_m"] or 0.0, gap)
            drop = max(f_in - f_ref, 1e-9 * abs(f_in) + 1e-12)
            acc["chi2_gap"] = max(acc["chi2_gap"] or 0.0, abs(f_prog - f_ref) / drop)

    def marginalization(self, rec, prog: bool, low: bool, acc: dict) -> None:
        for kind, inp, out in rec["calls"]:
            if kind != "marginalize":
                continue
            g, prior_in, drop = host(inp["g"]), host(inp["prior"]), int(inp["drop"])
            ref = ref_marg.marginalize(g, prior_in, drop, self.device)
            other = host(out[1]) if prog else ref_marg.marginalize(g, prior_in, drop, self.device, low=low)
            acc["prior_gap"] = max(acc["prior_gap"] or 0.0, ref_marg.prior_gap(other, ref))

    def numbers(self, records: list[dict], prog: bool = True, low: bool = False) -> dict:
        acc = {"plane_gap": None, "centroid_gap_m": None, "det_miss": 0, "rows": 0, "assoc_miss": 0, "assoc_n": 0,
               "edges": [], "ingest_gap_m": None, "ingest_miss": 0, "ingest_n": 0, "odom_gap": None,
               "state_gap_m": None, "chi2_gap": None, "prior_gap": None}
        with torch.no_grad():
            for rec in records:
                self.frontend(rec, prog, low, acc)
                if prog:
                    self.association(rec, acc)
                else:
                    self.control_edges(rec, acc)
                self.ingest(rec, prog, low, acc)
                self.solve(rec, prog, low, acc)
                self.marginalization(rec, prog, low, acc)
        return {
            "plane_gap": acc["plane_gap"],
            "centroid_gap_m": acc["centroid_gap_m"],
            "det_miss": acc["det_miss"] if acc["rows"] else None,
            "assoc_miss": acc["assoc_miss"] if acc["assoc_n"] else None,
            "ingest_gap_m": acc["ingest_gap_m"],
            "ingest_miss": acc["ingest_miss"] if acc["ingest_n"] or acc["ingest_miss"] else None,
            "odom_gap": acc["odom_gap"],
            "state_gap_m": acc["state_gap_m"],
            "chi2_gap": acc["chi2_gap"],
            "prior_gap": acc["prior_gap"],
        }


def _np_rounder(low: bool):
    """Identity, or a round trip of a float64 array through bfloat16."""
    if not low:
        return lambda a: np.asarray(a, np.float64)
    return lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(torch.bfloat16).to(torch.float64).numpy()


BORDER = (0.99, 1.01)  # a plane within these margins of its gates may fall either side by rounding


def match_planes(pv, pt, pn, pc, ref: dict, P: int) -> tuple[int, float | None, float | None]:
    """Pair each detection's planes (rows d*P .. d*P+P-1) of the program with
    the reference's, nearest plane equation first, against every plane the
    reference extracted (valid or not). Returns (clear misses, the widest gap
    of a valid pair, the widest centroid gap of a valid pair in m). A plane's gap to another is the larger of its normal's
    (sign-aligned) and its offset's (m) largest component difference. A miss
    is a plane that one side reports and the other does not, or a pair typed
    differently; it is clear unless the reference's margin over the gates
    (``ref["margin"]``) lies within ``BORDER``, where float32 rounding
    may tip it either way."""
    rv, rt, rn, rm, rc = (ref[k].numpy() for k in ("valid", "type", "normal_cam", "margin", "pose_cam"))
    misses, widest, cwidest = 0, None, None
    for d in range(len(pv) // P):
        rows = list(range(d * P, d * P + P))
        used = set()
        for m in (r for r in rows if pv[r]):
            gaps = [min(np.abs(pn[m] - rn[k]).max(), np.abs(pn[m] + rn[k]).max()) for k in rows]
            k = rows[int(np.argmin(gaps))]
            used.add(k)
            if rv[k]:
                if pt[m] != rt[k]:
                    misses += 1
                widest = max(widest or 0.0, float(min(gaps)))
                cwidest = max(cwidest or 0.0, float(np.abs(pc[m] - rc[k]).max()))
            elif rm[k] < BORDER[0]:
                misses += 1
        misses += sum(1 for k in rows if rv[k] and k not in used and rm[k] > BORDER[1])
    return misses, widest, cwidest


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for each number, its value beside its limit. A
    number with nothing to compare in the run (no valid plane among the
    sampled ticks) is shown as None and not judged, unless the cell's
    limits list it under ``required`` (a marginalization in a fixed-lag
    cell); a run that compared no solve or no frontend is not correct."""
    shown = {k: {"value": numbers.get(k), "limit": limits[k]} for k in NUMBERS if k in limits}
    required = ("state_gap_m", "det_miss", *limits.get("required", ()))
    ok = all(numbers.get(k) is not None for k in required)
    for v in shown.values():
        if v["value"] is not None and not v["value"] <= v["limit"]:
            ok = False
    return ok, shown
