"""Plane-landmark sessions and their lifecycle through the port's ``cli``
against the JAX package's, on the CPU, in f64.

Both packages run their own ``cli run --plane-landmarks`` on the same
``.npz`` logs (120x160 clouds) under ``tests/test_e2e.py``'s
lowered-threshold config registered as a profile in both (as
``tests/test_torch_lifecycle.py`` does):

  * dense, and ``--solver pcg`` (the row-range loop's plane half), on one
    loop of the scene (19 keyframes, 4 landmarks);
  * ``--fixed-lag 24``, dense (from ``--max-keyframes 8``, so that the
    capacities double three times) and pcg, on two loops (38 keyframes),
    each split after its first marginalization and resumed from the first
    part's checkpoint.

The JAX package's output directories are stored (``REF``,
``tests/jax_golden.py``); the port's run live. The JAX engine ran them with
``SLAM_SOLVER_IMPL=soa``, so that its pcg plane ticks take ``soa_dist.lm_optimize_soa_planes``, the route its
engine takes on the TPU and the port's at every K (off the TPU it would take
``pcg.lm_optimize_pcg_planes``, another algorithm), as
``tests/test_soa_dist.py``'s ``TestEnginePlanesDispatch`` runs it.

Equal: keyframes, landmarks, the plane and plane-edge counts and the LM
iterations of every tick. Within 1e-9 (dense) or 1e-8 (pcg): keyframe
poses, landmarks, planes and each tick's chi2. The lifecycle: ``save_g2o``
with plane nodes byte for byte against the JAX writer, ``load_g2o(with_planes
=True)`` equal to the JAX loader, plane checkpoints port to port exactly,
port to JAX and JAX to port, and ``merge --plane-landmarks`` against the JAX
merge.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax_golden
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch.graph import planes as tgp
from semantic_slam_tpu_torch.graph import state as tgs
from semantic_slam_tpu_torch.io import checkpoint as tckpt
from semantic_slam_tpu_torch.io import g2o_io as tg2o
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.io.tum import read_tum
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_e2e import e2e_config
from test_torch_lifecycle import PROFILE, merge, save_parts, split_log, to_port
from test_torch_lifecycle import run as run_cli
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

TOL = {"dense": 1e-9, "pcg": 1e-8}
# the pcg sessions' profile: the same config with 32 CG steps an LM
# iteration (the profile's 128 cost the port's plain CG 4x the CPU time and
# test nothing more)
PCG_PROFILE = "torch_planes_pcg"


def pcg_config():
    cfg = e2e_config()
    return cfg.replace(solver=dataclasses.replace(cfg.solver, pcg_iters=32))


PROFILES = {PROFILE: e2e_config, PCG_PROFILE: pcg_config}


@pytest.fixture(scope="module")
def profile():
    with pytest.MonkeyPatch.context() as mp:
        for name, cfg in PROFILES.items():
            mp.setitem(tcfg.PROFILES, name, to_port(cfg()))
        yield


# one loop of the scene (``short``), and two loops split at 92% of their
# odometry stamps (35 keyframes of 38: after a window of 24 with a chunk of
# 8 has marginalized once)
LOGS = {"short": dict(seed=7, n_steps=240, sensor_every=6, H=120, W=160, loops=1.0),
        "long": dict(seed=7, n_steps=480, sensor_every=6, H=120, W=160, loops=2.0)}
SPLIT_AT = 0.92


def save_logs(out_dir, short=None, long=None):
    """The logs as .npz files: ``short`` whole, the long one's two parts."""
    parts = dict(zip(("first", "second"), split_log(long, SPLIT_AT))) if long is not None else {}
    return save_parts(out_dir, **({"short": short} if short is not None else {}), **parts)


def run(pkg: str, out: str, log: str, *flags: str) -> str:
    return run_cli(pkg, out, log, "--plane-landmarks", "--checkpoint", *flags,
                   profile=PCG_PROFILE if "pcg" in flags else PROFILE)


SESSIONS = {"dense": [], "pcg": ["--solver", "pcg"]}
SPLITS = {"dense": ["--fixed-lag", "24", "--max-keyframes", "8"], "pcg": ["--fixed-lag", "24", "--solver", "pcg"]}


def whole_flags(kind):
    return SESSIONS[kind] + (["--save-graph"] if kind == "dense" else [])


def split_run(pkg, tmp, paths, kind):
    first = run(pkg, os.path.join(tmp, "first"), paths["first"], *SPLITS[kind])
    resumed = run(pkg, os.path.join(tmp, "resumed"), paths["second"], "--resume",
                  os.path.join(first, "checkpoint.npz"), *SPLITS[kind])
    return {"first": first, "resumed": resumed}


def merge_planes(pkg, out, sessions):
    """``merge --plane-landmarks`` of a split's first part with its resumed
    part (one session's two checkpoints, as ``tests/test_torch_lifecycle.py``
    merges)."""
    return merge(pkg, out, [os.path.join(sessions[s], "checkpoint.npz") for s in ("first", "resumed")],
                 "--plane-landmarks")


def jax_cli(configs: dict, log, part: str, kind: str) -> dict:
    """The JAX CLI's output directories under the profiles ``configs``: for
    ``whole`` a ``kind`` session on ``log`` (the short one), for ``split``
    its ``first/`` and ``resumed/`` parts and ``merge/`` their merge. The JAX
    engine runs with ``SLAM_SOLVER_IMPL=soa``, so that its pcg plane ticks
    take ``soa_dist.lm_optimize_soa_planes``."""
    import jax

    from semantic_slam_tpu import config as jcfg

    with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
        for name, cfg in configs.items():
            mp.setitem(jcfg.PROFILES, name, cfg)
        mp.setenv("SLAM_SOLVER_IMPL", "soa")
        jax.clear_caches()
        out = os.path.join(tmp, "jax")
        if part == "whole":
            run("jax", out, save_logs(tmp, short=log)["short"], *whole_flags(kind))
        else:
            merge_planes("jax", os.path.join(out, "merge"), split_run("jax", out, save_logs(tmp, long=log), kind))
        return jax_golden.read_dir(out, skip=(".ply", "vio_pose.txt", "gt_pose.txt", "keyframes.ply"))


# the JAX CLI's output directories, stored (tests/jax_golden.py); the calls'
# context: the module's flags and split
REF = jax_golden.Recorded("torch_planes_engine", tol=min(TOL.values()))
CONTEXT = {"sessions": SESSIONS, "splits": SPLITS, "split_at": SPLIT_AT}


def jax_dir(part: str, kind: str, log, tmp: str) -> str:
    configs = {name: cfg() for name, cfg in PROFILES.items()}
    return jax_golden.write_dir(REF(jax_cli, configs, log, part, kind, context=CONTEXT), os.path.join(tmp, "jax"))


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The logs' files, and the logs."""
    logs = {k: tsynth.make_synthetic_log(**v) for k, v in LOGS.items()}
    return save_logs(str(tmp_path_factory.mktemp("plane_logs")), **logs), logs


@pytest.fixture(scope="module", params=sorted(SESSIONS))
def whole(request, profile, logs, tmp_path_factory):
    kind, (paths, data) = request.param, logs
    tmp = str(tmp_path_factory.mktemp(f"whole_{kind}"))
    return kind, {"jax": jax_dir("whole", kind, data["short"], tmp),
                  "port": run("port", os.path.join(tmp, "port"), paths["short"], *whole_flags(kind))}


@pytest.fixture(scope="module", params=sorted(SPLITS))
def split(request, profile, logs, tmp_path_factory):
    kind, (paths, data) = request.param, logs
    tmp = str(tmp_path_factory.mktemp(f"split_{kind}"))
    jdir = jax_dir("split", kind, data["long"], tmp)
    return kind, {"jax": {k: os.path.join(jdir, k) for k in ("first", "resumed", "merge")},
                  "port": split_run("port", os.path.join(tmp, "port"), paths, kind)}


def _read(out):
    summary = json.load(open(os.path.join(out, "summary.json")))
    stats = [json.loads(line) for line in open(os.path.join(out, "stats.jsonl"))]
    stamps, poses = read_tum(os.path.join(out, "robot_pose.txt"))
    lms = json.load(open(os.path.join(out, "landmarks.json")))
    return summary, stats, stamps, poses, lms, np.load(os.path.join(out, "checkpoint.npz"))


def assert_same_session(jout, tout, tol):
    js, jst, jt, jp, jl, jz = _read(jout)
    ts, tst, tt, tp, tl, tz = _read(tout)
    for k in ("keyframes", "landmarks", "edges", "optimize_calls"):
        assert ts[k] == js[k], k
    assert js["keyframes"] > 0 and js["landmarks"] > 0 and js["optimize_calls"] > 0
    # per tick: LM iterations, and in a plane tick num_landmarks and num_edges
    # count the planes and the odometry and plane edges
    for k in ("iterations", "num_poses", "num_landmarks", "num_edges"):
        assert [s[k] for s in tst] == [s[k] for s in jst], k
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a["chi2_final"], b["chi2_final"], rtol=tol, atol=tol)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=tol, rtol=0)
    np.testing.assert_allclose([x["position"] for x in tl], [x["position"] for x in jl], atol=tol, rtol=0)
    for k in ("p_num_planes", "p_num_pe", "p_pe_k", "p_pe_p"):
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    n = int(jz["p_num_planes"])
    assert n == js["landmarks"] and int(jz["p_num_pe"]) >= n
    np.testing.assert_allclose(tz["p_planes"], jz["p_planes"], atol=tol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(tz["p_planes"][:n, :3], axis=1), 1.0, atol=1e-12)
    return ts, tz


def test_plane_session_equals_jax(whole):
    kind, outs = whole
    assert_same_session(outs["jax"], outs["port"], TOL[kind])


def test_plane_split_fixed_lag_equals_jax(split):
    kind, outs = split
    _, z = assert_same_session(outs["jax"]["first"], outs["port"]["first"], TOL[kind])
    kf_base = json.loads(str(z["meta"]))["kf_base"]
    assert kf_base >= 8 and len(z["fl_archived"]) == kf_base
    # the prior holds the marginalized plane edges' information
    assert np.abs(z["fl_Hpl"]).sum() > 0 and np.abs(z["fl_gpl0"]).sum() > 0
    resumed, rz = assert_same_session(outs["jax"]["resumed"], outs["port"]["resumed"], TOL[kind])
    assert resumed["keyframes"] > len(json.loads(str(z["meta"]))["keyframes"])
    if kind == "dense":  # --max-keyframes 8: the capacities doubled
        assert rz["g_poses"].shape[0] > 8 and rz["p_planes"].shape[0] > 16 and rz["fl_Hpl"].shape[0] > 16


# ---------------------------------------------------------------------------
# the plane lifecycle
# ---------------------------------------------------------------------------


def _cfg(fixed_lag: int = 0):
    cfg = tcfg.PROFILES[PROFILE].replace(use_plane_landmarks=True)
    return cfg.replace(solver=dataclasses.replace(cfg.solver, fixed_lag_window=fixed_lag)) if fixed_lag else cfg


def _jax_engine(path: str, fixed_lag: int = 0):
    from semantic_slam_tpu.io import checkpoint as jckpt
    from semantic_slam_tpu.runtime.engine import SlamEngine as JaxEngine

    cfg = e2e_config().replace(use_plane_landmarks=True)
    if fixed_lag:
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, fixed_lag_window=fixed_lag))
    e = JaxEngine(cfg)
    jckpt.load_checkpoint(path, e)
    return e


def _port_engine(path: str, fixed_lag: int = 0):
    e = TorchEngine(_cfg(fixed_lag), device="cpu")
    tckpt.load_checkpoint(path, e)
    return e


def _assert_state_equal(je, te, exact: bool):
    """The JAX engine's graph, table, plane nodes and prior against the
    port engine's."""
    parts = [("graph", je.graph._asdict(), tgs.graph_to_numpy(te.graph)),
             ("planes", je.plane_nodes._asdict(), tgp.plane_nodes_to_numpy(te.plane_nodes)),
             ("prior", je.prior._asdict(), {k: v.numpy() for k, v in te.prior._asdict().items()})]
    for name, a, b in parts:
        assert set(a) == set(b), name
        for k in a:
            x, y = np.asarray(a[k]), b[k]
            assert x.shape == y.shape, (name, k)
            if exact:
                np.testing.assert_array_equal(y, x.astype(y.dtype), err_msg=f"{name}.{k}")
            else:
                np.testing.assert_allclose(y, x, atol=1e-9 * max(1.0, float(np.abs(x).max(initial=0))), rtol=0,
                                           err_msg=f"{name}.{k}")
    assert je._kf_base == te._kf_base and len(je.keyframes) == len(te.keyframes)


def test_plane_checkpoint_round_trips(split, tmp_path):
    """The fixed-lag first part's checkpoints (plane nodes, a prior with a
    plane part): port to port exactly (loaded and saved again), port to JAX
    and JAX to port (the arrays as the other package holds them), and the
    JAX file against the port's within 1e-9."""
    kind, outs = split
    ports = {pkg: os.path.join(outs[pkg]["first"], "checkpoint.npz") for pkg in ("jax", "port")}
    te = _port_engine(ports["port"], 24)
    again = str(tmp_path / "again.npz")
    tckpt.save_checkpoint(again, te)
    a, b = np.load(ports["port"]), np.load(again)
    assert sorted(a.files) == sorted(b.files) and "p_planes" in a.files and "fl_Hpl" in a.files
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # port -> JAX: every array exactly as the port holds it
    _assert_state_equal(_jax_engine(ports["port"], 24), te, exact=True)
    # JAX -> port: exactly as the JAX engine holds it; and near the port's own
    je = _jax_engine(ports["jax"], 24)
    te_from_jax = _port_engine(ports["jax"], 24)
    _assert_state_equal(je, te_from_jax, exact=True)
    _assert_state_equal(je, te, exact=False)


def test_plane_g2o_equals_jax(whole, tmp_path):
    """``save_g2o`` with plane nodes writes the JAX writer's text byte for
    byte (the JAX session's state, loaded into both packages), and
    ``load_g2o(with_planes=True)`` gives the JAX loader's arrays; the port's
    own --save-graph reads back as its graph."""
    from semantic_slam_tpu.io import g2o_io as jg2o

    kind, outs = whole
    ck = os.path.join(outs["jax"], "checkpoint.npz")
    je, te = _jax_engine(ck), _port_engine(ck)
    jpath, tpath = str(tmp_path / "jax.g2o"), str(tmp_path / "port.g2o")
    jg2o.save_g2o(jpath, je.graph, je.plane_nodes)
    tg2o.save_g2o(tpath, te.graph, te.plane_nodes)
    text = open(jpath, "rb").read()
    assert open(tpath, "rb").read() == text and b"VERTEX_PLANE" in text and b"EDGE_SE3_PLANE" in text
    jg, jpn = jg2o.load_g2o(jpath, with_planes=True)
    tg, tpn = tg2o.load_g2o(tpath, with_planes=True)
    for name, a, b in (("graph", jg._asdict(), tgs.graph_to_numpy(tg)),
                       ("planes", jpn._asdict(), tgp.plane_nodes_to_numpy(tpn))):
        for k, v in a.items():
            np.testing.assert_array_equal(b[k], np.asarray(v).astype(b[k].dtype), err_msg=f"{name}.{k}")
    assert tg2o.load_g2o(tpath).num_poses == tg.num_poses  # without planes: the graph alone
    if kind == "dense":
        g2, pn2 = tg2o.load_g2o(os.path.join(outs["port"], "semantic_graph.g2o"), with_planes=True)
        pe = _port_engine(os.path.join(outs["port"], "checkpoint.npz"))
        P, E3 = int(pe.plane_nodes.num_planes), int(pe.plane_nodes.num_pe)
        assert int(pn2.num_planes) == P and int(pn2.num_pe) == E3 > 0
        assert torch.equal(pn2.planes[:P], pe.plane_nodes.planes[:P])
        assert torch.equal(pn2.pe_p[:E3], pe.plane_nodes.pe_p[:E3])


def test_plane_merge_equals_jax(split, tmp_path):
    """``merge --plane-landmarks`` of the split's first part with its
    resumed part, in both packages (the JAX package's stored with its
    split)."""
    kind, outs = split
    res = {"jax": outs["jax"]["merge"], "port": merge_planes("port", str(tmp_path / "port"), outs["port"])}
    js, ts = (json.load(open(os.path.join(res[p], "summary.json"))) for p in ("jax", "port"))
    for k in ("sessions", "poses", "landmarks", "edges", "landmarks_per_session", "lm_iterations"):
        assert ts[k] == js[k], k
    assert ts["lm_iterations"] > 0 and ts["chi2_final"] <= ts["chi2_initial"]
    tol = TOL[kind]
    for k in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(ts[k], js[k], rtol=tol, atol=0)
    (jt, jp), (tt, tp) = (read_tum(os.path.join(res[p], "merged_pose.txt")) for p in ("jax", "port"))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=tol, rtol=0)
    jg, jpn = tg2o.load_g2o(os.path.join(res["jax"], "merged_graph.g2o"), with_planes=True)
    tg, tpn = tg2o.load_g2o(os.path.join(res["port"], "merged_graph.g2o"), with_planes=True)
    assert int(tpn.num_planes) == int(jpn.num_planes) == ts["landmarks"] and int(tpn.num_pe) == int(jpn.num_pe)
    np.testing.assert_allclose(tpn.planes.numpy(), jpn.planes.numpy(), atol=tol, rtol=0)
