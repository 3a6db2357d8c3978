"""The session lifecycle of the port's ``cli`` against the JAX package's, on
the CPU, in f64: a session split at its middle odometry stamp and resumed
from its checkpoint (dense, and with ``--fixed-lag 24`` split after a
marginalization), the ``run`` flags ``--robust dcs``, ``--optimize-every 3``
and ``--plane-gate``, the keyframe dumps, the g2o export, ``merge``, and the
engine's autosave.

Both packages run their own ``cli`` on the same ``.npz`` logs (120x160
clouds) under one profile registered in both for this module:
``tests/test_e2e.py``'s lowered-threshold config (Euclidean gating, f64,
K=64), which maps landmarks at this size. The JAX package's output
directories are stored (``REF``, ``tests/jax_golden.py``); the port's run
live. Sensor data pending at the split is not checkpointed in either
package, so each resumed session is held to the other package's resumed
session. Equal: keyframes, landmarks, edges, per-tick LM iterations, the
keyframe dumps (byte for byte) and merge's counts; within 1e-9: keyframe
poses, landmark positions, chi2 (relative) and the merged trajectory.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

import jax_golden
from semantic_slam_tpu_torch import cli as tcli
from semantic_slam_tpu_torch import config as tcfg
from semantic_slam_tpu_torch.io import checkpoint as tckpt
from semantic_slam_tpu_torch.io import g2o_io as tg2o
from semantic_slam_tpu_torch.io import replay as treplay
from semantic_slam_tpu_torch.io import synthetic as tsynth
from semantic_slam_tpu_torch.io.tum import read_tum
from semantic_slam_tpu_torch.runtime.engine import SlamEngine as TorchEngine
from test_e2e import e2e_config
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

PROFILE = "torch_lifecycle"
TOL = 1e-9


def to_port(cfg):
    """A JAX-package config rebuilt from the port's config classes."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw = {k: to_port(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}
    return getattr(tcfg, type(cfg).__name__)(**kw)


@pytest.fixture(scope="module")
def profile():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tcfg.PROFILES, PROFILE, to_port(e2e_config()))
        yield


def split_log(log, frac: float = 0.5):
    """The log's two parts at the odometry stamp ``frac`` of the way
    through (``tests/test_components.py``'s split at the middle)."""
    t_mid = log.odom[int(len(log.odom) * frac)].t

    def part(keep):
        return dataclasses.replace(log, **{f: [e for e in getattr(log, f) if keep(e.t)]
                                           for f in ("odom", "clouds", "depths", "detections", "gt")})

    return part(lambda t: t < t_mid), part(lambda t: t >= t_mid)


def save_parts(out_dir, **parts):
    paths = {name: os.path.join(out_dir, f"{name}.npz") for name in parts}
    for name, part in parts.items():
        treplay.save_log(paths[name], part)
    return paths


# 38 keyframes, 19 before the split; about 70 keyframes, at least 32 before
# the split, so that a window of 24 with a chunk of 8 has marginalized once
LOGS = {"short": dict(seed=7, n_steps=480, sensor_every=6, H=120, W=160, loops=2.0),
        "long": dict(seed=7, n_steps=880, sensor_every=6, H=120, W=160, loops=880 / 240)}
FLAGS = {"robust dcs": ["--robust", "dcs"], "optimize-every 3": ["--optimize-every", "3"],
         "plane-gate": ["--plane-gate"]}
# the split sessions (the dense one with its merge) and the flagged sessions
CASES = {"dense": {"log": "short", "flags": []}, "fixed_lag": {"log": "long", "flags": ["--fixed-lag", "24"]},
         **{name: {"log": "short", "flags": flags} for name, flags in FLAGS.items()}}


def make_log(name: str):
    return tsynth.make_synthetic_log(**LOGS[name])


def run(pkg: str, out: str, log: str, *flags: str, profile: str = PROFILE) -> str:
    argv = ["run", "--log", log, "--out", out, "--profile", profile, "--compute-ate", *flags]
    if pkg == "jax":
        from semantic_slam_tpu import cli as jcli

        jcli.main(argv + ["--cpu"])
    else:
        tcli.main(argv + ["--device", "cpu"])
    return out


def merge(pkg: str, out: str, ckpts, *flags: str, profile: str = PROFILE) -> str:
    argv = ["merge", *ckpts, "--out", out, "--profile", profile, *flags]
    if pkg == "jax":
        from semantic_slam_tpu import cli as jcli

        jcli.main(argv + ["--cpu"])
    else:
        tcli.main(argv + ["--device", "cpu"])
    return out


def split_session(pkg, tmp, paths, *flags):
    """The first part with --checkpoint --save-graph --dump-keyframes, then
    the second part resumed from that checkpoint."""
    first = run(pkg, os.path.join(tmp, "first"), paths["first"], "--checkpoint", "--save-graph",
                "--dump-keyframes", *flags)
    resumed = run(pkg, os.path.join(tmp, "resumed"), paths["second"], "--checkpoint", "--resume",
                  os.path.join(first, "checkpoint.npz"), *flags)
    return {"first": first, "resumed": resumed}


def jax_cli(config, log, flags, kind: str) -> dict:
    """The JAX CLI's output directories for ``log`` under ``config`` and
    ``flags``: for a ``split`` session ``first/`` and ``resumed/`` (and for
    ``merge`` also ``merge/``, the merge of their checkpoints), for a
    ``whole`` one ``run/``."""
    from semantic_slam_tpu import config as jcfg

    with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
        mp.setitem(jcfg.PROFILES, PROFILE, config)
        first, second = split_log(log)
        paths = save_parts(tmp, first=first, second=second, whole=log)
        out = os.path.join(tmp, "jax")
        if kind == "whole":
            run("jax", os.path.join(out, "run"), paths["whole"], *flags)
        else:
            s = split_session("jax", out, paths, *flags)
            if kind == "merge":
                merge("jax", os.path.join(out, "merge"),
                      [os.path.join(s[k], "checkpoint.npz") for k in ("first", "resumed")])
        # what the tests read: not the resumed checkpoints (merge/ holds their merge), VIO and ground truth
        return jax_golden.read_dir(out, skip=(".ply", "vio_pose.txt", "gt_pose.txt", "resumed/checkpoint.npz",
                                              "merged_graph.g2o"))


# the JAX CLI's output directories, stored (tests/jax_golden.py)
REF = jax_golden.Recorded("torch_lifecycle", tol=TOL)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Each log's parts (and the short one whole) as .npz files, and the
    log."""
    out = {}
    for name in LOGS:
        log = make_log(name)
        first, second = split_log(log)
        parts = dict(first=first, second=second, **({"whole": log} if name == "short" else {}))
        out[name] = save_parts(str(tmp_path_factory.mktemp(name)), **parts), log
    return out


def split_sessions(case, logs, tmp):
    """The JAX package's stored directories and the port's live ones for a
    split ``case``."""
    paths, log = logs[CASES[case]["log"]]
    files = REF(jax_cli, e2e_config(), log, CASES[case]["flags"], "merge" if case == "dense" else "split")
    jax_dir = jax_golden.write_dir(files, os.path.join(tmp, "jax"))
    port = split_session("port", os.path.join(tmp, "port"), paths, *CASES[case]["flags"])
    return {"jax": {k: os.path.join(jax_dir, k) for k in ("first", "resumed", "merge")}, "port": port}


@pytest.fixture(scope="module")
def dense(profile, logs, tmp_path_factory):
    return split_sessions("dense", logs, str(tmp_path_factory.mktemp("dense")))


@pytest.fixture(scope="module")
def fixed_lag(profile, logs, tmp_path_factory):
    return split_sessions("fixed_lag", logs, str(tmp_path_factory.mktemp("fixed_lag")))


@pytest.fixture(scope="module", params=sorted(FLAGS))
def flagged(request, profile, logs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("flags"))
    paths, log = logs["short"]
    files = REF(jax_cli, e2e_config(), log, FLAGS[request.param], "whole")
    jax_dir = jax_golden.write_dir(files, os.path.join(tmp, "jax"))
    port = run("port", os.path.join(tmp, "port"), paths["whole"], *FLAGS[request.param])
    return {"jax": os.path.join(jax_dir, "run"), "port": port}, request.param


def _read(out):
    summary = json.load(open(os.path.join(out, "summary.json")))
    stats = [json.loads(line) for line in open(os.path.join(out, "stats.jsonl"))]
    stamps, poses = read_tum(os.path.join(out, "robot_pose.txt"))
    lms = json.load(open(os.path.join(out, "landmarks.json")))
    return summary, stats, stamps, poses, lms


def assert_same_session(jout, tout):
    js, jst, jt, jp, jl = _read(jout)
    ts, tst, tt, tp, tl = _read(tout)
    for k in ("keyframes", "landmarks", "edges", "optimize_calls"):
        assert ts[k] == js[k], k
    assert js["keyframes"] > 0 and js["landmarks"] > 0
    assert [s["iterations"] for s in tst] == [s["iterations"] for s in jst]
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a["chi2_final"], b["chi2_final"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=0)
    assert [(x["class"], x["plane_type"]) for x in tl] == [(x["class"], x["plane_type"]) for x in jl]
    np.testing.assert_allclose([x["position"] for x in tl], [x["position"] for x in jl], atol=TOL, rtol=0)
    return js, jst


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def test_resume_dense_equals_jax(dense):
    first, _ = assert_same_session(dense["jax"]["first"], dense["port"]["first"])
    resumed, _ = assert_same_session(dense["jax"]["resumed"], dense["port"]["resumed"])
    assert resumed["keyframes"] > first["keyframes"] > 0  # the first half's keyframes survived, new ones came


def test_resume_fixed_lag_equals_jax(fixed_lag):
    z = np.load(os.path.join(fixed_lag["port"]["first"], "checkpoint.npz"))
    kf_base = json.loads(str(z["meta"]))["kf_base"]
    assert kf_base >= 8 and len(z["fl_archived"]) == kf_base and int(z["fl_num_p"]) >= 1
    assert np.abs(z["fl_Hl"]).sum() > 0
    assert_same_session(fixed_lag["jax"]["first"], fixed_lag["port"]["first"])
    resumed, _ = assert_same_session(fixed_lag["jax"]["resumed"], fixed_lag["port"]["resumed"])
    assert json.load(open(os.path.join(fixed_lag["port"]["first"], "summary.json")))["keyframes"] < resumed[
        "keyframes"]


@pytest.mark.parametrize("which", ["dense", "fixed_lag"])
def test_jax_session_checkpoint_loads_in_port(which, dense, fixed_lag):
    """The JAX package's first-half checkpoint, loaded by the port, holds the
    port's own first-half state within 1e-9."""
    sessions = {"dense": dense, "fixed_lag": fixed_lag}[which]
    cfg = tcfg.PROFILES[PROFILE]
    if which == "fixed_lag":
        cfg = cfg.replace(solver=dataclasses.replace(cfg.solver, fixed_lag_window=24))
    engines = []
    for pkg in ("jax", "port"):
        e = TorchEngine(cfg, device="cpu")
        tckpt.load_checkpoint(os.path.join(sessions[pkg]["first"], "checkpoint.npz"), e)
        engines.append(e)
    je, te = engines
    for name in ("graph", "table"):
        a, b = getattr(je, name), getattr(te, name)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name).numpy(), getattr(b, f.name).numpy()
            assert x.dtype == y.dtype, f.name
            np.testing.assert_allclose(x, y, atol=TOL, rtol=0, err_msg=f.name)
    for f in je.prior._fields:  # a point session's plane part is empty (Pl = 0) in both
        t = getattr(te.prior, f)
        np.testing.assert_allclose(getattr(je.prior, f).numpy(), t.numpy(), rtol=TOL,
                                   atol=TOL * max(1.0, float(t.abs().max()) if t.numel() else 0.0), err_msg=f)
    np.testing.assert_allclose(np.asarray(je.archived_poses).reshape(-1, 7),
                               np.asarray(te.archived_poses).reshape(-1, 7), atol=TOL, rtol=0)
    assert je._kf_base == te._kf_base and [k.node_idx for k in je.keyframes] == [k.node_idx for k in te.keyframes]


def test_keyframe_dumps_equal_jax(dense):
    jdir, tdir = (os.path.join(dense[p]["first"], "keyframes") for p in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert names and sorted(os.listdir(tdir)) == names
    for n in names:
        assert open(os.path.join(tdir, n, "data"), "rb").read() == open(os.path.join(jdir, n, "data"), "rb").read()


def test_saved_graph_equals_jax(dense):
    """``--save-graph``: the two packages' .g2o files parse to the same graph
    within 1e-9 (their text differs in the last digits of the f64 values)."""
    jg, tg = (tg2o.load_g2o(os.path.join(dense[p]["first"], "semantic_graph.g2o")) for p in ("jax", "port"))
    for f in ("num_poses", "num_landmarks", "num_odom", "num_lme", "odom_i", "odom_j", "lme_k", "lme_l"):
        assert np.array_equal(getattr(tg, f).numpy(), getattr(jg, f).numpy()), f
    for f in ("poses", "landmarks", "odom_meas", "odom_info", "lme_meas", "lme_info"):
        np.testing.assert_allclose(getattr(tg, f).numpy(), getattr(jg, f).numpy(), atol=TOL, rtol=TOL, err_msg=f)


# ---------------------------------------------------------------------------
# the run flags
# ---------------------------------------------------------------------------


def test_flags_equal_jax(flagged):
    outs, name = flagged
    _, stats = assert_same_session(outs["jax"], outs["port"])
    if name == "optimize-every 3":
        iters = [s["iterations"] for s in stats]
        assert iters[-1] > 0 and 0 in iters  # skipped ticks, then the finalize pass


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def test_merge_equals_jax(dense, tmp_path):
    """``merge`` of the first half's checkpoint with the resumed session's
    (the JAX package's stored with its sessions)."""
    ckpts = [os.path.join(dense["port"][s], "checkpoint.npz") for s in ("first", "resumed")]
    outs = {"jax": dense["jax"]["merge"], "port": merge("port", str(tmp_path / "port"), ckpts)}
    js, ts = (json.load(open(os.path.join(outs[p], "summary.json"))) for p in ("jax", "port"))
    assert set(ts) == set(js)
    for k in ("sessions", "poses", "landmarks", "edges", "landmarks_per_session", "lm_iterations"):
        assert ts[k] == js[k], k
    assert ts["landmarks"] <= sum(ts["landmarks_per_session"]) and ts["lm_iterations"] > 0
    for k in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(ts[k], js[k], rtol=TOL, atol=0)
    assert ts["chi2_final"] <= ts["chi2_initial"]
    (jt, jp), (tt, tp) = (read_tum(os.path.join(outs[p], "merged_pose.txt")) for p in ("jax", "port"))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=0)
    assert os.path.exists(os.path.join(outs["port"], "merged_graph.g2o"))


# ---------------------------------------------------------------------------
# autosave
# ---------------------------------------------------------------------------


def test_autosave_equals_explicit_checkpoint(logs, tmp_path):
    """Autosave every 2 ticks leaves the checkpoint that an explicit save
    after the session's last even tick writes (the same engine saves both:
    the autosave at the end of the tick, the explicit one as ``run()``
    returns)."""
    log = treplay.load_log(logs["short"][0]["whole"])
    auto, explicit = str(tmp_path / "auto.npz"), str(tmp_path / "explicit.npz")
    e = TorchEngine(to_port(e2e_config()).replace(autosave_every_n_ticks=2, autosave_path=auto), device="cpu")
    run_tick, saved = e.run, []

    def run_and_save():
        ran = run_tick()
        if ran and e._ticks_done % 2 == 0:
            tckpt.save_checkpoint(explicit, e)
            saved.append(e._ticks_done)
        return ran

    e.run = run_and_save
    treplay.replay(log, e)
    assert len(saved) == e._ticks_done // 2 > 1
    a, b = np.load(auto), np.load(explicit)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(json.loads(str(a["meta"]))["stats_history"]) == e._ticks_done - e._ticks_done % 2
