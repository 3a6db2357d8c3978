"""Regenerate the stored JAX references of the port's parity tests
(``tests/golden/jax/<family>.npz``; ``tests/jax_golden.py`` says what they
hold, ``tests/test_jax_golden.py`` guards them).

Run from the repo root after a change to ``semantic_slam_tpu/``, or to a
family's calls (the failing test names the family):

    python tests/golden/regen_jax.py [FAMILY ...] [--jobs N]

Without a name it regenerates every family. Each family's test module runs
twice, each time in a fresh pytest with ``JAX_GOLDEN_RECORD`` set, so that
every reference call runs live and is recorded: once with XLA's CPU intra-op
work on one thread (one core by affinity, Eigen single-threaded) and once at
the default thread count. A call of the default run is stored only where
the two agree: every integer, string and byte outside a float is equal, and
the largest difference of any float (in arrays, JSON values and the numbers
of text files; the solve times aside), absolute below one and relative
above, is at most a thousandth of the call's tolerance. A call that fails
this is listed in the file instead of stored, and runs live in the tests. A
test that fails in the default run stores nothing.

Drift check, on an 8-core x86 CPU that other runs shared (so the times are
high): the largest drift of a stored call, in units of its tolerance, and
the seconds of the default-thread and one-thread runs of the module (its
port side included); 1,647,248 bytes in all:

  family                  tol     drift    default / one s   live calls
  torch_breadth_cli       1e-9    7.6e-5   263 / 418         -
  torch_fixed_lag         1e-8    2.8e-4   88 / 312          -
  torch_fixed_lag_engine  1e-6    2.1e-6   100 / 251         -
  torch_lifecycle         1e-9    3.5e-4   155 / 523         -
  torch_lm                1e-9    4.7e-6   38 / 54           4: linearize_arrays (3 kinds; 4.7e-3
                                                             of its 1e-12), lm_optimize f64 (4.7e3)
  torch_mesh              1e-8    2.6e-10  59 / 98           -
  torch_mesh_engine       1e-6    6.9e-9   118 / 256         -
  torch_mesh_planes       1e-8    1.1e-11  69 / 121          -
  torch_mesh_window       1e-8    3.9e-7   65 / 111          1: the sharded tridiag PCG (3.0e4 of
                                                             its 1e-6)
  torch_planes            1e-9    2.3e-4   150 / 445         1: lm_optimize_pcg_planes with
                                                             marginals (587 of its 1e-6)
  torch_planes_engine     1e-9    4.9e-4   532 / 793         -
  torch_slice             1e-6    1.8e-8   468 / 879         -
  torch_soa               1e-10   5.6e-6   291 / 385         -
  torch_tiled             1e-8    1.0e-9   145 / 226         -
  torch_tridiag           1e-10   1.5e-5   71 / 121          3: the tridiag LMs (resident 1.7e6,
                                                             pcg 8.3e3, pcg planes 2.6e4)
  torch_window            1e-9    1.7e-5   344 / 500         -

The one-thread runs drift from the default ones because
``--xla_cpu_multi_thread_eigen=false`` selects other matmul kernels: the
core count alone (the thread pool's size) left the outputs of three solver
programs (the tridiag resident LM, the dense LM with marginals, the tridiag
PCG) bit for bit equal at 1, 2 and 8 cores.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
REPO = os.path.dirname(TESTS)
sys.path[:0] = [TESTS, REPO]

import jax_golden  # noqa: E402

MODULES = jax_golden.FAMILY_MODULES


def calls(packed: dict) -> dict:
    """A recorded run's calls by the test and order that made them: (input
    key, tree, leaves, tolerance)."""
    out = {}
    for k in packed:
        if k.endswith("/label"):
            key = k[:-len("/label")]
            leaves = [packed[f"{key}/{i}"] for i in range(int(packed[f"{key}/leaves"]))]
            out[str(packed[k])] = (key, json.loads(str(packed[f"{key}/tree"])), leaves,
                                   json.loads(str(packed[f"{key}/tol"])))
    return out


def compare(one: dict, default: dict) -> tuple[jax_golden.Drift, list, list]:
    """Each call's drift between the two runs against its own tolerance:
    the largest over the calls kept, the input keys (with label, drift and
    tolerance) of the calls that fail it, and faults of the runs themselves
    (a call made in one run only)."""
    worst, live, faults = jax_golden.Drift(1.0), [], []
    a, b = calls(one), calls(default)
    for label in sorted(set(a) | set(b)):
        if label not in a or label not in b:
            faults.append(f"{label}: made in one run only")
            continue
        (ka, ta, la, tol), (kb, tb, lb, _) = a[label], b[label]
        call = jax_golden.Drift(tol)
        if ka != kb:
            call.faults.append(f"{label}: inputs differ")
        call.tree(ta, la, tb, lb, label)
        if call.faults or call.worst > jax_golden.DRIFT_BOUND:
            live.append((kb, label, call.worst, tol, call.faults[:2]))
            continue
        worst.max_abs = max(worst.max_abs, call.max_abs)
        if call.worst >= worst.worst:
            worst.worst, worst.where = call.worst, call.where
    return worst, live, faults


def run_module(family: str, out: str, single: bool) -> float:
    """The family's test module in a fresh pytest, its calls recorded to
    ``out``; the seconds it took."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **{jax_golden.RECORD_ENV: f"{family}={out}"},
               # a persistent compilation cache of its own: each run compiles afresh
               JAX_COMPILATION_CACHE_DIR=out + ".xla")
    # --confcutdir: the tests' JAX settings (tests/conftest.py) without the
    # tier-1 run's harness (the repo root's conftest.py and its time limits)
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
           f"--confcutdir={TESTS}", os.path.join(TESTS, MODULES[family] + ".py")]
    if single:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false").strip()
        cores = sorted(os.sched_getaffinity(0))
        cmd = ["taskset", "-c", str(cores[sorted(MODULES).index(family) % len(cores)])] + cmd
    t = time.time()
    proc = subprocess.run(cmd, env=env, cwd=REPO)
    # on one thread a test may fail where the reference drifts past its
    # tolerance: the drift check then keeps that call live
    if proc.returncode and not single:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return time.time() - t


def regen(family: str, tmp: str) -> dict:
    paths = {s: os.path.join(tmp, f"{family}.{s}.npz") for s in ("one", "default")}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        secs = dict(zip(paths, pool.map(lambda s: run_module(family, paths[s], s == "one"), paths)))
    one, default = (dict(np.load(paths[s])) for s in ("one", "default"))
    fam = jax_golden.family(family)
    drift, live, faults = compare(one, default)
    for key, *_ in live:
        for k in [k for k in default if k.startswith(key + "/")]:
            del default[k]
    report = {"family": family, "tol": fam.tol, "worst": drift.worst, "at": drift.where,
              "max_abs_drift": drift.max_abs, "faults": faults[:10],
              "live_calls": [f"{label}: {worst:.3g} of tol {tol} {bad}" for _, label, worst, tol, bad in live],
              "seconds_default": round(secs["default"], 1), "seconds_one_thread": round(secs["one"], 1),
              "stored": not faults}
    if not faults:
        meta = {"source": jax_golden.source_hash(), "spec": fam.spec_digest(), "live": [key for key, *_ in live],
                "drift": {k: report[k] for k in ("tol", "worst", "at", "max_abs_drift", "live_calls",
                                                 "seconds_default", "seconds_one_thread")}}
        os.makedirs(jax_golden.GOLDEN_DIR, exist_ok=True)
        np.savez_compressed(fam.path, __meta__=np.array(json.dumps(meta)), **default)
        report["bytes"] = os.path.getsize(fam.path)
    return report


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("families", nargs="*", help=f"of {sorted(MODULES)}; all without one")
    p.add_argument("--jobs", type=int, default=2, help="families computed at once (two processes each)")
    args = p.parse_args()
    names = args.families or sorted(MODULES)
    unknown = set(names) - set(MODULES)
    if unknown:
        p.error(f"unknown families {sorted(unknown)}")
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        failed = False
        for rep in pool.map(lambda f: regen(f, tmp), names):
            print(json.dumps(rep), flush=True)
            failed |= not rep["stored"]
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
