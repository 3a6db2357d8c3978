"""The tier-1 run's harness, loaded before ``tests/conftest.py``: a time limit
for every test, each xdist worker on its share of the CPU's cores, the order
of the ``--dist loadfile`` queue, and the JAX package's persistent
compilation cache."""

import faulthandler
import os
import signal
import sys
import tempfile
import threading

import pytest


def _share_cores_among_workers() -> None:
    """Under xdist, keep each worker on its share of the cores.

    JAX's CPU client sizes its thread pools by the process's CPU affinity.
    Six workers on an 8-core CPU, each with pools of 8 threads, spend much
    of the machine waiting on one another's threads: a KITTI scenario
    session took 203 s of CPU at 8 threads, 98 s on 2 cores, with the same
    results (the pools' size does not change what XLA:CPU computes; the
    solvers' outputs were checked bit for bit at 1, 2 and 8 cores). So
    worker i of n keeps ceil(cores / n) cores from core i * cores / n on,
    before JAX starts; the workers' windows overlap by at most one core."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = sorted(os.sched_getaffinity(0))
    share = -(-len(cores) // workers)
    if workers < 2 or share >= len(cores):
        return
    start = int(os.environ["PYTEST_XDIST_WORKER"].lstrip("gw")) * len(cores) // workers
    os.sched_setaffinity(0, [cores[(start + k) % len(cores)] for k in range(share)])


_share_cores_among_workers()


def pytest_configure(config):
    # Every compile of half a second or more goes to the JAX package's
    # persistent compilation cache (``semantic_slam_tpu/utils/cache.py``:
    # under $HOME unless JAX_COMPILATION_CACHE_DIR names another directory),
    # as the package's engine turns it on for itself: a program that another
    # test file, another xdist worker, or this worker before a
    # ``jax.clear_caches()`` compiled is read back instead of compiled again.
    try:
        import jax  # noqa: F401
    except ImportError:  # the card's machine runs the port's tests without JAX
        return
    from semantic_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()


# ---------------------------------------------------------------------------
# the loadfile queue
# ---------------------------------------------------------------------------

# xdist's loadfile queue puts the files with the most tests first, so a heavy
# file with few tests starts last and runs on alone at the end. The files
# that take a worker more than ~300 s of a whole tier-1 run start first, in
# this order.
LONG_FILES = (
    "tests/test_engine_mesh.py",
    "tests/test_ingest_window.py",
    "tests/test_soa_dist.py",
    "tests/test_ellk_soa.py",
    "tests/test_pcg.py",
    "tests/test_ell_engine.py",
)
# Files whose tests share no module fixture and whose sum is longer than a
# worker should take: each test is a unit of the queue of its own.
SPLIT_FILES = ("tests/test_soa_dist.py",)


def pytest_xdist_make_scheduler(config, log):
    """``--dist loadfile``, with ``SPLIT_FILES`` split into their tests and
    ``LONG_FILES`` at the head of the queue."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            return nodeid if path in SPLIT_FILES else path

        def _assign_work_unit(self, node):
            if not getattr(self, "_ordered", False):
                self._ordered = True
                rank = {path: i for i, path in enumerate(LONG_FILES)}
                first = sorted((s for s in self.workqueue if s.split("::", 1)[0] in rank),
                               key=lambda s: rank[s.split("::", 1)[0]])
                for scope in reversed(first):
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return Scheduling(config, log)


# ---------------------------------------------------------------------------
# a time limit for each test
# ---------------------------------------------------------------------------

# Every test runs under a limit, its setup and teardown included (so a module
# fixture's setup counts against the first test that uses it): at the limit
# SIGALRM fails the test with its name and a dump of every thread's stack, and
# the run goes on. ``@pytest.mark.time_limit(seconds)`` raises one test's
# limit. A hang inside native code that never returns to the interpreter is
# not interrupted by the signal; 60 s past the limit faulthandler dumps the
# stacks and ends the process (under xdist the worker is replaced and the run
# goes on).
DEFAULT_TIME_LIMIT_S = 300.0
HARD_EXIT_AFTER_S = 60.0


class TimeLimitExceeded(pytest.fail.Exception):
    """A test ran past its time limit: a test failure, which no ``except
    Exception`` in the code under test swallows, and which a fixture whose
    setup it cut keeps for the rest of its scope (not set up again for each
    test that uses it)."""


def time_limit_of(item) -> float:
    marker = item.get_closest_marker("time_limit")
    return float(marker.args[0]) if marker else DEFAULT_TIME_LIMIT_S


def _stacks() -> str:
    with tempfile.TemporaryFile("w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


def _arm(item) -> None:
    if threading.current_thread() is not threading.main_thread():
        return
    limit = time_limit_of(item)

    def on_alarm(signum, frame):
        raise TimeLimitExceeded(f"{item.nodeid} ran past its time limit of {limit:g} s (setup and teardown "
                                f"included); the stacks of every thread:\n{_stacks()}")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + HARD_EXIT_AFTER_S, exit=True, file=sys.stderr)


def _disarm() -> None:
    if threading.current_thread() is not threading.main_thread():
        return
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()
    signal.signal(signal.SIGALRM, signal.SIG_DFL)


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    _arm(item)
    yield


@pytest.hookimpl(hookwrapper=True, tryfirst=True)
def pytest_runtest_teardown(item, nextitem):
    try:
        yield
    finally:
        _disarm()
