"""The per-test time limit of the repo root's ``conftest.py``: a small test
file run by a pytest of its own, as the tier-1 run runs (two xdist workers,
``--dist loadfile``), beside a copy of that conftest that also records,
after each test, whether the alarm is still set."""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

CASES = '''
import os
import signal
import time

import pytest


@pytest.fixture(scope="module")
def slow_module_fixture():
    with open(os.environ["TIMER_LOG"] + ".setups", "a") as f:
        f.write("setup\\n")
    time.sleep(1.5)
    return 1


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(30)


def test_passes():
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0  # armed while it runs


def test_after_the_hang():
    pass


@pytest.mark.time_limit(1)
def test_module_setup_counts(slow_module_fixture):
    pass  # the body takes no time: the module fixture's setup does


@pytest.mark.time_limit(1)
def test_module_setup_not_repeated(slow_module_fixture):
    pass  # the fixture cut above fails here at once
'''

RECORDER = '''


def pytest_runtest_logfinish(nodeid, location):
    import json

    with open(os.environ["TIMER_LOG"], "a") as f:
        f.write(json.dumps({"test": nodeid.split("::")[-1], "left": signal.getitimer(signal.ITIMER_REAL)[0],
                            "handler_reset": signal.getsignal(signal.SIGALRM) == signal.SIG_DFL}) + "\\n")
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The outcomes and messages by test, the records after each test, and
    the run's wall time."""
    d = tmp_path_factory.mktemp("limits")
    shutil.copy(os.path.join(REPO, "conftest.py"), d / "conftest.py")
    with open(d / "conftest.py", "a") as f:
        f.write(RECORDER)
    (d / "test_cases.py").write_text(CASES)
    log = d / "timers.jsonl"
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
                           "--dist", "loadfile", "-p", "no:randomly", "-W", "ignore::pytest.PytestUnknownMarkWarning",
                           f"--junitxml={d / 'out.xml'}", str(d)],
                          cwd=d, env=dict(os.environ, TIMER_LOG=str(log),
                                          PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])),
                          capture_output=True, text=True,
                          timeout=240)
    outcomes = {}
    for case in ET.parse(d / "out.xml").getroot().iter("testcase"):
        bad = case.find("failure")
        bad = case.find("error") if bad is None else bad
        outcomes[case.get("name")] = (float(case.get("time")), None if bad is None else bad.get("message", "") +
                                      (bad.text or ""))
    records = {r["test"]: r for r in map(json.loads, log.read_text().splitlines())}
    setups = len((d / "timers.jsonl.setups").read_text().splitlines())
    return outcomes, records, proc, setups


def test_sleep_past_limit_fails_with_name_and_stacks(run):
    outcomes, _, proc, _ = run
    secs, message = outcomes["test_sleeps_past_its_limit"]
    assert message is not None, proc.stdout[-2000:]
    assert "test_sleeps_past_its_limit ran past its time limit of 1 s" in message
    assert "most recent call first" in message and "time.sleep(30)" in message  # faulthandler's dump
    assert secs < 10


def test_alarm_cleared_after_each_test(run):
    outcomes, records, _, _ = run
    assert outcomes["test_passes"][1] is None
    assert sorted(records) == sorted(outcomes)
    for name, r in records.items():
        assert r["left"] == 0.0 and r["handler_reset"], name


def test_module_fixture_setup_counts_against_first_test(run):
    outcomes, _, _, _ = run
    _, message = outcomes["test_module_setup_counts"]
    assert message is not None and "test_module_setup_counts ran past its time limit of 1 s" in message
    assert "slow_module_fixture" in message


def test_fixture_cut_by_the_limit_is_not_set_up_again(run):
    """The module fixture whose setup ran past the limit fails the next test
    that uses it at once, from its kept failure."""
    outcomes, _, _, setups = run
    secs, message = outcomes["test_module_setup_not_repeated"]
    assert message is not None and "test_module_setup_counts ran past its time limit" in message
    assert secs < 1.0
    assert setups == 1


def test_run_goes_on_after_a_hang(run):
    outcomes, _, proc, _ = run
    assert outcomes["test_after_the_hang"][1] is None
    # the hang fails in its call, the slow module fixture in its tests' setup
    assert proc.returncode == 1 and "1 failed, 2 passed" in proc.stdout and "2 errors" in proc.stdout, \
        proc.stdout[-2000:]
