"""Find a cell's configuration, traffic mix and per-layer metrics by the
names ``BENCHMARK.json`` gives them. Each is a file of its own:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric name>.py``, so that a later cell, mix or metric is added
by adding files and entries only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: its ``READS`` says what it reads,
    its ``read(record)`` returns the number, or None where the run holds
    nothing for it to read."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)} for the per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
