"""Every configuration, traffic mix, per-layer metric and limits file that
BENCHMARK.json names is found by its name."""

import json

import pytest

from slam_bench import check, registry

BENCH = registry.load_benchmark()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    cfg = registry.config(w["config"])
    tr = registry.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert tr["mode"] in ("sessions", "drive")
    limits = check.load_limits(w["name"])
    assert set(limits) - {"required"} <= set(check.NUMBERS) and {"plane_gap", "det_miss", "assoc_miss"} <= set(limits)
    assert set(limits.get("required", ())) <= set(limits)
    for section in ("end_to_end", "per_layer"):
        assert registry.cell_metrics(BENCH, w["name"], section)
    names = {m["name"] for m in registry.cell_metrics(BENCH, w["name"], "end_to_end")}
    assert {"setup_s", "kf_per_s", "ate_cm"} <= names


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_reader(m):
    mod = registry.metric_reader(m["name"])
    assert mod.READS and callable(mod.read)
    ends = {e["name"]: e for e in BENCH["end_to_end"]}
    moved = ends[m["moves"]]
    # every cell that reports the metric also reports the end-to-end metric it moves
    assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(c):
    body = json.loads((registry.ROOT / c["file"]).read_text())
    assert body["source"] == c["source"] and body["reduced"] == c["reduced"]


def test_unknown_names_fail():
    with pytest.raises(KeyError):
        registry.workload(BENCH, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no_such_metric")
