"""A short run of each cell on the card, as the benchmark runs it; skipped
where torch sees no CUDA device (decided inside the test)."""

import pytest
import torch

from slam_bench import check, registry, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in registry.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    bench = registry.load_benchmark()
    w = registry.workload(bench, cell)
    res = run.run_cell(cell, registry.config(w["config"]), registry.traffic(w["traffic"]), 97531, 5.0, False,
                       "cuda", check.load_limits(cell))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
