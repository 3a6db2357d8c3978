"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import sys
import types

from slam_bench import registry, run

FORBIDDEN = {"jax", "jaxlib", "flax", "semantic_slam_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted((registry.HERE).rglob("*.py"))
    assert files
    for f in files:
        assert not (_top_level_imports(f) & FORBIDDEN), f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((registry.HERE / "reference").glob("*.py")):
        assert "semantic_slam_tpu_torch" not in _top_level_imports(f), f


def test_loaded_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "semantic_slam_tpu_torch_like", types.ModuleType("x"))
    assert "semantic_slam_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "semantic_slam_tpu.io", types.ModuleType("semantic_slam_tpu.io"))
    assert run.loaded_forbidden() == ["semantic_slam_tpu"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = registry.load_benchmark()["workloads"][0]["name"]
    assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
