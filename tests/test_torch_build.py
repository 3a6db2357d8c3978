"""The C entry points of the port's CUDA sources against the ctypes
signatures ``_build.SIGNATURES`` binds them with: the CPU has no nvcc, and a
pointer bound as an int, or an argument left out, shows only on the card as
a fault or a wrong answer. Each ``extern "C"`` function of
``semantic_slam_tpu_torch/csrc/*.cu`` is parsed from its source."""

import ctypes
import re

import pytest

from semantic_slam_tpu_torch import _build

EXTERN = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')


def _ctype(decl: str):
    """The ctypes type a C parameter or return type binds to."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return ctypes.c_void_p
    if "long long" in decl:
        return ctypes.c_longlong
    if decl.split()[0] in ("int", "const") and "int" in decl:
        return ctypes.c_int
    if "float" in decl:
        return ctypes.c_float
    raise ValueError(f"unknown C type {decl!r}")


def _entry_points(name: str) -> dict:
    src = (_build.SOURCES_DIR / f"{name}.cu").read_text()
    out = {}
    for ret, fn, params in EXTERN.findall(src):
        params = [p for p in (q.strip() for q in params.split(",")) if p]
        args = [_ctype(re.sub(r"\w+$", "", p)) for p in params]
        out[fn] = (args, _ctype(ret))
    return out


@pytest.mark.parametrize("name", sorted(s.stem for s in _build.sources()))
def test_signatures_match_sources(name):
    found = _entry_points(name)
    assert found.pop("slam_cuda_error_string")[0] == [ctypes.c_int]
    assert found == _build.SIGNATURES.get(name, {})
