"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` of the package is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library ``lib<name>.so`` with a plain C
interface, loaded with ``ctypes``. All sources that need a build are
compiled at once, one ``nvcc`` process each, started together. The libraries
land in ``build/semantic_slam_tpu_torch/`` at the root of the checkout and
are rebuilt when their source, or a ``csrc/*.cuh`` header, is newer. Nothing
is built when the package is imported, and nothing is fetched: the build uses
only the sources in the package and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "semantic_slam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: name -> (argtypes, restype)
SIGNATURES: dict[str, dict[str, tuple[list, type]]] = {
    "score_hypotheses": {
        "score_hypotheses_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P], ctypes.c_int),
    },
    "soa_linearize": {
        "soa_lin_scratch": ([_I] * 4, ctypes.c_longlong),
        "soa_lin_launch": ([_P] * 9 + [_I] * 7 + [_F] + [_P] * 16, ctypes.c_int),
    },
    "soa_chi2": {
        "soa_chi2_scratch": ([_I, _I, _I], ctypes.c_longlong),
        "soa_chi2_launch": ([_P] * 7 + [_I] * 5 + [_F] + [_P] * 3, ctypes.c_int),
    },
    "soa_solve": {
        "soa_solve_scratch": ([_I] * 5, ctypes.c_longlong),
        "soa_solve_cluster_smem": ([_I] * 3, ctypes.c_longlong),
        "soa_solve_smem_optin": ([], ctypes.c_longlong),
        "soa_solve_launch": ([_P] * 18 + [_I, _F, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P], ctypes.c_int),
    },
    "tiled_linearize": {
        "tiled_lin_scratch": ([_I] * 4, ctypes.c_longlong),
        "tiled_lin_launch": ([_P] * 10 + [_I] * 7 + [_F] + [_P] * 16, ctypes.c_int),
    },
    "tiled_matvec": {
        "tiled_mv_fwd_launch": ([_P] * 6 + [_I, _I, _I] + [_P] * 3, ctypes.c_int),
        "tiled_mv_bwd_launch": ([_P] * 11 + [_I, _I] + [_P] * 3, ctypes.c_int),
    },
    "tiled_chi2": {
        "tiled_chi2_scratch": ([_I] * 3, ctypes.c_longlong),
        "tiled_chi2_launch": ([_P] * 8 + [_I] * 5 + [_F] + [_P] * 3, ctypes.c_int),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def sources() -> list[Path]:
    return sorted(SOURCES_DIR.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(src: Path, headers: list[Path]) -> bool:
    lib = lib_path(src.stem)
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    return any(p.stat().st_mtime > t for p in (src, *headers))


def build(verbose: bool = False) -> list[Path]:
    """Compile every source whose library is missing or stale, all at once;
    returns the libraries."""
    srcs = sources()
    headers = sorted(SOURCES_DIR.glob("*.cuh"))
    todo = [s for s in srcs if _stale(s, headers)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in todo:
            tmp = lib_path(src.stem).with_name(f"lib{src.stem}.so.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(src)]
            jobs.append((src, tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failures = []
        for src, tmp, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
                continue
            if verbose:
                print(f"-- {src.name}\n{err}", end="")
            os.replace(tmp, lib_path(src.stem))
        if failures:
            raise RuntimeError("\n".join(failures))
    return [lib_path(s.stem) for s in srcs]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built on first call."""
    with _lock:
        if name not in _libs:
            if not (SOURCES_DIR / f"{name}.cu").exists():
                raise KeyError(f"no kernel source csrc/{name}.cu")
            build()
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, (argtypes, restype) in SIGNATURES.get(name, {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.slam_cuda_error_string.argtypes = [ctypes.c_int]
            lib.slam_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def check(code: int, what: str, name: str) -> None:
    """Raise if a C entry point of ``lib<name>.so`` returned a CUDA error."""
    if code != 0:
        msg = library(name).slam_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
