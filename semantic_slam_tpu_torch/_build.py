"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, which
is loaded with ``ctypes``. The library lands in ``build/semantic_slam_tpu_torch/``
at the root of the checkout and is rebuilt when a source is newer. Nothing is
built when the package is imported, and nothing is fetched: the build uses
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
LIB_NAME = "libslam_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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


def build(verbose: bool = False) -> Path:
    """Compile the kernels if the library is missing or older than a source."""
    srcs = sources()
    lib = BUILD_DIR / LIB_NAME
    if lib.exists() and all(lib.stat().st_mtime >= s.stat().st_mtime for s in srcs):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.score_hypotheses_launch.argtypes = [p, p, p, p, p, i, i, i, f, f, p, p]
    lib.score_hypotheses_launch.restype = ctypes.c_int
    lib.slam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.slam_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().slam_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
