"""ctypes bindings for the native ``.slog`` log format (the port's own copy of
``semantic_slam_tpu.native``: the writer and the mmap reader; the C++
keyframe gate stays unbound, the port's gate is ``runtime/keyframe_gate``).

``slamlog.cpp`` is compiled on first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/semantic_slam_tpu_torch/libslamlog.so`` at the root
of the checkout, beside the CUDA kernel libraries, and rebuilt when the
source is newer. A failed build raises with g++'s output: there is no
fallback.
"""

from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import threading

import numpy as np

from semantic_slam_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(__file__), "slamlog.cpp")
_LIB = str(BUILD_DIR / "libslamlog.so")
_lock = threading.Lock()
_lib = None

SOURCE_IDS = {"rovio": 0, "snap": 1, "jackal": 2, "orb": 3}
SOURCE_NAMES = {v: k for k, v in SOURCE_IDS.items()}


def _build() -> None:
    """Compile the library into a file of this process, then move it into
    place, so that processes compiling it at once never load a half-written
    file."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the .slog library needs a C++17 compiler to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, _LIB)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = C.CDLL(_LIB)
        # writer
        lib.slog_writer_create.restype = C.c_void_p
        lib.slog_writer_create.argtypes = [C.c_char_p, C.c_uint32, C.c_uint32, C.c_uint32]
        lib.slog_add_odom.argtypes = [C.c_void_p, C.c_double, C.c_uint8, C.c_void_p, C.c_void_p]
        lib.slog_add_cloud.argtypes = [C.c_void_p, C.c_double, C.c_void_p, C.c_void_p]
        lib.slog_add_detections.argtypes = [C.c_void_p, C.c_double, C.c_uint32, C.c_void_p, C.c_void_p, C.c_void_p]
        lib.slog_add_gt.argtypes = [C.c_void_p, C.c_double, C.c_void_p]
        lib.slog_writer_finish.argtypes = [C.c_void_p]
        lib.slog_writer_finish.restype = C.c_int
        # reader
        lib.slog_open.restype = C.c_void_p
        lib.slog_open.argtypes = [C.c_char_p]
        lib.slog_close.argtypes = [C.c_void_p]
        lib.slog_counts.argtypes = [C.c_void_p, C.c_void_p]
        lib.slog_dims.argtypes = [C.c_void_p, C.c_void_p]
        lib.slog_num_events.restype = C.c_size_t
        lib.slog_num_events.argtypes = [C.c_void_p]
        lib.slog_event.argtypes = [C.c_void_p, C.c_size_t, C.c_void_p, C.c_void_p]
        lib.slog_odom.restype = C.c_void_p
        lib.slog_odom.argtypes = [C.c_void_p, C.c_size_t]
        lib.slog_cloud_time.restype = C.c_double
        lib.slog_cloud_time.argtypes = [C.c_void_p, C.c_size_t]
        lib.slog_cloud_xyz.restype = C.c_void_p
        lib.slog_cloud_xyz.argtypes = [C.c_void_p, C.c_size_t]
        lib.slog_cloud_valid.restype = C.c_void_p
        lib.slog_cloud_valid.argtypes = [C.c_void_p, C.c_size_t]
        lib.slog_det.restype = C.c_void_p
        lib.slog_det.argtypes = [C.c_void_p, C.c_size_t]
        lib.slog_gt.restype = C.c_void_p
        lib.slog_gt.argtypes = [C.c_void_p, C.c_size_t]
        _lib = lib
        return _lib


# ---------------------------------------------------------------------------


def write_slog(path: str, log, height: int, width: int, max_det: int = 8) -> None:
    """Serialize a ReplayLog to the SLOG binary format."""
    lib = _load()
    w = lib.slog_writer_create(path.encode(), height, width, max_det)
    if not w:
        raise OSError(f"cannot create {path}")
    for e in log.odom:
        pose = np.ascontiguousarray(e.pose7, np.float64)
        cov = np.ascontiguousarray(e.cov, np.float64).reshape(-1) if e.cov is not None else None
        lib.slog_add_odom(
            w, e.t, SOURCE_IDS.get(e.source, 0),
            pose.ctypes.data_as(C.c_void_p),
            cov.ctypes.data_as(C.c_void_p) if cov is not None else None,
        )
    for e in log.clouds:
        xyz = np.ascontiguousarray(e.points, np.float32)
        valid = np.ascontiguousarray(e.valid, np.uint8)
        if xyz.shape[:2] != (height, width):
            raise ValueError(f"cloud of shape {xyz.shape[:2]} in a {height}x{width} log")
        lib.slog_add_cloud(w, e.t, xyz.ctypes.data_as(C.c_void_p), valid.ctypes.data_as(C.c_void_p))
    for e in log.detections:
        boxes = np.ascontiguousarray(e.boxes, np.float32)
        cids = np.ascontiguousarray(e.class_ids, np.int32)
        probs = np.ascontiguousarray(e.probs, np.float32)
        lib.slog_add_detections(
            w, e.t, len(boxes),
            boxes.ctypes.data_as(C.c_void_p),
            cids.ctypes.data_as(C.c_void_p),
            probs.ctypes.data_as(C.c_void_p),
        )
    for e in log.gt:
        pose = np.ascontiguousarray(e.pose7, np.float64)
        lib.slog_add_gt(w, e.t, pose.ctypes.data_as(C.c_void_p))
    rc = lib.slog_writer_finish(w)
    if rc != 0:
        raise OSError(f"slog write of {path} failed: {rc}")


class SlogReader:
    """mmap-backed reader; ``cloud`` returns zero-copy views into the file,
    valid only until ``close``: whoever keeps one past it copies it first."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._r = lib.slog_open(path.encode())
        if not self._r:
            raise OSError(f"cannot open {path}")
        counts = np.zeros(4, np.uint64)
        lib.slog_counts(self._r, counts.ctypes.data_as(C.c_void_p))
        self.n_odom, self.n_cloud, self.n_det, self.n_gt = (int(x) for x in counts)
        dims = np.zeros(3, np.uint32)
        lib.slog_dims(self._r, dims.ctypes.data_as(C.c_void_p))
        self.height, self.width, self.max_det = (int(x) for x in dims)

    def close(self):
        if self._r:
            self._lib.slog_close(self._r)
            self._r = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def events(self):
        """Yield (kind, idx) in pre-merged delivery order.
        kind: 0 cloud, 1 detections, 2 odom, 3 gt."""
        k = C.c_uint8()
        i = C.c_uint32()
        for e in range(self._lib.slog_num_events(self._r)):
            self._lib.slog_event(self._r, e, C.byref(k), C.byref(i))
            yield int(k.value), int(i.value)

    def odom(self, i: int):
        p = self._lib.slog_odom(self._r, i)
        buf = np.frombuffer(C.string_at(p, 8 + 8 + 7 * 8 + 36 * 8), np.uint8)
        t = buf[:8].view(np.float64)[0]
        source = int(buf[8])
        pose = buf[16 : 16 + 56].view(np.float64).copy()
        cov = buf[16 + 56 :].view(np.float64).reshape(6, 6).copy()
        return float(t), SOURCE_NAMES.get(source, "rovio"), pose, cov

    def cloud(self, i: int):
        npix = self.height * self.width
        t = self._lib.slog_cloud_time(self._r, i)
        xyz_p = self._lib.slog_cloud_xyz(self._r, i)
        val_p = self._lib.slog_cloud_valid(self._r, i)
        xyz = np.frombuffer((C.c_float * (npix * 3)).from_address(xyz_p), np.float32).reshape(
            self.height, self.width, 3)
        valid = np.frombuffer((C.c_uint8 * npix).from_address(val_p), np.uint8).reshape(self.height, self.width)
        return float(t), xyz, valid.astype(bool)

    def detections(self, i: int):
        md = self.max_det
        rec = 8 + 8 + md * 16 + md * 4 + md * 4
        p = self._lib.slog_det(self._r, i)
        buf = np.frombuffer(C.string_at(p, rec), np.uint8)
        t = buf[:8].view(np.float64)[0]
        n = int(buf[8:12].view(np.uint32)[0])
        off = 16
        boxes = buf[off : off + md * 16].view(np.float32).reshape(md, 4)[:n].copy()
        off += md * 16
        cids = buf[off : off + md * 4].view(np.int32)[:n].copy()
        off += md * 4
        probs = buf[off : off + md * 4].view(np.float32)[:n].copy()
        return float(t), boxes, cids, probs

    def gt(self, i: int):
        p = self._lib.slog_gt(self._r, i)
        buf = np.frombuffer(C.string_at(p, 8 + 56), np.uint8)
        return float(buf[:8].view(np.float64)[0]), buf[8:].view(np.float64).copy()
