"""Stored outputs of the JAX package for the port's parity tests.

``semantic_slam_tpu/`` is the frozen reference: its output for given inputs
never changes, so the port's tests read it from
``tests/golden/jax/<family>.npz`` instead of computing it in every run. The
port side still runs live in every test.

A family is one test module's reference calls. Where the module would call
``fn(*args, **kwargs)`` (a function of the JAX package, or a helper of the
tests that runs a whole engine session or CLI command of it), it calls
``REF(fn, *args, **kwargs)`` and gets what ``fn`` returned, read from the
file under the digest of the function's name, its arguments (floats on a
2^-26 grid of their scale), a ``context`` the call reads besides and, for a
helper of the tests, its source and the sources of the test functions it
calls. The file's ``__meta__`` record holds the hash of the
``semantic_slam_tpu/`` sources, the family's spec and the drift check that
admitted it (``tests/golden/regen_jax.py``). ``tests/test_jax_golden.py``
fails when the sources or the spec no longer match; a call whose inputs
have no stored output fails where it is made; ``REF.check_live`` recomputes
a stored call and holds it to the stored output, so that every run ties the
files to the package. Each failure names the regeneration command.

An output is a tree of tuples, named tuples, lists, dicts, Python scalars,
arrays (stored as numpy) and bytes (a file's contents: ``read_dir`` and
``write_dir`` carry a CLI's output directory).
"""

import atexit
import collections
import dataclasses
import hashlib
import importlib
import inspect
import io
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "jax")
SOURCES = os.path.join(REPO, "semantic_slam_tpu")
# build outputs the package makes for itself (the .slog reader's library)
SOURCE_SKIP = (".so", ".pyc")
# each family and the test module that defines it
FAMILY_MODULES = {
    "torch_lifecycle": "test_torch_lifecycle",
    "torch_planes_engine": "test_torch_planes_engine",
    "torch_breadth_cli": "test_torch_breadth_cli",
    "torch_slice": "test_torch_slice",
    "torch_window": "test_torch_window",
    "torch_fixed_lag_engine": "test_torch_fixed_lag_engine",
    "torch_mesh_engine": "test_torch_mesh_engine",
    "torch_tridiag": "test_torch_tridiag",
    "torch_tiled": "test_torch_tiled",
    "torch_planes": "test_torch_planes",
    "torch_soa": "test_torch_soa",
    "torch_fixed_lag": "test_torch_fixed_lag",
    "torch_lm": "test_torch_lm",
    "torch_mesh": "test_torch_mesh",
    "torch_mesh_planes": "test_torch_mesh_planes",
    "torch_mesh_window": "test_torch_mesh_window",
}
FAMILIES = {}
# "<family>=<path>": the family whose calls this process runs live and
# records to <path> (set by the regeneration script)
RECORD_ENV = "JAX_GOLDEN_RECORD"
# the largest drift the regeneration script admits, in units of a call's
# tolerance
DRIFT_BOUND = 1e-3


def regen_command(family: str) -> str:
    return f"python tests/golden/regen_jax.py {family}"


def family(name: str) -> "Recorded":
    """The family ``name``, its test module imported."""
    importlib.import_module(FAMILY_MODULES[name])
    return FAMILIES[name]


def source_hash() -> str:
    """sha256 over every file under ``semantic_slam_tpu/`` (path and bytes),
    build outputs aside."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(SOURCES):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if name.endswith(SOURCE_SKIP):
                continue
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, SOURCES).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _update(h, obj, coarse: bool) -> None:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _update(h, getattr(obj, f.name), coarse)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            h.update(repr(k).encode())
            _update(h, obj[k], coarse)
    elif isinstance(obj, (list, tuple)):
        h.update(b"[%d" % len(obj))
        for x in obj:
            _update(h, x, coarse)
    elif hasattr(obj, "__array__") and not isinstance(obj, type):  # numpy, JAX and torch arrays
        a = np.ascontiguousarray(np.asarray(obj))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        if coarse and a.dtype.kind == "f":
            # on a grid of 2^-26 of the array's scale (a power of two): the
            # last bits a machine may round otherwise, and rounding noise
            # about zero, do not change the digest
            x = np.nan_to_num(a.astype(np.float64), posinf=0.0, neginf=0.0)
            scale = 2.0 ** np.ceil(np.log2(max(float(np.abs(x).max(initial=0.0)), 1e-300)))
            a = np.stack([np.round(x / scale * 2.0 ** 26), np.isnan(a), np.where(np.isinf(a), np.sign(a), 0.0)])
            a = a.astype(np.float64) + 0.0  # -0.0 as 0.0
            h.update(repr(scale).encode())
        h.update(a.tobytes())
    elif coarse and isinstance(obj, float):
        _update(h, np.float64(obj), coarse)
    else:
        h.update(repr(obj).encode())


def digest(obj, coarse: bool = False) -> str:
    """sha256 of nested dicts, lists, dataclasses (a log), arrays and
    scalars; ``coarse`` rounds each float array to 2^-26 of its scale
    first."""
    h = hashlib.sha256()
    _update(h, obj, coarse)
    return h.hexdigest()


def read_dir(root: str, skip=()) -> dict:
    """Every file under ``root`` (but those ending in one of ``skip``) as
    bytes, by its path relative to ``root``."""
    out = {}
    for base, dirs, files in os.walk(root):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(base, name)
            rel = os.path.relpath(path, root)
            if not rel.endswith(tuple(skip)):
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def write_dir(files: dict, dest: str) -> str:
    """``read_dir``'s files written back under ``dest``; returns ``dest``."""
    for rel, blob in files.items():
        path = os.path.join(dest, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return dest


# ---------------------------------------------------------------------------
# engine snapshots
# ---------------------------------------------------------------------------

_STATES = ("graph", "table", "plane_nodes", "prior")


def engine_outputs(e, host_meta: bool = False, keep=None) -> dict:
    """A JAX engine after its session: its state tuples' arrays, keyframe
    poses and mapped landmarks (of these only those named in ``keep``, where
    given), and its host bookkeeping."""
    out = {}
    for name in _STATES:
        state = getattr(e, name, None)
        if state is not None:
            for k, v in state._asdict().items():
                out[f"{name}.{k}"] = np.asarray(v)
    out["keyframe_poses"] = e.get_keyframe_poses()
    out["robot_pose"] = np.asarray(e.robot_pose)
    out["archived_poses"] = np.asarray(e.archived_poses, np.float64).reshape(-1, 7)
    for k, v in e.get_mapped_landmarks().items():
        out[f"mapped.{k}"] = np.asarray(v)
    if keep is not None:
        out = {k: v for k, v in out.items() if k in keep}
    out["host"] = {"node_idx": [k.node_idx for k in e.keyframes], "kf_base": e._kf_base, "n_poses": e._n_poses,
                   "stats_history": e.stats_history}
    if host_meta:
        from semantic_slam_tpu.io import checkpoint as jckpt

        out["host_meta"] = json.loads(json.dumps(jckpt._engine_host_meta(e)))
    return out


class EngineSnapshot:
    """What the parity tests read of a JAX engine, from ``engine_outputs``:
    ``graph``, ``table``, ``plane_nodes`` and ``prior`` as namespaces of
    arrays (``graph.max_poses`` too), ``keyframes`` (their ``node_idx``),
    ``stats_history``, ``robot_pose``, ``archived_poses``, ``_kf_base``,
    ``_n_poses``, ``get_keyframe_poses()`` and ``get_mapped_landmarks()``."""

    @staticmethod
    def state(outputs: dict, name: str):
        """The arrays ``<name>.<field>`` of ``outputs`` as a namespace (None
        without any)."""
        fields = {k.split(".", 1)[1]: v for k, v in outputs.items() if k.startswith(name + ".")}
        return SimpleNamespace(**fields) if fields else None

    def __init__(self, outputs: dict):
        for name in _STATES:
            setattr(self, name, self.state(outputs, name))
        if hasattr(self.graph, "poses"):
            self.graph.max_poses = self.graph.poses.shape[0]
        host = outputs["host"]
        self.keyframes = [SimpleNamespace(node_idx=i) for i in host["node_idx"]]
        self.stats_history = host["stats_history"]
        self._kf_base, self._n_poses = host["kf_base"], host["n_poses"]
        self.host_meta = outputs.get("host_meta")
        self.robot_pose = outputs.get("robot_pose")
        self.archived_poses = list(outputs.get("archived_poses", ()))
        self._poses = outputs.get("keyframe_poses")
        self._mapped = {k[len("mapped."):]: v for k, v in outputs.items() if k.startswith("mapped.")}

    def get_keyframe_poses(self):
        return self._poses

    def get_mapped_landmarks(self):
        return dict(self._mapped)


# ---------------------------------------------------------------------------
# outputs as a JSON tree and its arrays
# ---------------------------------------------------------------------------


def _encode(obj, leaves: list):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"py": obj}
    if isinstance(obj, bytes):
        leaves.append(np.frombuffer(obj, np.uint8))
        return {"bytes": len(leaves) - 1}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"nt": f"{type(obj).__module__}:{type(obj).__qualname__}", "c": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, (tuple, list)):
        return {"seq": type(obj).__name__, "c": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, dict):
        return {"dict": [[k, _encode(v, leaves)] for k, v in obj.items()]}
    if hasattr(obj, "__array__"):
        leaves.append(np.asarray(obj))
        return {"leaf": len(leaves) - 1}
    raise TypeError(f"cannot store a {type(obj).__name__}")


def _decode(tree, leaves):
    if "py" in tree:
        return tree["py"]
    if "leaf" in tree:
        return leaves[tree["leaf"]]
    if "bytes" in tree:
        return leaves[tree["bytes"]].tobytes()
    if "dict" in tree:
        return {k: _decode(v, leaves) for k, v in tree["dict"]}
    children = [_decode(c, leaves) for c in tree["c"]]
    if "nt" in tree:
        module, name = tree["nt"].split(":")
        return getattr(importlib.import_module(module), name)(*children)
    return tuple(children) if tree["seq"] == "tuple" else children


# timings, not results
SKIP_KEYS = ("solve_seconds", "mean_solve_ms")
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?(?:nan|inf)", re.I)


class Drift:
    """Where two outputs of one call differ: ``faults`` (anything but a
    float: structure, integers, strings, bytes) and ``worst``, the largest
    float difference (absolute below one, relative above) in units of the
    tolerance that holds it, at ``where``. ``tol`` is a float, or a dict of
    tolerances by the end of an output's path, ``""`` for the rest."""

    def __init__(self, tol):
        self.tol = tol
        self.worst, self.max_abs, self.where, self.faults = 0.0, 0.0, None, []

    def tol_at(self, where: str) -> float:
        if isinstance(self.tol, dict):
            return next((t for end, t in self.tol.items() if end and where.endswith(end)), self.tol[""])
        return self.tol

    def floats(self, a, b, where):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            self.faults.append(f"{where}: shape {a.shape} != {b.shape}")
            return
        if not np.array_equal(np.isnan(a), np.isnan(b)) or not np.array_equal(np.isinf(a), np.isinf(b)):
            self.faults.append(f"{where}: NaN/inf pattern")
            return
        fin = np.isfinite(a)
        if not np.array_equal(a[~fin], b[~fin]):
            self.faults.append(f"{where}: inf sign")
        if fin.any():
            d = np.abs(a[fin] - b[fin])
            self.max_abs = max(self.max_abs, float(d.max()))
            scaled, tol = float(np.max(d / np.maximum(1.0, np.abs(b[fin])))), self.tol_at(where)
            units = scaled / tol if tol else (0.0 if scaled == 0 else float("inf"))
            if units > self.worst:
                self.worst, self.where = units, where

    def array(self, a, b, where):
        if a.dtype.kind == b.dtype.kind == "U" and a.ndim == b.ndim == 0 and str(a)[:1] in "{[":
            self.json(json.loads(str(a)), json.loads(str(b)), where)  # a JSON record (a checkpoint's meta)
        elif a.dtype != b.dtype or a.shape != b.shape:
            self.faults.append(f"{where}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
        elif a.dtype.kind in "fc":
            self.floats(a.real, b.real, where)
            if a.dtype.kind == "c":
                self.floats(a.imag, b.imag, where)
        elif not np.array_equal(a, b):
            self.faults.append(f"{where}: differs")

    def json(self, a, b, where):
        if isinstance(a, dict) and isinstance(b, dict):
            if sorted(a) != sorted(b):
                self.faults.append(f"{where}: keys")
                return
            for k in a:
                if k not in SKIP_KEYS:
                    self.json(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list) and isinstance(b, list):
            if len(a) != len(b):
                self.faults.append(f"{where}: length")
                return
            for i, (x, y) in enumerate(zip(a, b)):
                self.json(x, y, f"{where}[{i}]")
        elif isinstance(a, float) or isinstance(b, float):
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                self.floats(a, b, where)
            else:
                self.faults.append(f"{where}: {a!r} != {b!r}")
        elif a != b:
            self.faults.append(f"{where}: {a!r} != {b!r}")

    def text(self, a: str, b: str, where):
        if _NUM.sub("#", a) != _NUM.sub("#", b):
            self.faults.append(f"{where}: text")
            return
        for i, (x, y) in enumerate(zip(_NUM.findall(a), _NUM.findall(b))):
            if x != y:
                if re.fullmatch(r"[-+]?\d+", x) and re.fullmatch(r"[-+]?\d+", y):
                    self.faults.append(f"{where}: integer {x} != {y}")
                else:
                    self.floats(float(x), float(y), f"{where} number {i}")

    def file(self, a: bytes, b: bytes, where):
        if a == b:
            return
        if where.endswith(".npz"):
            za, zb = np.load(io.BytesIO(a)), np.load(io.BytesIO(b))
            if sorted(za.files) != sorted(zb.files):
                self.faults.append(f"{where}: members")
                return
            for k in za.files:
                self.array(za[k], zb[k], f"{where}:{k}")
        elif where.endswith(".json"):
            self.json(json.loads(a), json.loads(b), where)
        elif where.endswith(".jsonl"):
            self.json([json.loads(x) for x in a.splitlines()], [json.loads(x) for x in b.splitlines()], where)
        elif where.endswith((".txt", ".g2o")):
            self.text(a.decode(), b.decode(), where)
        else:
            self.faults.append(f"{where}: bytes differ")

    def tree(self, ta, la, tb, lb, where=""):
        """Two encoded outputs (``_encode``'s tree and leaves each)."""
        if "py" in ta and "py" in tb:
            self.json(ta["py"], tb["py"], where)
        elif "leaf" in ta and "leaf" in tb:
            self.array(np.asarray(la[ta["leaf"]]), np.asarray(lb[tb["leaf"]]), where)
        elif "bytes" in ta and "bytes" in tb:
            self.file(la[ta["bytes"]].tobytes(), lb[tb["bytes"]].tobytes(), where)
        elif "dict" in ta and "dict" in tb:
            da, db = dict(map(tuple, ta["dict"])), dict(map(tuple, tb["dict"]))
            if set(da) != set(db):
                self.faults.append(f"{where}: keys {sorted(map(repr, set(da) ^ set(db)))}")
                return
            for k in da:
                if k not in SKIP_KEYS:
                    self.tree(da[k], la, db[k], lb, f"{where}/{k}")
        elif "c" in ta and "c" in tb and (ta.get("nt"), ta.get("seq")) == (tb.get("nt"), tb.get("seq")) \
                and len(ta["c"]) == len(tb["c"]):
            for i, (x, y) in enumerate(zip(ta["c"], tb["c"])):
                self.tree(x, la, y, lb, f"{where}[{i}]")
        else:
            self.faults.append(f"{where}: structure")


# ---------------------------------------------------------------------------
# a family of stored calls
# ---------------------------------------------------------------------------


def _on_device(tree):
    """numpy arrays in ``tree`` (stored outputs handed on) as JAX arrays, for
    the JAX functions that update their inputs with ``.at``."""
    import jax

    return jax.tree.map(lambda a: jax.numpy.asarray(a) if isinstance(a, np.ndarray) else a, tree)


def _own_source(fn, seen=None) -> str:
    """The source of a function of the tests and of the module-level
    functions of its module that it names, in turn ("" for the frozen
    package's)."""
    fn = inspect.unwrap(fn)
    if fn.__module__.startswith("semantic_slam_tpu.") or not inspect.isfunction(fn):
        return ""
    seen = set() if seen is None else seen
    seen.add(fn)
    module, names, codes = inspect.getmodule(fn), set(), [fn.__code__]
    while codes:
        code = codes.pop()
        names.update(code.co_names)
        codes.extend(c for c in code.co_consts if inspect.iscode(c))
    parts = [inspect.getsource(fn)]
    for name in sorted(names):
        obj = getattr(module, name, None)
        if inspect.isfunction(obj) and obj.__module__ == fn.__module__ and obj not in seen:
            parts.append(_own_source(obj, seen))
    return "\n".join(parts)


class Recorded:
    """A test module's reference calls, stored by their inputs (the module
    docstring says how). ``tol`` is the tolerance the tests hold the
    family's outputs to; a call held to another says so with ``tol=`` (a
    float, or a dict of tolerances by the end of an output's path). The
    drift check measures each call against its own tolerance; a call that
    fails it is not stored but listed, and runs live. The regeneration
    script runs the module's tests with ``JAX_GOLDEN_RECORD`` set: each call
    then runs live and is recorded, its result handed on in the stored form,
    so that the tests see what they see from the file."""

    def __init__(self, name: str, tol: float):
        self.name, self.tol = name, tol
        self.path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        self._cache = self._meta = None
        FAMILIES[name] = self
        target = os.environ.get(RECORD_ENV, "").split("=", 1)
        self.recording = target[0] == name
        self._records, self._calls = {}, collections.Counter()
        if self.recording:
            atexit.register(self._save, target[1])

    def spec_digest(self) -> str:
        return digest({"recorded": True, "tol": self.tol})

    def fail(self, why: str):
        pytest.fail(f"the stored JAX reference {self.name} {why}; regenerate it with `{regen_command(self.name)}`",
                    pytrace=False)

    def stored(self) -> dict:
        """Every stored array, by key (read once a process)."""
        if self._cache is None:
            if not os.path.exists(self.path):
                self.fail("is missing")
            with np.load(self.path) as z:
                self._cache = {k: z[k] for k in z.files}
        return self._cache

    def meta(self) -> dict:
        if self._meta is None:
            self._meta = json.loads(str(self.stored()["__meta__"]))
        return self._meta

    def _tol(self, tol):
        if isinstance(tol, dict):
            return {"": self.tol, **tol}
        return self.tol if tol is None else tol

    def _key(self, fn, args, kwargs, context):
        name = f"{fn.__module__}.{getattr(fn, '__qualname__', getattr(fn, '__name__', ''))}"
        return name, digest([name, _own_source(fn), context, args, kwargs], coarse=True)

    def __call__(self, fn, *args, context=None, tol=None, **kwargs):
        name, key = self._key(fn, args, kwargs, context)
        if self.recording:
            leaves = []
            tree = _encode(fn(*_on_device(args), **_on_device(kwargs)), leaves)
            test = os.environ.get("PYTEST_CURRENT_TEST", "").rsplit(" (", 1)[0]
            self._calls[test] += 1
            self._records[key] = (tree, leaves, f"{test}#{self._calls[test]} {name}", self._tol(tol))
            return _decode(tree, leaves)
        stored = self.stored()
        if key in self.meta()["live"]:  # it failed the drift check
            return fn(*_on_device(args), **_on_device(kwargs))
        if f"{key}/tree" not in stored:
            self.fail(f"holds no output of {name} for these inputs")
        tree = json.loads(str(stored[f"{key}/tree"]))
        return _decode(tree, [stored[f"{key}/{i}"] for i in range(int(stored[f"{key}/leaves"]))])

    def check_live(self, fn, *args, context=None, tol=None, **kwargs) -> None:
        """Run a stored call live and hold the stored output to it at the
        call's tolerance: the file still is what the package computes."""
        stored = self(fn, *args, context=context, tol=tol, **kwargs)
        if not self.recording and self._key(fn, args, kwargs, context)[1] in self.meta()["live"]:
            self.fail("keeps this call live (it failed the drift check), so it cannot check the stored file")
        live = fn(*_on_device(args), **_on_device(kwargs))
        la, lb = [], []
        drift = Drift(self._tol(tol))
        drift.tree(_encode(stored, la), la, _encode(live, lb), lb)
        if drift.faults or drift.worst > 1.0:
            self.fail(f"differs from the package's live output ({drift.faults[:3]}; largest float difference "
                      f"{drift.worst:.3g} of the tolerance, at {drift.where!r})")

    def _save(self, path: str) -> None:
        packed = {}
        for key, (tree, leaves, label, tol) in self._records.items():
            packed[f"{key}/tree"] = np.array(json.dumps(tree))
            packed[f"{key}/label"] = np.array(label)
            packed[f"{key}/tol"] = np.array(json.dumps(tol))
            packed[f"{key}/leaves"] = np.array(len(leaves))
            packed.update({f"{key}/{i}": a for i, a in enumerate(leaves)})
        np.savez_compressed(path, **packed)
