"""The port's device mesh on ``torch.distributed`` (counterpart of a
``jax.sharding.Mesh`` and of ``semantic_slam_tpu.parallel.sharded.make_mesh``).

One controller, n - 1 workers. The caller's process is rank 0 and keeps the
engine, as JAX's single controller does; ``make_mesh`` starts n - 1 worker
processes (``python -c`` of ``_worker_main`` below, so that a worker imports
this package and torch and nothing of its parent's ``__main__``). Rendezvous
is a ``FileStore`` in a temporary directory, and each worker keeps a
connection to the controller over a Unix socket in the same directory: no TCP
port is taken for either. A sharded call on rank 0 (``Mesh.run``) sends the
workers the operation and its statics over that connection, then broadcasts
the tensors (one flat buffer per dtype); every rank runs the same function
on them, each on its own share (its pose rows, edge shard or window rows),
with the collectives of ``Mesh``. Rank 0's result is the call's; each worker
reports done or its error back on its connection.

Why not SPMD, every rank running the whole engine: the ranks' replay,
frontend and association would have to stay bit-identical across processes,
and neither ``index_add_`` nor the kernels' atomics promise that on the
card. Every host decision inside a sharded loop comes from one source
(``Mesh.agree``: rank 0's flags, broadcast), so the ranks cannot take
different branches.

Backends are the caller's choice and are never swapped behind its back: on
the card NCCL with one GPU per rank (``cuda:rank``; fewer visible GPUs than
ranks is a ``ValueError``), with ``device="cpu"`` gloo on CPU ranks (the
counterpart of ``--xla_force_host_platform_device_count``), and with an
explicit ``backend="gloo"`` and ``devices=[...]`` several ranks may share one
card (gloo stages CUDA tensors through the host). Nothing falls back from
one to another.

Failure: the process group has a ``timeout``; a worker that raises reports
its traceback and exits, and rank 0 raises a ``RuntimeError`` naming the
rank, within the timeout. A worker that dies is found the same way (its
collectives fail, or its connection closes). A failed mesh is closed: its
workers are stopped and later calls raise.

The kernels are built by the controller before any worker starts, so the
workers only load the libraries (``semantic_slam_tpu_torch/_build.py``).
"""

from __future__ import annotations

import atexit
import datetime
import importlib
import os
import pickle
import secrets
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Client, Connection, Listener
from typing import Callable, Sequence

import torch

Tensor = torch.Tensor

DEFAULT_TIMEOUT_S = 300.0
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_FORBIDDEN = ("jax", "jaxlib", "semantic_slam_tpu", "__graft_entry__")
_open_mesh: "Mesh | None" = None


@atexit.register
def _close_open_mesh() -> None:
    """A mesh still open at interpreter exit stops its workers."""
    if _open_mesh is not None:
        _open_mesh.close(force=True)


def _forbidden_loaded() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN)


class Mesh:
    """A handle on n ranks: ``size``, ``rank``, ``devices`` (one a rank),
    ``device`` (this rank's), the collectives and, on rank 0, ``run`` and
    ``close``. ``log`` records each collective as (kind, elements, bytes)
    while ``recording`` is set (the tests' and ``chip_smoke.py``'s count)."""

    def __init__(self, size: int, rank: int, devices: Sequence[torch.device], backend: str,
                 timeout_s: float, _procs=None, _conns=None, _tmp: str | None = None):
        self.size, self.rank, self.backend = size, rank, backend
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[rank]
        self.timeout_s = timeout_s
        self._procs = {} if _procs is None else _procs
        self._conns = {} if _conns is None else _conns
        self._tmp = _tmp
        self.closed = False
        self.recording = False
        self.log: list[tuple[str, int, int]] = []

    def __repr__(self) -> str:
        return f"Mesh(size={self.size}, backend={self.backend!r}, devices={[str(d) for d in self.devices]})"

    # -- collectives ------------------------------------------------------

    def _note(self, kind: str, t: Tensor) -> None:
        if self.recording:
            self.log.append((kind, t.numel(), t.numel() * t.element_size()))

    def allreduce(self, x):
        """The sum over all ranks of a tensor, or of each tensor of a tuple,
        as ONE collective (a tuple goes through one flat buffer in the
        widest of its dtypes, as JAX's ``psum`` of a tuple is one fused
        reduction)."""
        import torch.distributed as dist

        if isinstance(x, Tensor):
            buf = x.contiguous().clone()
            self._note("all_reduce", buf)
            dist.all_reduce(buf)
            return buf
        xs = tuple(x)
        dt = xs[0].dtype
        for t in xs[1:]:
            dt = torch.promote_types(dt, t.dtype)
        buf = torch.cat([t.reshape(-1).to(dt) for t in xs])
        self._note("all_reduce", buf)
        dist.all_reduce(buf)
        out, i = [], 0
        for t in xs:
            out.append(buf[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return tuple(out)

    def agree(self, t: Tensor) -> Tensor:
        """Rank 0's ``t`` on every rank (a broadcast): the one source of a
        host decision that every rank must take alike."""
        import torch.distributed as dist

        buf = t.contiguous().clone()
        if buf.dtype == torch.bool:
            buf = buf.to(torch.uint8)
        self._note("broadcast", buf)
        dist.broadcast(buf, src=0)
        return buf.to(t.dtype)

    def all_gather(self, t: Tensor) -> list[Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        import torch.distributed as dist

        buf = t.contiguous()
        out = [torch.empty_like(buf) for _ in range(self.size)]
        self._note("all_gather", buf)
        dist.all_gather(out, buf)
        return out

    def _bcast_payload(self, spec: list, payload: dict | None) -> dict:
        """Rank 0's ``payload`` (name -> tensor or None) on every rank's
        device: one broadcast per dtype of one flat buffer."""
        import torch.distributed as dist

        by_dtype: dict[str, list] = {}
        for name, shape, dtype in spec:
            if shape is not None:
                by_dtype.setdefault(dtype, []).append((name, shape))
        out = {name: None for name, _, _ in spec}
        for dtype, items in by_dtype.items():
            dt = getattr(torch, dtype)
            wire = torch.uint8 if dt == torch.bool else dt
            n = sum(int(torch.Size(s).numel()) for _, s in items)
            if self.rank == 0:
                buf = torch.cat([payload[name].reshape(-1).to(device=self.device, dtype=wire) for name, _ in items])
            else:
                buf = torch.empty(n, dtype=wire, device=self.device)
            if self.size > 1:
                dist.broadcast(buf, src=0)
            i = 0
            for name, shape in items:
                m = int(torch.Size(shape).numel())
                out[name] = buf[i:i + m].reshape(shape).to(dt)
                i += m
        return out

    # -- the controller's side ------------------------------------------------

    def run(self, fn: Callable, payload: dict, gather: bool = False, **statics):
        """``fn(mesh, payload, **statics)`` on every rank, rank 0's result
        returned (with ``gather=True`` every rank's, in rank order, the
        workers' moved to the CPU and sent back on their connections: the
        tests' view of the ranks). ``fn`` is a module-level function of this
        package; ``payload`` maps names to tensors (or None), which every
        rank receives on its own device; ``statics`` are plain Python
        values."""
        if self.rank != 0:
            raise RuntimeError("Mesh.run is the controller's (rank 0)")
        self._check_open()
        mod, name = fn.__module__, fn.__qualname__
        if not mod.startswith("semantic_slam_tpu_torch.") or "." in name:
            raise ValueError(f"Mesh.run takes a module-level function of semantic_slam_tpu_torch, not {mod}.{name}")
        spec = [(k, None, None) if v is None else (k, tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in payload.items()]
        try:
            for r, conn in self._conns.items():
                conn.send(("run", mod, name, spec, statics, gather))
            local = self._bcast_payload(spec, payload)
            out = fn(self, local, **statics)
            others = self._wait_done()
        except BaseException as e:
            failed = self._worker_errors(wait_s=min(10.0, self.timeout_s))
            self.close(force=True)
            if failed:
                r, msg = failed[0]
                raise RuntimeError(f"mesh rank {r} failed:\n{msg}") from e
            raise
        return [out] + others if gather else out

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("the mesh is closed")
        for r, p in self._procs.items():
            code = p.poll()
            if code is not None:
                self.close(force=True)
                raise RuntimeError(f"mesh rank {r} has exited (code {code})")

    def _wait_done(self) -> list:
        """Each worker's report on the call, within the timeout: the
        results they sent (``gather``), in rank order."""
        deadline = time.monotonic() + self.timeout_s
        results = []
        for r in sorted(self._conns):
            conn = self._conns[r]
            while not conn.poll(0.05):
                if self._procs[r].poll() is not None or time.monotonic() > deadline:
                    raise RuntimeError(f"mesh rank {r} did not finish the call")
            msg = conn.recv()
            if msg[0] != "ok":
                raise RuntimeError(f"mesh rank {r} failed:\n{msg[1]}")
            results.append(None if msg[1] is None else pickle.loads(msg[1]))
        return results

    def _worker_errors(self, wait_s: float) -> list[tuple[int, str]]:
        """The (rank, message) of each worker that reported an error or
        exited, waiting up to ``wait_s`` for one of them."""
        deadline = time.monotonic() + wait_s
        while True:
            found = []
            for r, conn in self._conns.items():
                try:
                    if conn.poll(0):
                        msg = conn.recv()
                        if msg[0] == "error":
                            found.append((r, msg[1]))
                            continue
                except (EOFError, OSError):
                    pass
                code = self._procs[r].poll()
                if code is not None:
                    found.append((r, f"the process exited with code {code}"))
            if found or time.monotonic() > deadline:
                return found
            time.sleep(0.05)

    def forbidden_modules(self) -> list[list[str]]:
        """Each rank's loaded modules of JAX or of the JAX package (the
        isolation check of the tests and ``chip_smoke.py``)."""
        return self.run(_op_forbidden_modules, {})

    def close(self, force: bool = False) -> None:
        """Stop the workers (within the timeout; killed past it) and tear
        down the process group. Idempotent."""
        global _open_mesh
        if self.closed or self.rank != 0:
            return
        self.closed = True
        import torch.distributed as dist

        for conn in self._conns.values():
            try:
                conn.send(("close",))
            except OSError:
                pass
        deadline = time.monotonic() + (1.0 if force else min(30.0, self.timeout_s))
        for p in self._procs.values():
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for conn in self._conns.values():
            conn.close()
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # a group whose peers died may not tear down cleanly; it is gone either way
                pass
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
        if _open_mesh is self:
            _open_mesh = None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _to_cpu(obj):
    """``obj`` (tensors in tuples, lists, dicts, NamedTuples and
    dataclasses) with every tensor moved to the CPU, to be pickled."""
    import dataclasses

    if isinstance(obj, Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_cpu(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _field_names(cls) -> tuple[str, ...]:
    import dataclasses

    return tuple(f.name for f in dataclasses.fields(cls)) if dataclasses.is_dataclass(cls) else cls._fields


def pack(prefix: str, obj) -> dict:
    """A payload of ``Mesh.run`` from a state (a dataclass or NamedTuple of
    tensors, e.g. ``GraphState``, ``PlaneNodes``, ``MarginalPrior``), its
    fields named ``prefix.field``; ``None`` packs to nothing."""
    if obj is None:
        return {}
    return {f"{prefix}.{k}": getattr(obj, k) for k in _field_names(type(obj))}


def unpack(cls, prefix: str, payload: dict):
    """The ``cls`` packed under ``prefix`` (``pack``), or None if absent."""
    names = _field_names(cls)
    if f"{prefix}.{names[0]}" not in payload:
        return None
    return cls(**{k: payload[f"{prefix}.{k}"] for k in names})


def _op_forbidden_modules(mesh: Mesh, payload: dict) -> list[list[str]]:
    import json

    mine = json.dumps(_forbidden_loaded()).encode()
    n = torch.tensor([len(mine)], dtype=torch.int64, device=mesh.device)
    width = int(max(t.item() for t in mesh.all_gather(n)))
    buf = torch.zeros(width, dtype=torch.uint8, device=mesh.device)
    buf[:len(mine)] = torch.tensor(list(mine), dtype=torch.uint8)
    return [json.loads(bytes(t.cpu().tolist()).rstrip(b"\0").decode()) for t in mesh.all_gather(buf)]


def mesh_devices(n: int, device: str = "cuda", backend: str | None = None,
                 devices: Sequence[str] | None = None) -> tuple[list[torch.device], str]:
    """The ranks' devices and the backend of a mesh of ``n`` ranks (see
    ``make_mesh``); raises ``ValueError`` for a combination that is not
    offered."""
    if n < 1:
        raise ValueError(f"a mesh needs at least 1 rank, got {n}")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"make_mesh: {n} ranks but {len(devs)} devices")
    elif torch.device(device).type == "cpu":
        have = os.cpu_count() or 1
        if have < n:
            raise ValueError(f"a mesh of num_devices={n} CPU ranks needs {n} cores, one a rank, but this host "
                             f"has {have}")
        devs = [torch.device("cpu")] * n
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"a mesh of num_devices={n} ranks needs {n} GPUs, one a rank, but torch sees {have}; "
                             f"several ranks share a card only with backend='gloo' and explicit devices")
        devs = [torch.device("cuda", r) for r in range(n)]
    kinds = {d.type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"make_mesh: the ranks' devices mix {sorted(kinds)}")
    kind = kinds.pop()
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend == "nccl" and (kind != "cuda" or len(set(devs)) != n):
        raise ValueError("make_mesh: NCCL takes one GPU per rank")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} is not offered (nccl, gloo)")
    return devs, backend


def make_mesh(n: int, device: str = "cuda", backend: str | None = None, devices: Sequence[str] | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh of ``n`` ranks: this process is rank 0, and n - 1 workers are
    started. ``device="cuda"`` (default): NCCL over ``cuda:0..n-1``;
    ``device="cpu"``: gloo on CPU ranks; ``backend="gloo"`` with
    ``devices=["cuda:0", ...]``: gloo ranks on the given cards (several may
    share one). ``timeout_s`` bounds each collective and the workers'
    start, report and exit. One mesh is open at a time in a process (it is
    the default process group); ``close()`` it when done."""
    global _open_mesh
    import torch.distributed as dist

    devs, backend = mesh_devices(n, device, backend, devices)
    if _open_mesh is not None and not _open_mesh.closed:
        raise RuntimeError(f"a mesh is already open in this process: {_open_mesh}")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed already has a default process group")
    if devs[0].type == "cuda":
        from semantic_slam_tpu_torch import _build

        _build.build()  # the workers only load the libraries
    tmp = tempfile.mkdtemp(prefix="slam_mesh_")
    store_path = os.path.join(tmp, "store")
    key = secrets.token_bytes(16)
    listener = Listener(os.path.join(tmp, "ctl.sock"), family="AF_UNIX", authkey=key)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_PKG_ROOT, env.get("PYTHONPATH", "")) if p)
    env["OMP_NUM_THREADS"] = "1"
    procs: dict[int, subprocess.Popen] = {}
    conns: dict[int, Connection] = {}
    mesh = Mesh(n, 0, devs, backend, timeout_s, procs, conns, tmp)
    try:
        for r in range(1, n):
            args = [str(r), str(n), listener.address, key.hex(), store_path, backend, ",".join(map(str, devs)),
                    repr(timeout_s)]
            procs[r] = subprocess.Popen(
                [sys.executable, "-c", "import sys; from semantic_slam_tpu_torch.parallel.dist import _worker_main; "
                 "_worker_main(sys.argv[1:])", *args], env=env, cwd=tmp)
        _accept(listener, procs, conns, timeout_s)
        if devs[0].type == "cuda":
            torch.cuda.set_device(devs[0])
        dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=0, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        for r, conn in conns.items():
            if not conn.poll(timeout_s) or conn.recv()[0] != "ready":
                raise RuntimeError(f"mesh rank {r} did not join the process group")
    except BaseException:
        mesh.close(force=True)
        listener.close()
        raise
    listener.close()
    _open_mesh = mesh
    return mesh


def _accept(listener: Listener, procs: dict, conns: dict, timeout_s: float) -> None:
    """Each worker's connection (it sends its rank first), within the
    timeout; a worker that exits before it connects is an error naming it."""
    got: list = []
    errors: list = []

    def accept_all():
        try:
            for _ in procs:
                c = listener.accept()
                got.append((c.recv()[1], c))
        except BaseException as e:  # the listener closed under it
            errors.append(e)

    t = threading.Thread(target=accept_all, daemon=True)
    t.start()
    deadline = time.monotonic() + timeout_s
    while t.is_alive():
        t.join(0.05)
        for r, p in procs.items():
            if p.poll() is not None and r not in dict(got):
                raise RuntimeError(f"mesh rank {r} exited (code {p.returncode}) before it connected")
        if time.monotonic() > deadline:
            raise RuntimeError(f"mesh workers did not connect within {timeout_s} s")
    if errors:
        raise RuntimeError(f"mesh workers did not connect: {errors[0]}")
    conns.update(got)


def _worker_main(argv: list[str]) -> None:
    """A worker rank: connect, join the process group, then run the
    controller's calls until it closes the connection or sends close."""
    import torch.distributed as dist

    rank, n, address, key, store_path, backend, devices, timeout_s = argv
    rank, n, timeout_s = int(rank), int(n), float(timeout_s)
    devs = [torch.device(d) for d in devices.split(",")]
    torch.set_num_threads(1)
    import semantic_slam_tpu_torch  # noqa: F401  (the package's torch settings)

    conn = Client(address, family="AF_UNIX", authkey=bytes.fromhex(key))
    conn.send(("hello", rank))
    if devs[rank].type == "cuda":
        torch.cuda.set_device(devs[rank])
    dist.init_process_group(backend, store=dist.FileStore(store_path, n), rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = Mesh(n, rank, devs, backend, timeout_s)
    conn.send(("ready",))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):  # the controller is gone
            os._exit(0)
        if msg[0] == "close":
            break
        try:
            _, mod, name, spec, statics, gather = msg
            payload = mesh._bcast_payload(spec, None)
            out = getattr(importlib.import_module(mod), name)(mesh, payload, **statics)
            # plain pickle: a connection's own pickler would share the
            # tensors' memory with the controller, which is not our parent
            conn.send(("ok", pickle.dumps(_to_cpu(out)) if gather else None))
        except BaseException:
            print(f"mesh rank {rank}:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
            try:
                conn.send(("error", traceback.format_exc()))
            finally:
                # its collectives are out of step now: leave, so that the
                # peers' pending ones fail instead of waiting
                os._exit(1)
    dist.destroy_process_group()
    conn.close()
