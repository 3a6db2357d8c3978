"""Inputs shared by the port's tests (no JAX here: ``test_torch_cuda.py``
imports this module on the machine with the card, which has none).
``chip_smoke.py`` keeps its own copy of ``moved_prior``, since it runs
alone."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one thread for a module's tests, restored after it.
    The tests' tensors are small, and a test run shares the cores among
    several workers, each running JAX's thread pools beside torch's: there
    torch's default, a thread per core, spends its time waiting for cores.
    In a 6-worker run (``-n 6 --dist loadfile``) of ``test_torch_golden.py``,
    ``test_torch_io.py``, ``test_torch_lifecycle.py``, ``test_torch_tiled.py``,
    ``test_torch_fixed_lag.py`` and ``test_torch_fixed_lag_engine.py`` on an
    8-core CPU, the six files' test time fell from 1376 s to 636 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moved_prior(prior, poses: torch.Tensor, num_live: int, seed: int = 5):
    """``prior`` with its boundary block replaced by a dense seeded SPD block
    over the free poses (3, num_live // 2, num_live - 2), slots 0-2, at the
    scale of the marginalized boundary block (the mean of its slot-0
    diagonal); ``p_ref`` there is ``poses``. On the engine's chain graphs
    the boundary is the window's first pose, which the gauge fixes, so a
    marginalized prior's Hp meets only masked directions in the matvec;
    this one exercises the branch's arithmetic and moves the step at its
    poses by about its own size."""
    idx = (3, num_live // 2, num_live - 2)
    n, dt, dev = len(idx), prior.Hp.dtype, prior.Hp.device
    scale = prior.Hp[:6, :6].diagonal().mean()
    A = torch.as_tensor(np.random.default_rng(seed).normal(size=(6 * n, 6 * n)), dtype=dt, device=dev)
    Hp = torch.zeros_like(prior.Hp)
    Hp[: 6 * n, : 6 * n] = scale * (A @ A.T / (6 * n) + torch.eye(6 * n, dtype=dt, device=dev))
    p_idx = torch.zeros_like(prior.p_idx)
    p_idx[:n] = torch.tensor(idx, dtype=p_idx.dtype, device=dev)
    p_ref = prior.p_ref.clone()
    p_ref[:n] = poses[p_idx[:n].long()]
    return prior._replace(Hp=Hp, p_idx=p_idx, p_ref=p_ref, num_p=torch.tensor(n, dtype=prior.num_p.dtype, device=dev))


def row_err(got: torch.Tensor, want: torch.Tensor, without: torch.Tensor, p_idx: torch.Tensor, n: int):
    """At the prior's poses ``p_idx[:n]``: (|got - want|, |without - want|),
    Frobenius norms: a kernel's error there beside the prior block's own
    effect on the step."""
    rows = p_idx[:n].long()
    return (float(torch.linalg.norm((got[rows] - want[rows]).double())),
            float(torch.linalg.norm((without[rows] - want[rows]).double())))


class MeshCache:
    """One open mesh of gloo CPU ranks for a test module (a process holds
    one mesh at a time, so a module's tests run grouped by rank count):
    ``get(n)`` reopens it at another size, ``close()`` ends it."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self.mesh = None

    def get(self, n: int):
        from semantic_slam_tpu_torch.parallel import dist

        if self.mesh is not None and not self.mesh.closed and self.mesh.size == n:
            return self.mesh
        self.close()
        self.mesh = dist.make_mesh(n, device="cpu", timeout_s=self.timeout_s)
        return self.mesh

    def close(self) -> None:
        if self.mesh is not None:
            self.mesh.close()
            self.mesh = None


def port_graph(g):
    """A JAX package ``GraphState`` as the port's (CPU tensors)."""
    from semantic_slam_tpu_torch.graph import state as tgs

    return tgs.graph_from_numpy({k: np.asarray(v) for k, v in g._asdict().items()})


def close_to(got, want, atol: float, msg: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=atol, rtol=0,
                               err_msg=msg)


def collectives(mesh, run) -> list:
    """The (kind, element count) of each collective that ``run()`` sends on
    ``mesh``, in order."""
    mesh.recording, mesh.log = True, []
    try:
        run()
    finally:
        mesh.recording = False
    return [(kind, n) for kind, n, _ in mesh.log]
