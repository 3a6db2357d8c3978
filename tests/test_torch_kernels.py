"""The port's RANSAC scoring kernel against the JAX package's TPU kernel.

On the CPU the port's wrapper runs its plain version; it is held to the JAX
Pallas kernel (interpret mode) and the JAX reference with atol=0: counts are
integers and both sides compute the same f32 products. The CUDA kernel
itself is compared with the plain version on the card, in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.frontend import pallas_kernels as pk
from semantic_slam_tpu_torch.frontend import kernels as tk

DIST, COS = 0.5, 0.2


def make_inputs(seed, D, N, S):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(D, N, 3)).astype(np.float32)
    nrm = rng.normal(size=(D, N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    cand = rng.random((D, N)) > 0.3
    hn = rng.normal(size=(D, S, 3)).astype(np.float32)
    hn /= np.linalg.norm(hn, axis=-1, keepdims=True)
    hd = rng.normal(size=(D, S)).astype(np.float32)
    return pts, nrm, cand, hn, hd


def port_counts(inputs, device="cpu"):
    t = [torch.as_tensor(a, device=device) for a in inputs]
    return tk.score_hypotheses(*t, DIST, COS).cpu().numpy()


@pytest.mark.parametrize("N", [2048, 4133], ids=["tiled", "ragged"])
def test_plain_matches_jax_reference(N):
    inputs = make_inputs(0, 2, N, 64)
    got = port_counts(inputs)
    for d in range(2):
        ref = np.asarray(
            pk.score_hypotheses_ref(*(jnp.asarray(a[d]) for a in inputs), jnp.float32(DIST), jnp.float32(COS))
        )
        np.testing.assert_allclose(got[d], ref, atol=0)


def test_plain_matches_pallas_interpret():
    inputs = make_inputs(1, 2, 4096, 128)
    got = port_counts(inputs)
    for d in range(2):
        ref = np.asarray(
            pk.score_hypotheses_pallas(
                *(jnp.asarray(a[d]) for a in inputs), jnp.float32(DIST), jnp.float32(COS), interpret=True
            )
        )
        np.testing.assert_allclose(got[d], ref, atol=0)


def test_no_candidates_counts_zero():
    pts, nrm, _, hn, hd = make_inputs(2, 2, 2048, 32)
    got = port_counts((pts, nrm, np.zeros((2, 2048), bool), hn, hd))
    assert got.shape == (2, 32) and (got == 0).all()


def test_unsupported_device_raises():
    """Only CPU tensors take the plain version; any other device that is not
    CUDA is refused, not silently computed elsewhere."""
    t = [torch.as_tensor(a).to("meta") for a in make_inputs(4, 1, 64, 8)]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.score_hypotheses(*t, DIST, COS)
