"""The port's point-cloud filters, k-means and polygon-area estimators
(``frontend/filters.py``, ``frontend/kmeans.py``, ``frontend/hull.py``)
against the JAX package's on shared inputs, on the CPU: the counterparts of
``tests/test_filters_kmeans.py`` (its plane residual cases are
``test_torch_planes.py``'s).

Inputs are seeded numpy clouds handed to both packages. Masks, labels and
keep sets must be equal; centroids, compactness and planes within 1e-9 (f64:
summation order only); the JAX tests' own claims hold for the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.frontend import filters as jfilters
from semantic_slam_tpu.frontend import hull as jhull
from semantic_slam_tpu.frontend import kmeans as jkmeans
from semantic_slam_tpu_torch.frontend import filters as tfilters
from semantic_slam_tpu_torch.frontend import hull as thull
from semantic_slam_tpu_torch.frontend import kmeans as tkmeans

TOL = 1e-9


def t64(a):
    return torch.as_tensor(np.asarray(a))


def _cloud(seed: int, n: int = 300):
    """Two tight clusters, a wide one, a far outlier and some invalid
    points."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(size=(n // 3, 3)) * 0.002 + [0.55, 0.55, 0.55],
                          rng.normal(size=(n // 3, 3)) * 0.05 + [1.29, 1.29, 1.29],
                          rng.uniform(-2, 2, size=(n - 2 * (n // 3) - 1, 3)), [[5.0, 5.0, 5.0]]])
    valid = rng.uniform(size=n) > 0.1
    return pts, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_range_filter(seed):
    pts, valid = _cloud(seed)
    want = np.asarray(jfilters.range_filter(jnp.asarray(pts), jnp.asarray(valid), 0.3, 3.0))
    np.testing.assert_array_equal(tfilters.range_filter(t64(pts), t64(valid), 0.3, 3.0).numpy(), want)
    np.testing.assert_array_equal(
        tfilters.range_filter(t64([[0.1, 0, 0], [1.0, 0, 0], [5.0, 0, 0]]), torch.ones(3, dtype=torch.bool)).numpy(),
        [False, True, False])


@pytest.mark.parametrize("leaf", [0.1, 0.25])
def test_voxel_downsample(leaf):
    pts, valid = _cloud(2)
    jc, jk = jfilters.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), leaf=leaf)
    tc, tk = tfilters.voxel_downsample(t64(pts), t64(valid), leaf=leaf)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tc.numpy()[tk.numpy()], np.asarray(jc)[np.asarray(jk)], atol=TOL, rtol=0)


def test_voxel_downsample_merges_cluster():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(10, 3)) * 0.002 + [0.55, 0.55, 0.55]
    b = rng.normal(size=(5, 3)) * 0.002 + [1.29, 1.29, 1.29]
    cent, keep = tfilters.voxel_downsample(t64(np.concatenate([a, b])), torch.ones(15, dtype=torch.bool), leaf=0.1)
    assert int(keep.sum()) == 2
    kept = cent.numpy()[keep.numpy()]
    got = kept[np.argsort(kept[:, 0])]
    np.testing.assert_allclose(got[0], a.mean(0), atol=1e-6)
    np.testing.assert_allclose(got[1], b.mean(0), atol=1e-6)


@pytest.mark.parametrize("mean_k,stddev", [(10, 1.0), (50, 0.5)])
def test_statistical_outlier_removal(mean_k, stddev):
    pts, valid = _cloud(3)
    want = np.asarray(jfilters.statistical_outlier_removal(jnp.asarray(pts), jnp.asarray(valid), mean_k=mean_k,
                                                           stddev_mul=stddev))
    got = tfilters.statistical_outlier_removal(t64(pts), t64(valid), mean_k=mean_k, stddev_mul=stddev).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[-1] and got.sum() > 0


@pytest.mark.parametrize("k,iters", [(2, 10), (3, 5)])
def test_kmeans(k, iters):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(size=(100, 2)) * 0.1, rng.normal(size=(100, 2)) * 0.1 + [5, 5],
                        rng.normal(size=(50, 2)) * 0.3 + [0, 5]])
    valid = rng.uniform(size=len(x)) > 0.05
    jc, jl, jcomp = jkmeans.kmeans(jnp.asarray(x), jnp.asarray(valid), k=k, iters=iters)
    tc, tl, tcomp = tkmeans.kmeans(t64(x), t64(valid), k=k, iters=iters)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(tcomp), float(jcomp), rtol=TOL)


def test_kmeans_recovers_clusters():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(100, 2)) * 0.1, rng.normal(size=(100, 2)) * 0.1 + [5, 5]])
    c, labels, _ = tkmeans.kmeans(t64(x), torch.ones(200, dtype=torch.bool), k=2)
    c = c.numpy()[np.argsort(c.numpy()[:, 0])]
    np.testing.assert_allclose(c[0], [0, 0], atol=0.1)
    np.testing.assert_allclose(c[1], [5, 5], atol=0.1)
    lab = labels.numpy()
    assert (lab[:100] == lab[0]).all() and (lab[100:] == lab[100]).all()


def test_legacy_cluster_planes():
    """A floor (cam normal (0, -1, 0), d = 0.5) and a wall, through both
    packages' legacy pipeline."""
    rng = np.random.default_rng(0)
    n = 2048
    pts = rng.uniform(-1, 1, size=(n, 3))
    pts[: n // 2, 1] = 0.5
    pts[n // 2:, 2] = 2.0
    nrm = np.concatenate([np.tile([0.0, -1.0, 0.0], (n // 2, 1)), np.tile([0.0, 0.0, -1.0], (n // 2, 1))])
    nrm = nrm + rng.normal(size=(n, 3)) * 0.01
    valid = rng.uniform(size=n) > 0.02
    h_cam = np.array([0.0, -1.0, 0.0])
    jp, jc, jv = jkmeans.legacy_cluster_planes(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(valid),
                                               jnp.asarray(h_cam), min_points=200)
    tp, tc, tv = tkmeans.legacy_cluster_planes(t64(pts), t64(nrm), t64(valid), t64(h_cam), min_points=200)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    v = tv.numpy()
    assert v.any()
    p = tp.numpy()[v][0]
    np.testing.assert_allclose(p[:3], [0.0, -1.0, 0.0], atol=0.05)
    np.testing.assert_allclose(abs(p[3]), 0.5, atol=0.05)


def _region(kind: str, rng):
    if kind == "square":  # uniform 2 x 1 in the z = 0.5 plane
        pts = np.stack([rng.uniform(-1, 1, 4096), rng.uniform(-0.5, 0.5, 4096), np.full(4096, 0.5)], axis=-1)
        return pts, np.ones(4096, bool), 2.0
    if kind == "disk":
        r, th = np.sqrt(rng.uniform(0, 1, 4096)), rng.uniform(0, 2 * np.pi, 4096)
        return np.stack([r * np.cos(th), r * np.sin(th), np.full(4096, 2.0)], axis=-1), np.ones(4096, bool), np.pi
    pts = np.stack([rng.uniform(-1, 1, 1024), rng.uniform(-1, 1, 1024), np.zeros(1024)], axis=-1)
    return pts, np.abs(pts[:, 0]) < 0.2, 0.8  # a thin strip (~0.8) of the 4.0 square


# the JAX tests' claims: the binned boundary under-estimates
AREA_BOUNDS = {"square": (1.6, 2.1), "disk": (np.pi - 0.3, np.pi + 0.3), "strip": (0.0, 1.0)}


@pytest.mark.parametrize("kind", ["square", "disk", "strip"])
def test_polygon_area(kind):
    pts, mask, area = _region(kind, np.random.default_rng(0))
    n = np.array([0.0, 0.0, 1.0])
    want = float(jhull.polygon_area(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(n)))
    got = float(thull.polygon_area(t64(pts), t64(mask), t64(n)))
    np.testing.assert_allclose(got, want, rtol=TOL)
    lo, hi = AREA_BOUNDS[kind]
    assert lo < got < hi and got <= area * 1.05
    evals = np.array([0.0, 1.0 / 12.0, 4.0 / 12.0])  # a uniform 1 x 2 rectangle
    np.testing.assert_allclose(float(thull.pca_area(t64(evals))), float(jhull.pca_area(jnp.asarray(evals))),
                               rtol=TOL)
    np.testing.assert_allclose(float(thull.pca_area(t64(evals))), 2.0, rtol=1e-12)
