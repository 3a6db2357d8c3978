"""The port's voxel map (``semantic_slam_tpu_torch/mapping/voxel.py``)
against the JAX package's ``semantic_slam_tpu.mapping.voxel``, in f64 on the
CPU, on the same numpy inputs: the dense grid's endpoint hits and carved
misses (``samples=64``), the keyframe inserts with and without carving, the
masks, log-odds and occupied centers; and ``ChunkedVoxelMap`` over several
chunk shapes, with beams that cross chunks, a chunk only carving touches,
clouds without a valid point and the ``max_chunks_per_insert`` guard.

Equal: every hit and miss count and the chunk keys; occupied centers within
1e-12. World points are drawn off the voxel faces (a point within an ulp of
a face may land in either neighbour, ``tests/test_components.py``). Invalid
pixels hold NaN, which the port masks before ``floor``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_tpu.mapping import voxel as jvox
from semantic_slam_tpu_torch.mapping import voxel as tvox
from torch_cases import one_torch_thread  # noqa: F401 (a module fixture)

TOL = 1e-12
DIMS = (32, 24, 16)
ORIGIN = (-1.2, -0.9, -0.3)
RES = 0.1
CLOUD = (6, 8)  # every organized cloud here, so each JAX program compiles once


def t64(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def assert_grid_equal(tg, jg):
    np.testing.assert_array_equal(tg.hits.numpy(), np.asarray(jg.hits))
    np.testing.assert_array_equal(tg.misses.numpy(), np.asarray(jg.misses))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))


def off_face_points(rng, n, dims=DIMS, origin=ORIGIN, res=RES, margin=4):
    """World points in voxels up to ``margin`` outside the grid, each at
    least 0.1 voxel off every face."""
    idx = rng.integers(-margin, np.asarray(dims) + margin, size=(n, 3))
    return np.asarray(origin) + (idx + rng.uniform(0.1, 0.9, size=(n, 3))) * res


def cloud(rng, depth=(0.4, 3.5), nan_share=0.2):
    """An organized camera-frame cloud of CLOUD pixels (z forward), NaN at
    the invalid ones."""
    H, W = CLOUD
    z = rng.uniform(*depth, size=(H, W))
    pts = np.stack([rng.uniform(-0.6, 0.6, (H, W)) * z, rng.uniform(-0.4, 0.4, (H, W)) * z, z], -1)
    valid = rng.uniform(size=(H, W)) > nan_share
    pts[~valid] = np.nan
    return pts, valid


@pytest.fixture(scope="module")
def grids():
    return tvox.make_grid(DIMS, ORIGIN, RES, torch.float64), jvox.make_grid(DIMS, ORIGIN, RES, jnp.float64)


def test_insert_and_carve_equal_jax(grids):
    rng = np.random.default_rng(0)
    tg, jg = grids
    pts = off_face_points(rng, 400)
    valid = rng.uniform(size=400) > 0.2
    pts[~valid] = np.nan
    tg = tvox.insert_world_points(tg, t64(pts), t64(valid, torch.bool))
    jg = jvox.insert_world_points(jg, jnp.asarray(pts), jnp.asarray(valid))
    assert_grid_equal(tg, jg)
    inside = np.all((pts - ORIGIN) / RES >= 0, -1) & np.all((pts - ORIGIN) / RES < DIMS, -1) & valid
    assert int(tg.hits.sum()) == int(inside.sum()) > 100

    origin_w = np.asarray(ORIGIN) + (np.asarray(DIMS) // 2 + 0.37) * RES
    tg = tvox.carve_free_space(tg, t64(origin_w), t64(pts), t64(valid, torch.bool), samples=64)
    jg = jvox.carve_free_space(jg, jnp.asarray(origin_w), jnp.asarray(pts), jnp.asarray(valid), samples=64)
    assert_grid_equal(tg, jg)
    assert int(tg.misses.sum()) > 1000

    for t_mask, j_mask in ((tvox.occupied_mask(tg, 1), jvox.occupied_mask(jg, 1)),
                           (tvox.occupied_mask_probabilistic(tg), jvox.occupied_mask_probabilistic(jg))):
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(tvox.occupancy_log_odds(tg).numpy(), np.asarray(jvox.occupancy_log_odds(jg)),
                               rtol=1e-6)
    tc, jc = tvox.occupied_centers(tg, 1), jvox.occupied_centers(jg, 1)
    assert tc.shape == jc.shape and len(tc) > 50
    np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)


def test_carve_blocks_do_not_change_counts(grids, monkeypatch):
    """The beams carved in blocks of a few samples count what one block does."""
    rng = np.random.default_rng(1)
    tg, _ = grids
    pts, valid = t64(off_face_points(rng, 50)), torch.ones(50, dtype=torch.bool)
    o = t64(np.asarray(ORIGIN) + 0.53)
    whole = tvox.carve_free_space(tg, o, pts, valid, samples=64)
    monkeypatch.setattr(tvox, "CARVE_BLOCK_SAMPLES", 3 * 64)
    assert torch.equal(tvox.carve_free_space(tg, o, pts, valid, samples=64).misses, whole.misses)
    assert int(whole.misses.sum()) > 0


@pytest.mark.parametrize("carving", [False, True])
def test_keyframe_inserts_equal_jax(grids, carving):
    rng = np.random.default_rng(2)
    tg, jg = grids
    for k in range(3):
        pts, valid = cloud(rng)
        pose = np.r_[rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.3, 0.3, 3)]
        cam = 0.1 * k
        if carving:
            tg = tvox.insert_keyframe_cloud_carving(tg, t64(pts), t64(valid, torch.bool), t64(pose), t64(cam),
                                                    samples=64)
            jg = jvox.insert_keyframe_cloud_carving(jg, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose),
                                                    jnp.float64(cam), samples=64)
        else:
            tg = tvox.insert_keyframe_cloud(tg, t64(pts), t64(valid, torch.bool), t64(pose), t64(cam))
            jg = jvox.insert_keyframe_cloud(jg, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose),
                                            jnp.float64(cam))
    assert_grid_equal(tg, jg)
    assert int(tg.hits.sum()) > 40 and (int(tg.misses.sum()) > 0) == carving
    np.testing.assert_allclose(tvox.occupied_centers(tg, 1), jvox.occupied_centers(jg, 1), rtol=0, atol=TOL)


def _chunked_pair(chunk_dims, carve, **kw):
    return (tvox.ChunkedVoxelMap(chunk_dims=chunk_dims, resolution=RES, carve=carve, samples=64,
                                 dtype=torch.float64, **kw),
            jvox.ChunkedVoxelMap(chunk_dims=chunk_dims, resolution=RES, carve=carve, samples=64,
                                 dtype=jnp.float64, **kw))


def assert_chunked_equal(tm, jm):
    assert list(tm.chunks) == list(jm.chunks)
    for cc in jm.chunks:
        assert_grid_equal(tm.chunks[cc], jm.chunks[cc])
    assert tm.total_hits() == jm.total_hits()
    for min_hits in (1, 2):
        tc, jc = tm.occupied_centers(min_hits), jm.occupied_centers(min_hits)
        assert tc.shape == jc.shape
        np.testing.assert_allclose(tc, jc, rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk_dims", [(16, 16, 16), (32, 16, 8), (64, 32, 32)])
@pytest.mark.parametrize("carve", [False, True])
def test_chunked_map_equals_jax(chunk_dims, carve):
    """A march of keyframes across chunk boundaries: the same chunks, counts
    and centers; with carving, beams cross into chunks their points miss."""
    rng = np.random.default_rng(3)
    tm, jm = _chunked_pair(chunk_dims, carve)
    for k in range(4):
        pts, valid = cloud(rng)
        pose = np.r_[1.3 * k - 0.5, rng.uniform(-0.5, 0.5, 2), 0.0, 0.0, rng.uniform(-0.6, 0.6)]
        tm.insert_keyframe_cloud(t64(pts), t64(valid, torch.bool), t64(pose), t64(0.05))
        jm.insert_keyframe_cloud(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose), jnp.float64(0.05))
    assert_chunked_equal(tm, jm)
    assert len(tm.chunks) >= 3
    assert (sum(int(g.misses.sum()) for g in tm.chunks.values()) > 0) == carve


def test_carve_only_chunk_equals_jax():
    """A beam from chunk 0 to an endpoint in chunk 2 passes through chunk 1,
    which holds no point: with carving it is kept (misses, no hits); without
    it is never made."""
    pts = np.zeros(CLOUD + (3,))
    pts[..., 2] = np.linspace(3.6, 3.9, CLOUD[0] * CLOUD[1]).reshape(CLOUD)  # x ~ 4.1-4.4 m ahead
    pts[..., 0] = 0.011
    valid = np.ones(CLOUD, bool)
    pose = np.array([0.53, 0.05, 0.05, 0.0, 0.0, 0.0])
    for carve in (False, True):
        tm, jm = _chunked_pair((16, 16, 16), carve)
        tm.insert_keyframe_cloud(t64(pts), t64(valid, torch.bool), t64(pose), t64(0.0))
        jm.insert_keyframe_cloud(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose), jnp.float64(0.0))
        assert_chunked_equal(tm, jm)
        assert ((1, 0, 0) in tm.chunks) == carve and (2, 0, 0) in tm.chunks
        if carve:
            g = tm.chunks[(1, 0, 0)]
            assert int(g.hits.sum()) == 0 and int(g.misses.sum()) > 0
        assert tm.total_hits() == CLOUD[0] * CLOUD[1]


def test_chunked_edge_cases_equal_jax():
    """No valid point: no chunk. A far point: the insert guard raises in
    both packages."""
    tm, jm = _chunked_pair((16, 16, 16), True)
    nan = np.full(CLOUD + (3,), np.nan)
    none = np.zeros(CLOUD, bool)
    tm.insert_keyframe_cloud(t64(nan), t64(none, torch.bool), torch.zeros(6, dtype=torch.float64), t64(0.0))
    jm.insert_keyframe_cloud(jnp.asarray(nan), jnp.asarray(none), jnp.zeros(6), jnp.float64(0.0))
    assert tm.chunks == {} and jm.chunks == {}

    pts, valid = cloud(np.random.default_rng(4), nan_share=0.0)
    pts[0, 0] = (1e6, 1e6, 1e6)
    tm, jm = _chunked_pair((16, 16, 16), False, max_chunks_per_insert=8)
    with pytest.raises(ValueError, match="chunks"):
        tm.insert_keyframe_cloud(t64(pts), t64(valid, torch.bool), torch.zeros(6, dtype=torch.float64), t64(0.0))
    with pytest.raises(ValueError, match="chunks"):
        jm.insert_keyframe_cloud(jnp.asarray(pts), jnp.asarray(valid), jnp.zeros(6), jnp.float64(0.0))


def test_jax_is_x64():
    assert jax.config.jax_enable_x64
