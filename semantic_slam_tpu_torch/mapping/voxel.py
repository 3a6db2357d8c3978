"""Occupancy voxel mapping on the device (port of
``semantic_slam_tpu.mapping.voxel``).

Replaces the external ``octomap_server`` node the reference launches
(``launch/ps_slam_with_snap_pose_bucket_det_lab_data_with_octomap.launch:46-58``,
resolution 0.05 m): clouds transformed by the *optimized* keyframe poses are
scattered into a dense voxel grid on the device. The map->odom TF that the
reference publishes so octomap sees drift-corrected clouds is inherent here
— voxelization consumes the corrected poses directly.

Free-space carving (octomap's beam-miss updates) samples every beam at a
fixed number of points spaced at most one voxel apart, an [N, S, 3] set of
samples scattered as integer counts. Choose ``samples >= max_range /
resolution`` and the sample chain crosses every voxel the exact DDA would
(up to corner-clipping ties). The beams are taken in blocks of at most
``CARVE_BLOCK_SAMPLES`` samples, which bounds the temporaries (a 640x480
cloud at 128 samples is 39.3 M samples); integer adds are exact in any
order, so the counts do not depend on the blocking.

Hits and misses are int32 counts added with ``index_add`` on the flattened
grid. Masked samples (out of bounds, invalid, the endpoint voxel) add 0 at
a clipped index, in the reference's order of operations. Invalid points are
replaced before they reach ``floor`` (a NaN has no integer), and the float
index is clamped to [-1, max(dims)] first, so a far point converts to an
out-of-bounds index rather than overflowing. Indices are computed one axis
at a time.

Unbounded scenes (KITTI-class trajectories) use :class:`ChunkedVoxelMap`:
the world is tiled into fixed-shape chunks materialized on first touch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from semantic_slam_tpu_torch.core import frames

Tensor = torch.Tensor

# beams are carved in blocks of at most this many samples (~0.3-0.4 GB of
# temporaries a block in f32/f64)
CARVE_BLOCK_SAMPLES = 1 << 22


class VoxelGrid(NamedTuple):
    hits: Tensor  # [X, Y, Z] int32 endpoint counts
    misses: Tensor  # [X, Y, Z] int32 free-space (beam pass-through) counts
    origin: Tensor  # [3] world position of voxel (0,0,0) corner
    resolution: Tensor  # 0-d, meters


def make_grid(
    dims: tuple[int, int, int] = (256, 256, 64),
    origin=(-6.4, -6.4, -1.6),
    resolution: float = 0.05,
    dtype=torch.float32,
    device="cpu",
) -> VoxelGrid:
    return VoxelGrid(
        hits=torch.zeros(dims, dtype=torch.int32, device=device),
        misses=torch.zeros(dims, dtype=torch.int32, device=device),
        origin=torch.tensor(origin, dtype=dtype, device=device),
        resolution=torch.tensor(resolution, dtype=dtype, device=device),
    )


def _axis_index(p: Tensor, origin: Tensor, resolution: Tensor, hi: int) -> Tensor:
    """floor((p - origin) / resolution) of one axis as int32, clamped to
    [-1, hi]: with ``hi`` at least the axis's voxel count, out of bounds
    stays out of bounds. ``p`` must be finite."""
    return torch.floor((p - origin) / resolution).clamp_(-1, hi).to(torch.int32)


def _indices(grid: VoxelGrid, axes: list[Tensor]) -> list[Tensor]:
    """The voxel index of points given one coordinate tensor an axis, one
    tensor an axis."""
    hi = max(grid.hits.shape)
    return [_axis_index(p, grid.origin[a], grid.resolution, hi) for a, p in enumerate(axes)]


def _in_bounds(grid: VoxelGrid, idx: list[Tensor]) -> Tensor:
    out = None
    for i, n in zip(idx, grid.hits.shape):
        ok = (i >= 0) & (i < n)
        out = ok if out is None else out & ok
    return out


def _flat(grid: VoxelGrid, idx: list[Tensor]) -> Tensor:
    """Voxel indices, clipped into the grid, as flat indices into [X*Y*Z]."""
    X, Y, Z = grid.hits.shape
    ix, iy, iz = (i.clamp(0, n - 1) for i, n in zip(idx, (X, Y, Z)))
    return (ix * Y + iy) * Z + iz


def _add(counts: Tensor, flat: Tensor, upd: Tensor) -> Tensor:
    """counts [X,Y,Z] + the scatter of upd at flat, as a new tensor."""
    return counts.reshape(-1).index_add(0, flat.reshape(-1), upd.reshape(-1)).reshape(counts.shape)


def insert_world_points(grid: VoxelGrid, pts_world: Tensor, valid: Tensor) -> VoxelGrid:
    """Scatter endpoint hits into the grid (out-of-bounds / invalid masked)."""
    pts = torch.where(valid[:, None], pts_world, grid.origin)
    idx = _indices(grid, pts.unbind(-1))
    inb = _in_bounds(grid, idx) & valid
    return grid._replace(hits=_add(grid.hits, _flat(grid, idx), inb.to(torch.int32)))


def _cam_to_world(points_cam: Tensor, robot_xyzrpy: Tensor, cam_angle: Tensor, strict_frames: bool) -> Tensor:
    """R p + t for the cam->world chain. The rotation is formed in float64
    and rounded once to the points' dtype, and the product is taken one
    elementwise op at a time: each op rounds once on any device, so the card
    and the CPU map the same points (the card's sin/cos and cuBLAS round
    otherwise, and a point moved by an ulp can cross a voxel face)."""
    R = frames.t_cam_world(robot_xyzrpy.double(), cam_angle.double(), strict=strict_frames)[:3, :3]
    R = R.to(points_cam.dtype)
    p = points_cam.reshape(-1, 3)
    return torch.stack([p[:, 0] * R[i, 0] + p[:, 1] * R[i, 1] + p[:, 2] * R[i, 2] + robot_xyzrpy[i]
                        for i in range(3)], dim=-1)


def insert_keyframe_cloud(
    grid: VoxelGrid,
    points_cam: Tensor,  # [H, W, 3]
    cloud_valid: Tensor,  # [H, W]
    robot_xyzrpy: Tensor,  # [6] optimized keyframe pose
    cam_angle: Tensor,
    strict_frames: bool = True,
) -> VoxelGrid:
    """Transform an organized cam-frame cloud by the corrected pose and insert.

    Uses the same cam->world chain as the landmark pipeline so the map is
    consistent with the graph (the role of publishMap2OdomTF,
    semantic_graph_slam_ros.cpp:437-452)."""
    w = _cam_to_world(points_cam, robot_xyzrpy, cam_angle, strict_frames)
    return insert_world_points(grid, w, cloud_valid.reshape(-1))


def carve_free_space(
    grid: VoxelGrid,
    sensor_origin_w: Tensor,  # [3] beam origin in world
    pts_world: Tensor,  # [N, 3] beam endpoints in world
    valid: Tensor,  # [N]
    samples: int = 128,
) -> VoxelGrid:
    """Mark voxels traversed by the beams as free (octomap's miss updates).

    Each ray is sampled at ``samples`` points in (0, 1) exclusive of the
    endpoint voxel; pick ``samples >= max_range / resolution`` so consecutive
    samples are at most one voxel apart. Out-of-bounds samples and samples
    landing in the endpoint voxel are dropped.
    """
    dtype = pts_world.dtype
    ends = torch.where(valid[:, None], pts_world, sensor_origin_w)
    t = ((torch.arange(samples, dtype=dtype, device=pts_world.device) + 0.5) / samples)[None, :]
    misses = grid.misses.reshape(-1).clone()
    block = max(1, CARVE_BLOCK_SAMPLES // samples)
    for b0 in range(0, ends.shape[0], block):
        e, v = ends[b0 : b0 + block], valid[b0 : b0 + block]
        end_idx = _indices(grid, e.unbind(-1))
        # the samples origin + t * ray, one [B, S] tensor an axis
        idx = _indices(grid, [sensor_origin_w[a] + t * (e[:, a : a + 1] - sensor_origin_w[a]) for a in range(3)])
        is_end = (idx[0] == end_idx[0][:, None]) & (idx[1] == end_idx[1][:, None]) & (idx[2] == end_idx[2][:, None])
        upd = (_in_bounds(grid, idx) & ~is_end & v[:, None]).to(torch.int32)
        misses.index_add_(0, _flat(grid, idx).reshape(-1), upd.reshape(-1))
    return grid._replace(misses=misses.reshape(grid.misses.shape))


def insert_keyframe_cloud_carving(
    grid: VoxelGrid,
    points_cam: Tensor,
    cloud_valid: Tensor,
    robot_xyzrpy: Tensor,
    cam_angle: Tensor,
    strict_frames: bool = True,
    samples: int = 128,
) -> VoxelGrid:
    """Endpoint hits + free-space carving for one keyframe cloud."""
    w = _cam_to_world(points_cam, robot_xyzrpy, cam_angle, strict_frames)
    v = cloud_valid.reshape(-1)
    grid = insert_world_points(grid, w, v)
    return carve_free_space(grid, robot_xyzrpy[:3], w, v, samples=samples)


def occupied_mask(grid: VoxelGrid, min_hits: int = 2) -> Tensor:
    return grid.hits >= min_hits


def occupancy_log_odds(grid: VoxelGrid, l_occ: float = 0.85, l_free: float = -0.4) -> Tensor:
    """Per-voxel log-odds combining endpoint hits and beam misses (octomap's
    sensor model with the standard 0.85 / -0.4 weights)."""
    return grid.hits * l_occ + grid.misses * l_free


def occupied_mask_probabilistic(grid: VoxelGrid, thres: float = 0.85) -> Tensor:
    """Occupied = accumulated log-odds above threshold — unlike the count
    mask, a voxel seen through by many later beams decays back to free."""
    return occupancy_log_odds(grid) >= thres


def occupied_centers(grid, min_hits: int = 2) -> np.ndarray:
    """Host-side extraction of occupied voxel centers [M,3] (viz/export).

    Accepts a single :class:`VoxelGrid` or a :class:`ChunkedVoxelMap`."""
    if isinstance(grid, ChunkedVoxelMap):
        return grid.occupied_centers(min_hits)
    idx = np.argwhere(occupied_mask(grid, min_hits).cpu().numpy())
    res = float(grid.resolution)
    return (idx + 0.5) * res + grid.origin.cpu().numpy()


# ---------------------------------------------------------------------------
# unbounded scenes: chunked grids
# ---------------------------------------------------------------------------


def _world_points_aabb(
    points_cam: Tensor,
    cloud_valid: Tensor,
    robot_xyzrpy: Tensor,
    cam_angle: Tensor,
    strict_frames: bool = True,
):
    """Transform a cam cloud to world once; return points + valid + AABB
    (over valid points + the sensor origin, so carving rays stay inside) +
    the valid count, all on the device."""
    w = _cam_to_world(points_cam, robot_xyzrpy, cam_angle, strict_frames)
    v = cloud_valid.reshape(-1)
    big = torch.finfo(w.dtype).max
    lo = torch.minimum(torch.where(v[:, None], w, big).amin(dim=0), robot_xyzrpy[:3])
    hi = torch.maximum(torch.where(v[:, None], w, -big).amax(dim=0), robot_xyzrpy[:3])
    return w, v, lo, hi, torch.sum(v)


def _chunk_point_counts(
    w: Tensor,  # [N, 3] world points
    v: Tensor,  # [N] valid
    extent: Tensor,  # [3] chunk extent (meters)
    lo_c: Tensor,  # [3] first chunk coordinate of the AABB
    n_c: Tensor,  # [3] chunk counts per axis
    max_chunks: int,
) -> Tensor:
    """Histogram of valid points over the AABB's chunk boxes, flattened as
    ``relx * (ny*nz) + rely * nz + relz``, of fixed [max_chunks] shape."""
    wf = torch.where(v[:, None], w, 0.0)
    rel = torch.floor(wf / extent[None, :]).to(torch.int64) - lo_c[None, :]
    inb = torch.all((rel >= 0) & (rel < n_c[None, :]), dim=-1) & v
    flat = rel[:, 0] * (n_c[1] * n_c[2]) + rel[:, 1] * n_c[2] + rel[:, 2]
    flat = torch.where(inb, flat, max_chunks)  # the spill bin, dropped
    counts = torch.zeros(max_chunks + 1, dtype=torch.int32, device=w.device)
    return counts.index_add(0, flat, inb.to(torch.int32))[:max_chunks]


class ChunkedVoxelMap:
    """Unbounded occupancy map as a host dict of fixed-shape chunks.

    The world is tiled into chunks of ``chunk_dims`` voxels, each a
    :class:`VoxelGrid` on the device of the clouds inserted, materialized on
    first touch. Out-of-chunk points are masked by the insert's own bounds
    check. An insert fetches three things to the host: the cloud's world
    AABB with its valid count, the [max_chunks_per_insert] point counts per
    candidate chunk, and, for a chunk that only carving would touch, its
    miss total.
    """

    def __init__(
        self,
        chunk_dims: tuple[int, int, int] = (128, 128, 64),
        resolution: float = 0.05,
        carve: bool = False,
        samples: int = 128,
        strict_frames: bool = True,
        dtype=torch.float32,
        max_chunks_per_insert: int = 64,
    ):
        self.chunk_dims = tuple(chunk_dims)
        self.resolution = float(resolution)
        self.extent = tuple(d * self.resolution for d in self.chunk_dims)
        self.carve = carve
        self.samples = int(samples)
        self.strict_frames = strict_frames
        self.dtype = dtype
        self.max_chunks_per_insert = int(max_chunks_per_insert)
        self.chunks: dict[tuple[int, int, int], VoxelGrid] = {}

    def _chunk_range(self, lo, hi):
        lo_c = np.floor(np.asarray(lo, np.float64) / self.extent).astype(int)
        hi_c = np.floor(np.asarray(hi, np.float64) / self.extent).astype(int)
        return lo_c, hi_c

    def _grid_for(self, cc: tuple[int, int, int], device) -> VoxelGrid:
        g = self.chunks.get(cc)
        if g is None:
            origin = tuple(cc[i] * self.extent[i] for i in range(3))
            g = make_grid(self.chunk_dims, origin, self.resolution, self.dtype, device)
        return g

    def insert_keyframe_cloud(
        self,
        points_cam: Tensor,
        cloud_valid: Tensor,
        robot_xyzrpy: Tensor,
        cam_angle: Tensor,
    ) -> None:
        w, v, lo, hi, n_valid = _world_points_aabb(
            points_cam, cloud_valid, robot_xyzrpy, cam_angle, strict_frames=self.strict_frames,
        )
        box = torch.cat([lo, hi, n_valid.to(lo.dtype)[None]]).cpu().numpy()  # fetch 1
        if int(box[6]) == 0:
            return
        lo_c, hi_c = self._chunk_range(box[:3], box[3:6])
        n_boxes = int(np.prod(hi_c - lo_c + 1))
        if n_boxes > self.max_chunks_per_insert:
            raise ValueError(
                f"cloud AABB spans {n_boxes} chunks (> {self.max_chunks_per_insert}); "
                "likely corrupt points — raise max_chunks_per_insert if intended"
            )
        dev = w.device
        origin_w = robot_xyzrpy[:3]
        # points per candidate chunk: a diagonal cloud's AABB covers many
        # chunks no point lands in. Carving can still mark free space in
        # point-empty pass-through chunks, so with carve=True a new chunk
        # without points runs the carve and is kept only if it wrote.
        counts = _chunk_point_counts(
            w, v,
            torch.tensor(self.extent, dtype=w.dtype, device=dev),
            torch.as_tensor(lo_c, dtype=torch.int64, device=dev),
            torch.as_tensor(hi_c - lo_c + 1, dtype=torch.int64, device=dev),
            self.max_chunks_per_insert,
        ).cpu().numpy()  # fetch 2
        nyz = (hi_c[1] - lo_c[1] + 1) * (hi_c[2] - lo_c[2] + 1)
        nz = hi_c[2] - lo_c[2] + 1
        for cx in range(lo_c[0], hi_c[0] + 1):
            for cy in range(lo_c[1], hi_c[1] + 1):
                for cz in range(lo_c[2], hi_c[2] + 1):
                    cc = (int(cx), int(cy), int(cz))
                    flat = (cx - lo_c[0]) * nyz + (cy - lo_c[1]) * nz + (cz - lo_c[2])
                    has_points = counts[flat] > 0
                    if not has_points and not self.carve:
                        continue
                    is_new = cc not in self.chunks
                    g = self._grid_for(cc, dev)
                    if not has_points and is_new:
                        g = carve_free_space(g, origin_w, w, v, samples=self.samples)
                        if int(torch.sum(g.misses)) > 0:  # fetch 3, carve-only chunks
                            self.chunks[cc] = g
                        continue
                    if has_points:
                        g = insert_world_points(g, w, v)
                    if self.carve:
                        g = carve_free_space(g, origin_w, w, v, samples=self.samples)
                    self.chunks[cc] = g

    def occupied_centers(self, min_hits: int = 2) -> np.ndarray:
        parts = [occupied_centers(g, min_hits) for g in self.chunks.values()]
        parts = [p for p in parts if len(p)]
        if not parts:
            return np.zeros((0, 3))
        return np.concatenate(parts, axis=0)

    def total_hits(self) -> int:
        return int(sum(int(torch.sum(g.hits)) for g in self.chunks.values()))
