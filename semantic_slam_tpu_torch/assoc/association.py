"""Semantic landmark data association (port of
``semantic_slam_tpu.assoc.association``).

All distances are computed in two dense blocks -- detections vs existing
landmarks [M,L] (Mahalanobis with the landmark marginal + Q, or Euclidean),
and detections vs earlier in-frame detections taken as new landmarks [M,M]
-- and only the boolean recurrence "did detection i become a new landmark"
runs as an unrolled M-step loop, which keeps the reference's
sequential-table semantics (data_association.h:237-276). Candidate order is
the existing table first, then in-frame news in detection order, and the
first minimum wins.

``table_from_numpy`` / ``table_to_numpy`` and ``marginals_from_numpy`` /
``marginals_to_numpy`` carry the table and the marginal blocks between the
JAX package and the port.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from semantic_slam_tpu_torch.core import frames
from semantic_slam_tpu_torch.frontend.segmentation import DetectedObjects
from semantic_slam_tpu_torch.graph.state import set_rows
from semantic_slam_tpu_torch.solver.lm import inv33

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LandmarkTable:
    world: Tensor  # [L, 3] current estimate (synced from graph)
    cov: Tensor  # [L, 3, 3] marginal covariance (synced after optimize)
    class_id: Tensor  # [L] i32
    plane_type: Tensor  # [L] i32
    normal: Tensor  # [L, 4] world-frame plane coeffs (viz/type only)
    count: Tensor  # i32 0-d

    @property
    def capacity(self) -> int:
        return self.world.shape[0]

    def replace(self, **kw) -> "LandmarkTable":
        return dataclasses.replace(self, **kw)

    def mask(self) -> Tensor:
        return torch.arange(self.world.shape[0], device=self.world.device) < self.count


TABLE_FIELDS = tuple(f.name for f in dataclasses.fields(LandmarkTable))
_TABLE_INT_FIELDS = {"class_id", "plane_type", "count"}


def make_table(capacity: int, dtype=torch.float32, device=None) -> LandmarkTable:
    return LandmarkTable(
        world=torch.zeros((capacity, 3), dtype=dtype, device=device),
        cov=torch.eye(3, dtype=dtype, device=device).repeat(capacity, 1, 1),
        class_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        plane_type=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        normal=torch.zeros((capacity, 4), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def grow_table(t: LandmarkTable, factor: int = 2) -> LandmarkTable:
    big = make_table(t.capacity * factor, t.world.dtype, t.world.device)
    out = {"count": t.count}
    for name in TABLE_FIELDS[:-1]:
        dst = getattr(big, name).clone()
        dst[: t.capacity] = getattr(t, name)
        out[name] = dst
    return LandmarkTable(**out)


def table_from_numpy(arrays: Mapping[str, np.ndarray], device=None, dtype=None) -> LandmarkTable:
    """Build a port table from the JAX ``LandmarkTable`` leaves as numpy arrays."""
    out = {}
    for name in TABLE_FIELDS:
        a = np.asarray(arrays[name])
        if name in _TABLE_INT_FIELDS:
            out[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            t = torch.tensor(a, device=device)
            out[name] = t if dtype is None else t.to(dtype)
    return LandmarkTable(**out)


def table_to_numpy(t: LandmarkTable) -> dict[str, np.ndarray]:
    return {name: getattr(t, name).detach().cpu().numpy() for name in TABLE_FIELDS}


def marginals_from_numpy(marg: np.ndarray, device=None, dtype=None) -> Tensor:
    """Landmark marginal blocks [L,3,3] as a tensor on ``device``."""
    t = torch.tensor(np.asarray(marg), device=device)
    return t if dtype is None else t.to(dtype)


def marginals_to_numpy(marg: Tensor) -> np.ndarray:
    return marg.detach().cpu().numpy()


class AssocResult(NamedTuple):
    """Per-detection association outcome, aligned with DetectedObjects."""

    valid: Tensor  # [M] bool
    lm_id: Tensor  # [M] i32 landmark table / graph index
    is_new: Tensor  # [M] bool
    local_pose: Tensor  # [M, 3] measurement in robot frame (edge meas)
    world_pose: Tensor  # [M, 3] world centroid (new-node init)


def _plane_gate(na, ca, nb, cb, cos_thres: float, offset_thres: float) -> Tensor:
    """Normals na [A,3] at centroids ca vs nb/cb [B,..] -> ok [A,B]: angle and
    offset (re-derived through the centroids) agree, sign-invariant."""
    na_u = na / torch.clamp(torch.linalg.vector_norm(na, dim=-1, keepdim=True), min=1e-12)
    nb_u = nb / torch.clamp(torch.linalg.vector_norm(nb, dim=-1, keepdim=True), min=1e-12)
    da = -torch.sum(na_u * ca, dim=-1)
    db = -torch.sum(nb_u * cb, dim=-1)
    ndot = torch.einsum("ad,bd->ab", na_u, nb_u)
    s = torch.where(ndot < 0, -1.0, 1.0).to(na.dtype)
    angle_ok = torch.abs(ndot) >= cos_thres
    off_ok = torch.abs(da[:, None] - s * db[None, :]) <= offset_thres
    return angle_ok & off_ok


def associate(
    table: LandmarkTable,
    dets: DetectedObjects,
    robot_xyzrpy: Tensor,
    cam_angle: Tensor,
    use_maha: bool,
    maha_thres: float,
    eq_thres: float,
    land_noise: float,
    strict_frames: bool = True,
    rtabmap_y_offset: bool = False,
    use_plane_gate: bool = False,
    plane_cos_thres: float = 0.866,
    plane_offset_thres: float = 0.5,
) -> tuple[LandmarkTable, AssocResult]:
    """Vectorized association with exact sequential-table semantics.

    First-frame semantics: when the table is empty at frame start, every
    valid detection becomes a new landmark with no matching at all.
    Matched detections do not move the stored landmark.
    """
    dtype = table.world.dtype
    dev = table.world.device
    L = table.capacity
    M = dets.valid.shape[0]
    count0 = table.count
    not_first = count0 != 0
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)

    w_all = frames.convert_pose_to_world(
        robot_xyzrpy, cam_angle, dets.pose_cam, strict=strict_frames,
        rtabmap_y_offset=rtabmap_y_offset,
    ).to(dtype)
    n_all = frames.convert_normal_to_world(
        robot_xyzrpy, cam_angle, dets.normal_cam, strict=strict_frames
    ).to(dtype)
    local_all = frames.convert_cam_to_robot(cam_angle, dets.pose_cam).to(dtype)

    Q_meas = torch.eye(3, dtype=dtype, device=dev) * land_noise
    thres = maha_thres if use_maha else eq_thres

    # --- detections vs existing landmarks: [M, L] ------------------------
    type_ok = (
        table.mask()[None, :]
        & (table.class_id[None, :] == dets.class_id[:, None])
        & (table.plane_type[None, :] == dets.plane_type[:, None])
    )
    if use_plane_gate:
        type_ok = type_ok & _plane_gate(
            n_all[:, :3], w_all, table.normal[:, :3], table.world, plane_cos_thres, plane_offset_thres
        )
    z = w_all[:, None, :] - table.world[None, :, :]  # [M, L, 3]
    if use_maha:
        Qm_inv = inv33(table.cov + Q_meas[None])  # [L, 3, 3]
        d_exist = torch.einsum("mli,lij,mlj->ml", z, Qm_inv, z)
    else:
        d_exist = torch.linalg.vector_norm(z, dim=-1)
    type_ok = type_ok & not_first
    d_exist = torch.where(type_ok, d_exist, big)

    # --- detections vs earlier in-frame detections-as-landmarks: [M, M] --
    dz = w_all[:, None, :] - w_all[None, :, :]
    if use_maha:
        d_intra_raw = torch.einsum("mni,ij,mnj->mn", dz, inv33(2.0 * Q_meas), dz)
    else:
        d_intra_raw = torch.linalg.vector_norm(dz, dim=-1)
    earlier = torch.tril(torch.ones((M, M), dtype=torch.bool, device=dev), diagonal=-1)
    pair_type_ok = (
        earlier
        & dets.valid[None, :]
        & (dets.class_id[None, :] == dets.class_id[:, None])
        & (dets.plane_type[None, :] == dets.plane_type[:, None])
        & not_first
    )
    if use_plane_gate:
        pair_type_ok = pair_type_ok & _plane_gate(
            n_all[:, :3], w_all, n_all[:, :3], w_all, plane_cos_thres, plane_offset_thres
        )

    # --- sequential recurrence: which detections become new landmarks ----
    is_new = torch.zeros((M,), dtype=torch.bool, device=dev)
    min_exist = torch.min(d_exist, dim=1).values  # [M]
    any_exist = torch.any(type_ok, dim=1)  # [M]
    d_intra_cand = torch.where(pair_type_ok, d_intra_raw, big)
    for i in range(M):
        cand_i = pair_type_ok[i] & is_new  # earlier dets that became new
        found = any_exist[i] | torch.any(cand_i)
        dmin = torch.minimum(min_exist[i], torch.min(torch.where(is_new, d_intra_cand[i], big)))
        matched = found & (dmin <= thres)
        is_new[i] = dets.valid[i] & ~matched

    # --- landmark ids ----------------------------------------------------
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=0) - 1  # [M]
    new_ids = count0 + new_rank
    d_intra = torch.where(pair_type_ok & is_new[None, :], d_intra_raw, big)
    best = torch.argmin(torch.cat([d_exist, d_intra], dim=1), dim=1)  # first minimum
    intra_best = best >= L
    matched_id = torch.where(
        intra_best, count0 + new_rank[torch.clamp(best - L, 0, M - 1)], best
    ).to(torch.int32)
    lm_id = torch.where(is_new, new_ids, matched_id).to(torch.int32)

    # --- table update: new rows append, all others drop ------------------
    table = LandmarkTable(
        world=set_rows(table.world, new_ids, w_all, is_new),
        cov=set_rows(table.cov, new_ids, Q_meas, is_new),
        class_id=set_rows(table.class_id, new_ids, dets.class_id, is_new),
        plane_type=set_rows(table.plane_type, new_ids, dets.plane_type, is_new),
        normal=set_rows(table.normal, new_ids, n_all, is_new),
        count=count0 + torch.sum(is_new.to(torch.int32)).to(torch.int32),
    )
    return table, AssocResult(
        valid=dets.valid, lm_id=lm_id, is_new=is_new, local_pose=local_all, world_pose=w_all
    )


def sync_from_graph(table: LandmarkTable, graph_landmarks: Tensor, marginals: Tensor) -> LandmarkTable:
    """Refresh estimates/covariances from the optimizer (landmark ids are
    graph indices by construction, so this is a masked copy)."""
    m = table.mask()
    return table.replace(
        world=torch.where(m[:, None], graph_landmarks[: table.capacity], table.world),
        cov=torch.where(m[:, None, None], marginals[: table.capacity], table.cov),
    )
