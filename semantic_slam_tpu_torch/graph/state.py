"""Device-resident pose graph: fixed-capacity tensors + masks (port of
``semantic_slam_tpu.graph.state``).

Same layout as the JAX ``GraphState``: SE(3) keyframe nodes ``[K,7]``, point
landmarks ``[L,3]``, odometry and observation edges as index tensors, each
with a 0-d int32 count tensor on the device; active entries are the prefix
``[:count]``. Counts stay on the device so that appending never waits for
the card; the engine mirrors them on the host from its one fetch per tick.

``graph_from_numpy`` / ``graph_to_numpy`` carry a graph between the JAX
package (its ``GraphState`` leaves as numpy arrays) and the port.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from semantic_slam_tpu_torch.core import geometry as geo

Tensor = torch.Tensor


def set_rows(dst: Tensor, idx: Tensor, src: Tensor, valid: Tensor | None = None) -> Tensor:
    """Out-of-place ``dst[idx[m]] = src[m]`` for rows with ``valid[m]``.

    The counterpart of JAX's ``.at[idx].set(src, mode="drop")``: rows that
    are masked out or whose index falls outside ``dst`` are dropped. They are
    routed to a sentinel row past the end, which is sliced off, because an
    out-of-range index on a CUDA tensor is a device-side assert.
    """
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    ok = (idx >= 0) & (idx < n)
    if valid is not None:
        ok = ok & valid.reshape(-1)
    tgt = torch.where(ok, idx, n)
    buf = torch.cat([dst, dst[:1]])
    buf.index_copy_(0, tgt, src.to(dst.dtype).expand(idx.shape[0], *dst.shape[1:]))
    return buf[:n]


@dataclasses.dataclass(frozen=True)
class GraphState:
    poses: Tensor  # [K, 7]
    num_poses: Tensor  # i32 0-d
    landmarks: Tensor  # [L, 3]
    num_landmarks: Tensor
    odom_i: Tensor  # [E1] i32
    odom_j: Tensor
    odom_meas: Tensor  # [E1, 7]
    odom_info: Tensor  # [E1, 6, 6]
    num_odom: Tensor
    lme_k: Tensor  # [E2] i32
    lme_l: Tensor
    lme_meas: Tensor  # [E2, 3]
    lme_info: Tensor  # [E2, 3, 3]
    num_lme: Tensor

    @property
    def max_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.landmarks.shape[0]

    def replace(self, **kw) -> "GraphState":
        return dataclasses.replace(self, **kw)

    def pose_mask(self) -> Tensor:
        return torch.arange(self.poses.shape[0], device=self.poses.device) < self.num_poses

    def landmark_mask(self) -> Tensor:
        return torch.arange(self.landmarks.shape[0], device=self.poses.device) < self.num_landmarks

    def odom_mask(self) -> Tensor:
        return torch.arange(self.odom_i.shape[0], device=self.poses.device) < self.num_odom

    def lme_mask(self) -> Tensor:
        return torch.arange(self.lme_k.shape[0], device=self.poses.device) < self.num_lme

    def num_edges(self) -> Tensor:
        return self.num_odom + self.num_lme


FIELDS = tuple(f.name for f in dataclasses.fields(GraphState))
_INT_FIELDS = {"odom_i", "odom_j", "lme_k", "lme_l"} | {f for f in FIELDS if f.startswith("num_")}


def make_graph(
    max_poses: int = 512,
    max_landmarks: int = 128,
    max_odom_edges: int = 512,
    max_landmark_edges: int = 2048,
    dtype=torch.float32,
    device=None,
) -> GraphState:
    ident = geo.pose_identity(dtype, device)

    def count():
        return torch.zeros((), dtype=torch.int32, device=device)

    return GraphState(
        poses=ident.repeat(max_poses, 1),
        num_poses=count(),
        landmarks=torch.zeros((max_landmarks, 3), dtype=dtype, device=device),
        num_landmarks=count(),
        odom_i=torch.zeros((max_odom_edges,), dtype=torch.int32, device=device),
        odom_j=torch.zeros((max_odom_edges,), dtype=torch.int32, device=device),
        odom_meas=ident.repeat(max_odom_edges, 1),
        odom_info=torch.zeros((max_odom_edges, 6, 6), dtype=dtype, device=device),
        num_odom=count(),
        lme_k=torch.zeros((max_landmark_edges,), dtype=torch.int32, device=device),
        lme_l=torch.zeros((max_landmark_edges,), dtype=torch.int32, device=device),
        lme_meas=torch.zeros((max_landmark_edges, 3), dtype=dtype, device=device),
        lme_info=torch.zeros((max_landmark_edges, 3, 3), dtype=dtype, device=device),
        num_lme=count(),
    )


def graph_from_numpy(arrays: Mapping[str, np.ndarray], device=None, dtype=None) -> GraphState:
    """Build a port graph from the JAX ``GraphState`` leaves as numpy arrays
    (e.g. ``{k: np.asarray(v) for k, v in jax_graph._asdict().items()}``).
    Float leaves keep their dtype unless ``dtype`` is given."""
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        if name in _INT_FIELDS:
            out[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            t = torch.tensor(a, device=device)
            out[name] = t if dtype is None else t.to(dtype)
    return GraphState(**out)


def graph_to_numpy(g: GraphState) -> dict[str, np.ndarray]:
    """The graph's leaves as numpy arrays, keyed like the JAX ``GraphState``."""
    return {name: getattr(g, name).detach().cpu().numpy() for name in FIELDS}


def pow2_capacity(n: int, lo: int = 16) -> int:
    """The least power-of-two multiple of ``lo`` that holds ``n`` rows: the
    capacities of graphs built whole (a loaded .g2o file, a merge)."""
    c = lo
    while c < n:
        c *= 2
    return c


# ---------------------------------------------------------------------------
# mutation ops (functional; return new state + assigned index)
# ---------------------------------------------------------------------------


def add_se3_node(g: GraphState, pose7: Tensor) -> tuple[GraphState, Tensor]:
    """Append an SE(3) node (graph_slam.cpp:104-115); node 0 is gauge-fixed."""
    idx = g.num_poses
    return g.replace(poses=set_rows(g.poses, idx, pose7), num_poses=idx + 1), idx


def add_point_node(g: GraphState, xyz: Tensor) -> tuple[GraphState, Tensor]:
    idx = g.num_landmarks
    return g.replace(
        landmarks=set_rows(g.landmarks, idx, xyz), num_landmarks=idx + 1
    ), idx


def add_se3_edge(g: GraphState, i: Tensor, j: Tensor, meas7: Tensor, info66: Tensor) -> GraphState:
    e = g.num_odom
    return g.replace(
        odom_i=set_rows(g.odom_i, e, torch.as_tensor(i).to(torch.int32)),
        odom_j=set_rows(g.odom_j, e, torch.as_tensor(j).to(torch.int32)),
        odom_meas=set_rows(g.odom_meas, e, meas7),
        odom_info=set_rows(g.odom_info, e, info66),
        num_odom=e + 1,
    )


def add_se3_point_edge(g: GraphState, k: Tensor, l: Tensor, meas3: Tensor, info33: Tensor) -> GraphState:
    e = g.num_lme
    return g.replace(
        lme_k=set_rows(g.lme_k, e, torch.as_tensor(k).to(torch.int32)),
        lme_l=set_rows(g.lme_l, e, torch.as_tensor(l).to(torch.int32)),
        lme_meas=set_rows(g.lme_meas, e, meas3),
        lme_info=set_rows(g.lme_info, e, info33),
        num_lme=e + 1,
    )


def grow_graph(g: GraphState, factor: int = 2) -> GraphState:
    """Multiply every capacity by ``factor``, keeping the active prefixes."""
    big = make_graph(
        g.poses.shape[0] * factor,
        g.landmarks.shape[0] * factor,
        g.odom_i.shape[0] * factor,
        g.lme_k.shape[0] * factor,
        dtype=g.poses.dtype,
        device=g.poses.device,
    )
    out = {}
    for name in FIELDS:
        src = getattr(g, name)
        if name.startswith("num_"):
            out[name] = src
        else:
            dst = getattr(big, name).clone()
            dst[: src.shape[0]] = src
            out[name] = dst
    return GraphState(**out)
