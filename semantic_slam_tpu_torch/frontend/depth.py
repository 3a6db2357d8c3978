"""Depth-image backprojection on the device (port of
``semantic_slam_tpu.frontend.depth``): u16 depth -> organized cam-frame cloud.

ROS camera model: z = depth * scale along the optical axis, x right, y down,
pixel (u, v) with intrinsics (fx, fy, cx, cy); depth == 0 marks invalid.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def backproject_depth(depth: Tensor, intr4: Tensor, depth_scale: Tensor) -> tuple[Tensor, Tensor]:
    """Pinhole backprojection: (points [..., H, W, 3], valid [..., H, W])
    of a depth image [..., H, W] (or a batch of them, one camera). Invalid
    pixels become zero points with valid=False. ``depth`` is any integer or
    float tensor; the points take ``intr4``'s dtype."""
    H, W = depth.shape[-2:]
    dtype = intr4.dtype
    fx, fy, cx, cy = intr4[0], intr4[1], intr4[2], intr4[3]
    z = depth.to(dtype) * depth_scale
    u = torch.arange(W, dtype=dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=dtype, device=depth.device)[:, None]
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    valid = depth > 0
    pts = torch.stack([x, y, z], dim=-1)
    return torch.where(valid[..., None], pts, 0.0), valid
