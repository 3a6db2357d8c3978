"""Hand-written CUDA kernels of the frontend and their plain PyTorch versions
(port of ``semantic_slam_tpu.frontend.pallas_kernels``).

``score_hypotheses`` is the RANSAC scoring step of the plane extractor: per
detection, per plane hypothesis, the number of points that pass the
point-to-plane distance gate AND the normal-alignment gate AND the candidate
mask. On a CUDA tensor it launches ``csrc/score_hypotheses.cu`` (built on
first use, see ``_build``) or raises; on a CPU tensor it runs
``score_hypotheses_ref``. There is no other switch between the two.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

MAX_HYPOTHESES = 2048  # the kernel stages 20 bytes per hypothesis in shared memory


def score_hypotheses_ref(
    pts: Tensor, nrm: Tensor, cand: Tensor, hyp_n: Tensor, hyp_d: Tensor,
    dist_thres: float, cos_thres: float,
) -> Tensor:
    """Plain version: pts/nrm [D,N,3], cand [D,N] bool, hyp_n [D,S,3],
    hyp_d [D,S] -> inlier counts [D,S] in pts.dtype. Materializes [D,N,S]."""
    hT = hyp_n.transpose(-1, -2)
    dist = torch.abs(pts @ hT + hyp_d[:, None, :])  # [D, N, S]
    align = nrm @ hT
    inl = (dist < dist_thres) & (align > cos_thres) & cand[:, :, None]
    return torch.sum(inl, dim=1).to(pts.dtype)


def score_hypotheses(
    pts: Tensor, nrm: Tensor, cand: Tensor, hyp_n: Tensor, hyp_d: Tensor,
    dist_thres: float, cos_thres: float,
) -> Tensor:
    """Per-hypothesis inlier counts [D,S] (pts.dtype) for pts/nrm [D,N,3],
    cand [D,N] bool, hyp_n [D,S,3], hyp_d [D,S].

    CPU tensors take the plain version. CUDA tensors are cast to f32 (as the
    TPU wrapper does) and go to the kernel; thresholds are compared in f32.
    """
    if pts.device.type == "cpu":
        return score_hypotheses_ref(pts, nrm, cand, hyp_n, hyp_d, dist_thres, cos_thres)
    if pts.device.type != "cuda":
        raise ValueError(f"score_hypotheses: unsupported device {pts.device}")
    D, N, _ = pts.shape
    S = hyp_n.shape[1]
    for name, t, shape in (
        ("pts", pts, (D, N, 3)), ("nrm", nrm, (D, N, 3)), ("cand", cand, (D, N)),
        ("hyp_n", hyp_n, (D, S, 3)), ("hyp_d", hyp_d, (D, S)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"score_hypotheses: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != pts.device:
            raise ValueError(f"score_hypotheses: {name} is on {t.device}, pts on {pts.device}")
    if cand.dtype != torch.bool:
        raise TypeError(f"score_hypotheses: cand must be bool, got {cand.dtype}")
    if not 0 < S <= MAX_HYPOTHESES or D > 65535:
        raise ValueError(f"score_hypotheses: S={S} must be in 1..{MAX_HYPOTHESES}, D={D} <= 65535")

    from semantic_slam_tpu_torch import _build

    f32 = [t.to(torch.float32).contiguous() for t in (pts, nrm, hyp_n, hyp_d)]
    cand_u8 = cand.contiguous().view(torch.uint8)
    counts = torch.zeros((D, S), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        code = _build.library("score_hypotheses").score_hypotheses_launch(
            f32[0].data_ptr(), f32[1].data_ptr(), cand_u8.data_ptr(),
            f32[2].data_ptr(), f32[3].data_ptr(), D, N, S,
            float(dist_thres), float(cos_thres), counts.data_ptr(), stream,
        )
    _build.check(code, "score_hypotheses kernel launch", "score_hypotheses")
    score_hypotheses.launches += 1
    return counts.to(pts.dtype)


score_hypotheses.launches = 0  # kernel launches (CUDA path only)
