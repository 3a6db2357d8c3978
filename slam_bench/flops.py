"""Operations and bytes of the kernels K1-K5 for the work the inputs need,
counted from the plain versions' arithmetic (float32: 4 bytes a value),
whatever implements them. Each input is read once and each output written
once; only live keyframes, landmarks, edges and real detections count, not
the padding of the capacities.

* K5, RANSAC scoring (``frontend.kernels.score_hypotheses_ref``): for every
  (point, hypothesis) of a detection, the point-to-plane distance (a
  3-term dot product and the offset: 6 flops) and the normal alignment (a
  3-term dot product: 5 flops); reads points, normals, the candidate mask
  and the hypotheses, writes one count a hypothesis.
* K1, the landmark-edge linearization (``solver.lm.linearize_arrays``'s
  point part): a rotation from the quaternion (25), the residual (21),
  J^T O for the pose and the landmark (135), the pose, coupling and
  landmark blocks (315), two gradients (45), chi2 (20): 561 flops an edge;
  reads each live pose, landmark and edge once, writes a pose's 6x6 block
  and gradient, an edge's 6x3 coupling, a landmark's 3x3 block and gradient.
* K2, the odometry chain (its SE(3) part): the relative and error poses
  (2 x 43), the log (60), the inverse right Jacobian (200), the adjoint
  product (396), J^T O twice (792), three 6x6 blocks (1188), two gradients
  (132), chi2 (78): 2932 flops an edge; reads two poses and the edge, writes
  the 121 outputs of an edge (three blocks, two gradients, chi2).
* K3, chi2: a landmark edge's residual and quadratic form (66), an odometry
  edge's (207); reads poses, landmarks and edges, writes one value.
* K4, the Schur PCG solve: the number of CG steps a launch takes is not
  visible to the host (the kernel stops at its tolerance), so its bound is
  its bytes alone: the Hessian blocks, couplings and gradients read once,
  the step written once. A lower bound on the work, so a share that never
  overstates.
"""

from __future__ import annotations

F = 4  # bytes a float32 value
IDX = 4  # bytes an int32 index

K5_FLOPS_PER_TEST = 11
K1_FLOPS_PER_EDGE = 561
K2_FLOPS_PER_EDGE = 2932
K3_FLOPS_LM_EDGE = 66
K3_FLOPS_ODOM_EDGE = 207


def k5(detections: int, points: int, hypotheses: int) -> tuple[float, float]:
    d, n, s = detections, points, hypotheses
    flops = K5_FLOPS_PER_TEST * d * n * s
    bytes_ = d * n * (3 * F + 3 * F + 1) + d * s * (4 * F) + d * s * IDX
    return flops, bytes_


def k1(poses: int, landmarks: int, lm_edges: int) -> tuple[float, float]:
    flops = K1_FLOPS_PER_EDGE * lm_edges
    read = poses * 7 * F + landmarks * 3 * F + lm_edges * (2 * IDX + 3 * F + 9 * F)
    write = poses * (36 + 6) * F + lm_edges * 18 * F + landmarks * (9 + 3) * F
    return flops, read + write


def k2(odom_edges: int) -> tuple[float, float]:
    flops = K2_FLOPS_PER_EDGE * odom_edges
    bytes_ = odom_edges * (2 * 7 * F + 2 * IDX + 7 * F + 36 * F + 121 * F)
    return flops, bytes_


def k3(poses: int, landmarks: int, odom_edges: int, lm_edges: int) -> tuple[float, float]:
    flops = K3_FLOPS_LM_EDGE * lm_edges + K3_FLOPS_ODOM_EDGE * odom_edges
    bytes_ = (poses * 7 * F + landmarks * 3 * F + lm_edges * (2 * IDX + 12 * F)
              + odom_edges * (2 * IDX + 43 * F) + F)
    return flops, bytes_


def k4(poses: int, landmarks: int, odom_edges: int, lm_edges: int) -> tuple[float, float]:
    read = poses * (36 + 6) * F + odom_edges * 36 * F + lm_edges * (18 * F + 2 * IDX) + landmarks * (9 + 3) * F
    write = poses * 6 * F + landmarks * 3 * F
    return 0.0, read + write
