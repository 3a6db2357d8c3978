"""The FLOP and byte counts of K1-K5, held to hand counts on a small graph:
3 live poses, 2 landmarks, 2 odometry edges, 4 landmark edges; K5 with 2
detections of 10 points and 3 hypotheses."""

from slam_bench import flops


def test_k5():
    # 11 flops a (point, hypothesis); points, normals (12 B each), mask (1 B);
    # hypotheses (16 B) and one int32 count each
    assert flops.k5(2, 10, 3) == (11 * 2 * 10 * 3, 2 * 10 * 25 + 2 * 3 * 16 + 2 * 3 * 4)


def test_k1():
    # 561 flops an edge; read 3 poses (28 B), 2 landmarks (12 B), 4 edges
    # (two indices, a 3-vector, a 3x3: 56 B); write 3 pose blocks and
    # gradients (168 B), 4 couplings (72 B), 2 landmark blocks (48 B)
    assert flops.k1(3, 2, 4) == (2244, 84 + 24 + 224 + 504 + 288 + 96)


def test_k2():
    # 2932 flops an edge; two poses, two indices, a pose, a 6x6 read (236 B),
    # 121 values written (484 B)
    assert flops.k2(2) == (5864, 2 * (56 + 8 + 28 + 144 + 484))


def test_k3():
    # poses, landmarks, 4 landmark edges (56 B), 2 odometry edges (two
    # indices, a pose, a 6x6: 180 B) read, one total written
    assert flops.k3(3, 2, 2, 4) == (66 * 4 + 207 * 2, 84 + 24 + 4 * 56 + 2 * 180 + 4)


def test_k4_bytes_only():
    # pose blocks (168 B), chain blocks (144 B), couplings + indices (80 B),
    # landmark blocks (48 B) read; the step (24 B a pose, 12 a landmark) written
    assert flops.k4(3, 2, 2, 4) == (0.0, 3 * 168 + 2 * 144 + 4 * 80 + 2 * 48 + 3 * 24 + 2 * 12)
