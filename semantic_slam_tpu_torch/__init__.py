"""semantic_slam_tpu_torch — the PyTorch/CUDA port of ``semantic_slam_tpu``.

Module paths mirror the JAX package so each port module sits at the path of
the JAX function it replaces. The port imports nothing of the JAX package:
what it needs of the JAX package's jax-free modules (``config``,
``core.np_geometry``, ``io``, ``eval``, ``runtime.keyframe_gate``,
``viz.markers``, ``viz.rviz_bag``, ``utils.profiling``, and ``native``'s
C++ source) is copied here at the same relative path, trimmed to what the
port calls. This package imports torch and never jax.

The Schur products and Cholesky factors run in full float32 on the card:
TF32 is switched off for matmuls and cuDNN here, at import.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
