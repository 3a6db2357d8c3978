"""semantic_slam_tpu_torch — the PyTorch/CUDA port of ``semantic_slam_tpu``.

Module paths mirror the JAX package so each port module sits at the path of
the JAX function it replaces. Modules of the JAX package that never import
jax (``config``, ``core.np_geometry``, ``io``, ``eval``,
``runtime.keyframe_gate``, ``viz.markers``, ``utils.profiling``) are imported
from there, not copied. This package imports torch and never jax.

The Schur products and Cholesky factors run in full float32 on the card:
TF32 is switched off for matmuls and cuDNN here, at import.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
