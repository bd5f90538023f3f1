"""gs_slam_analytica_jacobian_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX reference ``gs_slam_analytica_jacobian_tpu``,
with the same layout (``ops``, ``models``, ``slam``, ``parallel``,
``utils``, ``gui``) so that each module's counterpart is easy to find; the
SLAM command line is ``python -m gs_slam_analytica_jacobian_tpu_torch
.slam_main``. It imports torch only, never jax and nothing of the JAX
package. The compositing kernels (32x32 and 16x16, forward and backward,
and the 32x32 kernels' bfloat16 bodies: ``csrc/*.cu``, wrapped by
``ops/tile_kernel2.py`` and ``ops/tile_kernel16.py``) are CUDA C++ for
Hopper (sm_90a), built with nvcc on first use; on CPU tensors their plain
PyTorch versions run instead.

Entry points take ``device=None``, which means ``"cuda"``: without a GPU
they raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# f32 parity with the reference: the JAX package forces true-f32 matmuls
# (gs_slam_analytica_jacobian_tpu/__init__.py:41). Under TF32 the Scharr
# convolution of losses.compute_grad_mask and the (8, HW) @ (HW, 8) IRLS
# normal matrix would drift from the f32 reference, so both are off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
