"""PyTorch/CUDA port of grafp_tpu for NVIDIA Hopper (H100).

The JAX package ``grafp_tpu`` is the reference; this package computes the
same functions with PyTorch and hand-written CUDA kernels, and imports
nothing from it.
"""

import torch

# f32 parity with the reference: cuBLAS matmuls and cuDNN convolutions
# (PeakEmbed, Downsample) must run in full f32, not TF32. cuDNN defaults
# to TF32, which keeps ~3 decimal digits and breaks f32 parity.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
