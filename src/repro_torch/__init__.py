"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``repro_torch.core``, ``repro_torch.kernels``) and never imports
it, nor JAX.  Entry points run on the card unless the caller passes
``device="cpu"``.

Importing the package pins float32 matrix products to full IEEE precision
(TF32 off for matmul and cuDNN): the reference computes in fp32, and the
port's parity holds only at that precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
