"""Dispatch over the port's kernels.

``use_kernel=True`` (what the reference's ``"pallas"`` backend selects)
means the hand-written kernel: on a CUDA tensor it launches the kernel or
raises, on a CPU tensor the wrapper takes the plain version.
``use_kernel=False`` (``backend="ref"``) runs the plain PyTorch version on
any device.  There is no environment switch: the plain version is reached
only by asking for ``"ref"`` or by placing the data on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.leverage import leverage as _leverage
from repro_torch.kernels.weighted_gram import weighted_gram as _weighted_gram


def leverage(X: torch.Tensor, M: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    return _leverage(X, M) if use_kernel else ref.leverage(X, M)


def weighted_gram(X: torch.Tensor, w: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    return _weighted_gram(X, w) if use_kernel else ref.weighted_gram(X, w)
