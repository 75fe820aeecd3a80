"""Row-wise quadratic form lev_i = x_i^T M x_i — Algorithm 2's leverage
sweep, as a hand-written CUDA kernel (``csrc/leverage.cu``).

Port of :mod:`repro.kernels.leverage`.  :func:`leverage` launches the
kernel for CUDA tensors and takes the plain PyTorch version
(:data:`plain`) for CPU tensors; there is no fallback on the card.
``leverage.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import batch_shape, check, launch_device, library

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.leverage

#: Largest width whose (s, s) fp32 M fits in a block's 227 KB of shared
#: memory (238^2 * 4 = 226,576 bytes).
MAX_WIDTH = 238


def leverage(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """X: (..., n, s); M: (..., s, s) -> (..., n) float32 quadratic forms.

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared); the party axis of stacked scoring folds
    into the launch grid."""
    dev = launch_device(X, M)
    if dev.type == "cpu":
        return plain(X, M)
    if X.ndim < 2 or M.ndim < 2:
        raise ValueError(f"leverage takes X (..., n, s), M (..., s, s); got "
                         f"{tuple(X.shape)}, {tuple(M.shape)}")
    n, s = X.shape[-2:]
    if M.shape[-2:] != (s, s):
        raise ValueError(f"M must be ({s}, {s}) to match X, got {tuple(M.shape)}")
    if s > MAX_WIDTH:
        raise ValueError(
            f"leverage kernel keeps M in shared memory; s={s} > {MAX_WIDTH} "
            f"does not fit in 227 KB")
    batch, xb, mb = batch_shape(X.shape[:-2], M.shape[:-2], "leverage")
    B = math.prod(batch)
    out = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return out
    Xc = X.to(torch.float32).contiguous()
    Mc = M.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_leverage(
            Xc.data_ptr(), Mc.data_ptr(), out.data_ptr(), B, n, s,
            n * s if xb else 0, s * s if mb else 0, stream)
    check(code, "leverage")
    leverage.launches += 1
    return out


leverage.launches = 0
