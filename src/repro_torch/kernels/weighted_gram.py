"""Weighted Gram G = X^T diag(w) X — the normal equations of the ridge
solve, as a hand-written CUDA kernel (``csrc/weighted_gram.cu``).

Port of :mod:`repro.kernels.weighted_gram`.  The sum over rows is a
deterministic two-stage reduction: fixed contiguous row ranges per CTA,
then an in-order sum of the partials — no float atomics, so two launches
on the same input give the same bits.  :func:`weighted_gram` launches the
kernel for CUDA tensors and takes the plain PyTorch version
(:data:`plain`) for CPU tensors.  ``weighted_gram.launches`` counts
kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import batch_shape, check, launch_device, library

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.weighted_gram

#: The row split is a function of n alone (never of the device), so a
#: shape always reduces in the same order: ranges of at least MIN_ROWS
#: rows, about TARGET_CTAS of them (two per SM of an H100) once n is large.
MIN_ROWS = 256
TARGET_CTAS = 264


def row_split(n: int):
    """(rows per CTA, number of partials P) for n rows."""
    rows = max(MIN_ROWS, -(-n // TARGET_CTAS))
    return rows, -(-n // rows)


def weighted_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X: (..., n, d); w: (..., n) -> (..., d, d) float32 = X^T diag(w) X.

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared)."""
    dev = launch_device(X, w)
    if dev.type == "cpu":
        return plain(X, w)
    if X.ndim < 2 or w.ndim < 1:
        raise ValueError(f"weighted_gram takes X (..., n, d), w (..., n); got "
                         f"{tuple(X.shape)}, {tuple(w.shape)}")
    n, d = X.shape[-2:]
    if w.shape[-1] != n:
        raise ValueError(f"w has {w.shape[-1]} rows, X has {n}")
    batch, xb, wb = batch_shape(X.shape[:-2], w.shape[:-1], "weighted_gram")
    B = math.prod(batch)
    if n == 0 or B == 0 or d == 0:
        return torch.zeros(batch + (d, d), dtype=torch.float32, device=dev)
    rows, P = row_split(n)
    out = torch.empty(batch + (d, d), dtype=torch.float32, device=dev)
    part = torch.empty((B, P, d, d), dtype=torch.float32, device=dev)
    Xc = X.to(torch.float32).contiguous()
    wc = w.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_weighted_gram(
            Xc.data_ptr(), wc.data_ptr(), part.data_ptr(), out.data_ptr(),
            B, n, d, rows, n * d if xb else 0, n if wb else 0, stream)
    check(code, "weighted_gram")
    weighted_gram.launches += 1
    return out


weighted_gram.launches = 0
