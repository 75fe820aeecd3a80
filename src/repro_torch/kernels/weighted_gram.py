"""Weighted Gram G = X^T diag(w) X — the normal equations of the ridge
solve, as a hand-written CUDA kernel (``csrc/weighted_gram.cu``).

Port of :mod:`repro.kernels.weighted_gram`.  The sum over rows is a
deterministic two-stage reduction: fixed contiguous row ranges per CTA,
each summing one triangle of G in a fixed order, then a fixed-order sum of
the partials that fills both triangles from the one — no float atomics, so
two launches on the same input give the same bits and G is exactly
symmetric.  :func:`weighted_gram` launches the kernel for CUDA tensors and
takes the plain PyTorch version (:data:`plain`) for CPU tensors.
``weighted_gram.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (PLAIN_DEVICES, batch_shape, check, launch_device,
                                         library)

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.weighted_gram

#: The row split is a function of n alone (never of the device), so a
#: shape always reduces in the same order: ranges of at least
#: GRAM_MIN_ROWS rows (one shared-memory stage of the kernel), about
#: GRAM_TARGET_CTAS of them (two per SM of an H100) once n is large.  At
#: n = 5,000 that is 157 ranges, more than the card's 132 SMs.
GRAM_MIN_ROWS = 32
GRAM_TARGET_CTAS = 264


def gram_split(n: int):
    """(rows per CTA, number of partials P) for n rows."""
    rows = max(GRAM_MIN_ROWS, -(-n // GRAM_TARGET_CTAS))
    return rows, -(-n // rows)


def weighted_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X: (..., n, d); w: (..., n) -> (..., d, d) float32 = X^T diag(w) X.

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared)."""
    dev = launch_device(X, w)
    if dev.type in PLAIN_DEVICES:
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
    rows, P = gram_split(n)
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
