"""Fused k-means assign + cluster update — one Lloyd iteration's read of
X, and Algorithm 3's cluster sizes and costs — as a hand-written CUDA
kernel (``csrc/kmeans_assign_update.cu``).

Port of :mod:`repro.kernels.kmeans_assign_update`.  The per-cluster sums
are a deterministic two-stage reduction: fixed contiguous row ranges per
CTA, each reduced in row order, then an in-order sum of the partials — no
float atomics, so two launches on the same input give the same bits.
:func:`kmeans_assign_update` launches the kernel for CUDA tensors and
takes the plain PyTorch version (:data:`plain`) for CPU tensors.
``kmeans_assign_update.launches`` counts kernel launches.

Like :mod:`repro_torch.kernels.kmeans_assign`, the kernel takes the
argmin of the unclamped distance and clamps the minimum (the Pallas
kernel's order); the plain version clamps first (``repro.kernels.ref``'s).
Where the layout does not fit in shared memory (``tile_rows`` gives
``GLOBAL``), stage 1 runs the kernel's global variant, which gives the
same partials.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import batch_shape, check, launch_device, library
from repro_torch.kernels.kmeans_assign import check_shapes, common_bytes, tile_rows

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.kmeans_assign_update

#: The row split is a function of n alone (never of the device), so a
#: shape always reduces in the same order: ranges of at least MIN_ROWS
#: rows, about TARGET_CTAS of them once n is large.  The vkmc scores and
#: draws depend on this order through ccost.
MIN_ROWS = 256
TARGET_CTAS = 264


def row_split(n: int):
    """(rows per CTA, number of partials P) for n rows."""
    rows = max(MIN_ROWS, -(-n // TARGET_CTAS))
    return rows, -(-n // rows)


def smem_bytes(k: int, d: int, rows: int) -> int:
    """Bytes of the stage-1 layout: the shared part, the tile's weights,
    distances and assignments, and the (k d + 2 k) partial sums."""
    return common_bytes(k, d, rows) + 4 * (3 * rows + k * d + 2 * k)


def kmeans_assign_update(X: torch.Tensor, C: torch.Tensor,
                         w: Optional[torch.Tensor] = None):
    """X: (..., n, d); C: (..., k, d); w: optional (..., n) weights
    (default ones) -> (assign int32 (..., n), d2 f32 (..., n), csum f32
    (..., k, d), wsum f32 (..., k), ccost f32 (..., k)).

    X, C and w may each carry the leading batch dims or not, independently
    (an operand without them is shared); the batch folds into the grid."""
    dev = launch_device(X, C) if w is None else launch_device(X, C, w)
    if dev.type == "cpu":
        return plain(X, C, w)
    n, d, k = check_shapes("kmeans_assign_update", X, C)
    if w is not None and (w.ndim < 1 or w.shape[-1] != n):
        raise ValueError(f"w must be (..., {n}) to match X, got {tuple(w.shape)}")
    rows = tile_rows(k, d, smem_bytes)
    batch, xb, cb = batch_shape(X.shape[:-2], C.shape[:-2], "kmeans_assign_update")
    wb = False
    if w is not None:
        batch, _, wb = batch_shape(batch, w.shape[:-1], "kmeans_assign_update")
    B = math.prod(batch)
    assign = torch.empty(batch + (n,), dtype=torch.int32, device=dev)
    d2 = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    out = torch.zeros if n == 0 or B == 0 else torch.empty
    csum = out(batch + (k, d), dtype=torch.float32, device=dev)
    wsum = out(batch + (k,), dtype=torch.float32, device=dev)
    ccost = out(batch + (k,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return assign, d2, csum, wsum, ccost
    rows_per_cta, P = row_split(n)
    part = torch.empty((B, P, k * d + 2 * k), dtype=torch.float32, device=dev)
    Xc = X.to(torch.float32).contiguous()
    Cc = C.to(torch.float32).contiguous()
    wc = None if w is None else w.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_kmeans_assign_update(
            Xc.data_ptr(), Cc.data_ptr(), None if wc is None else wc.data_ptr(),
            assign.data_ptr(), d2.data_ptr(), part.data_ptr(), csum.data_ptr(),
            wsum.data_ptr(), ccost.data_ptr(), B, n, d, k, rows, rows_per_cta,
            n * d if xb else 0, k * d if cb else 0, n if wb else 0, stream)
    check(code, "kmeans_assign_update")
    kmeans_assign_update.launches += 1
    return assign, d2, csum, wsum, ccost


kmeans_assign_update.launches = 0
