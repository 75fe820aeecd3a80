"""Fused k-means assign + cluster update — one Lloyd iteration's read of
X, and Algorithm 3's cluster sizes and costs — as a hand-written CUDA
kernel (``csrc/kmeans_assign_update.cu``).

Port of :mod:`repro.kernels.kmeans_assign_update`.  The per-cluster sums
are a deterministic two-stage reduction: fixed contiguous row ranges per
CTA (:func:`row_split`), each reduced in row order, then an in-order sum
of the partials — no float atomics, so two launches on the same input
give the same bits.  :func:`kmeans_assign_update` launches the kernel for
CUDA tensors and takes the plain PyTorch version (:data:`plain`) for CPU
tensors.  ``kmeans_assign_update.launches`` counts kernel launches.

Stage 1 runs 256 threads per CTA.  Its range moves through shared memory
in tiles of up to 128 rows, in a ring of two buffers where two fit
(:func:`layout`), so one tile's copy overlaps the last one's work.  Up
to eight threads share a row's distances, split by center blocks, and
their results are combined in center order.  Each tile is then folded
into the sums by warp tasks (one cluster, up to 128 columns each): a
ballot per 32 rows finds the cluster's rows, and each lane adds them in
row order.  Every entry is the same fmaf chain over the same rows as in
the kernel's global variant, which reads its operands from global
memory.  That variant runs where no layout fits (:func:`layout` gives
``GLOBAL``), and it is the oracle the card's checks hold the fast stage
to, bit for bit (:func:`_launch` with ``global_variant=True``).

Like :mod:`repro_torch.kernels.kmeans_assign`, the kernel takes the
argmin of the unclamped distance and clamps the minimum (the Pallas
kernel's order); the plain version clamps first (``repro.kernels.ref``'s).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, PLAIN_DEVICES, batch_shape, check,
                                       launch_device, library)
from repro_torch.kernels.kmeans_assign import (  # noqa: F401  (tile_rows is re-exported)
    GLOBAL, TILE_ROWS, _padded_k, check_shapes, tile_rows)

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


#: Tile buffers of stage 1's ring, most first: two where they fit, so the
#: next tile's copy overlaps this one's work.
RING_DEPTHS = (2, 1)


def smem_bytes(k: int, d: int, rows: int, depth: int = 1) -> int:
    """Bytes of the stage-1 layout: C transposed at k rounded up to 8
    columns, ||c||^2, the (k d + 2 k) partial sums, the tile's assignments,
    and ``depth`` tiles of ``rows`` staged rows (x, w and d2 at the odd
    stride ``(d + 2) | 1``)."""
    kp = _padded_k(k)
    return 4 * (d * kp + kp + k * d + 2 * k + rows + depth * rows * ((d + 2) | 1))


def layout(k: int, d: int):
    """(tile rows, ring depth) of stage 1 at (k, d): the deepest ring, then
    the tallest tile, that fits in a block's shared memory; ``(GLOBAL, 0)``
    when none does."""
    for depth in RING_DEPTHS:
        for rows in TILE_ROWS:
            if smem_bytes(k, d, rows, depth) <= MAX_SMEM_BYTES:
                return rows, depth
    return GLOBAL, 0


def kmeans_assign_update(X: torch.Tensor, C: torch.Tensor,
                         w: Optional[torch.Tensor] = None):
    """X: (..., n, d); C: (..., k, d); w: optional (..., n) weights
    (default ones) -> (assign int32 (..., n), d2 f32 (..., n), csum f32
    (..., k, d), wsum f32 (..., k), ccost f32 (..., k)).

    X, C and w may each carry the leading batch dims or not, independently
    (an operand without them is shared); the batch folds into the grid."""
    dev = launch_device(X, C) if w is None else launch_device(X, C, w)
    if dev.type in PLAIN_DEVICES:
        return plain(X, C, w)
    return _launch(X, C, w)


def _launch(X: torch.Tensor, C: torch.Tensor, w: Optional[torch.Tensor] = None,
            global_variant: bool = False):
    """The launch on the card: stage 1 in the layout :func:`layout` gives,
    or with ``global_variant`` its global variant (the bit oracle of the
    card's checks; not a user's switch), then stage 2."""
    dev = launch_device(X, C) if w is None else launch_device(X, C, w)
    n, d, k = check_shapes("kmeans_assign_update", X, C)
    if w is not None and (w.ndim < 1 or w.shape[-1] != n):
        raise ValueError(f"w must be (..., {n}) to match X, got {tuple(w.shape)}")
    rows, depth = (GLOBAL, 0) if global_variant else layout(k, d)
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
            wsum.data_ptr(), ccost.data_ptr(), B, n, d, k, rows, depth,
            rows_per_cta, n * d if xb else 0, k * d if cb else 0, n if wb else 0,
            stream)
    check(code, "kmeans_assign_update")
    kmeans_assign_update.launches += 1
    return assign, d2, csum, wsum, ccost


kmeans_assign_update.launches = 0
