"""k-means assignment (nearest center and its squared distance) — the
O(nkd) sweep of ``kmeans_cost``, as a hand-written CUDA kernel
(``csrc/kmeans_assign.cu``).

Port of :mod:`repro.kernels.kmeans_assign`.  :func:`kmeans_assign`
launches the kernel for CUDA tensors and takes the plain PyTorch version
(:data:`plain`) for CPU tensors; there is no fallback on the card.
``kmeans_assign.launches`` counts kernel launches.

The kernel follows the Pallas kernel: the argmin of the unclamped
expanded distance, then the minimum clamped at 0.  The plain version
follows ``repro.kernels.ref``, which clamps first; the two differ only
where a row has a negative expanded distance to two or more centers.

The fast kernel runs persistent CTAs of 128 threads, as many per batch
entry as the card holds at once over the entries (the launcher asks CUDA's
occupancy calculator), each walking its entry's row tiles.  C and ||c||^2
are staged once per CTA; the rows move through one buffer of up to 128
rows (:func:`assign_layout`), copied with 16-byte ``cp.async`` where d is
not a multiple of 4.  Each thread scans two rows at once, and runs of
threads split a row's 8-center blocks, combined in center order.  Every
row's result is the global variant's bit for bit: that variant reads C
and the rows from global memory, runs where no layout fits
(:func:`assign_layout` gives ``GLOBAL``), and is the oracle the card's
checks hold the fast kernel to (:func:`_launch` with
``global_variant=True``).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, PLAIN_DEVICES, batch_shape, check,
                                       launch_device, library)

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.kmeans_assign
#: Tile heights of the k-means kernels' shared-memory layouts, tallest
#: first.
TILE_ROWS = (128, 64, 32)


def _padded_k(k: int) -> int:
    return -(-k // 8) * 8


def common_bytes(k: int, d: int, rows: int) -> int:
    """Bytes of the one-tile layout the k-means kernels started from: C
    transposed at k rounded up to 8 columns, ||c||^2, and a tile of
    ``rows`` rows at an odd row stride.  Each kernel's own layout fits
    wherever this one does at 32 rows; K2's planner extends it
    (:func:`repro_torch.kernels.kmeans_assign_update.smem_bytes`)."""
    kp = _padded_k(k)
    return 4 * (d * kp + kp + rows * (d | 1))


#: ``tile_rows``'s answer when no tile fits: the kernel's global variant,
#: which reads C and the rows through the caches, runs instead.
GLOBAL = 0


def tile_rows(k: int, d: int, smem=common_bytes) -> int:
    """The tallest of :data:`TILE_ROWS` whose layout ``smem(k, d, rows)``
    fits in a block's shared memory, or :data:`GLOBAL` when even the
    shortest does not."""
    for rows in TILE_ROWS:
        if smem(k, d, rows) <= MAX_SMEM_BYTES:
            return rows
    return GLOBAL


#: Tile heights of the fast kernel, tallest first: down to 8 rows, each
#: even with half of it dividing the CTA's 128 threads (two rows a thread).
#: At 8 rows its layout fits wherever :func:`common_bytes` does at 32.
ASSIGN_TILE_ROWS = TILE_ROWS + (16, 8)


def assign_bytes(k: int, d: int, rows: int) -> int:
    """Bytes of the fast kernel's layout: C transposed at k rounded up to 8
    columns, ||c||^2, the runs' per-row (min, argmin), and one tile buffer
    of ``rows`` rows at the odd stride ``d | 1`` with 4 floats of slack for
    the 16-byte alignment of its copies, in whole 16-byte units."""
    kp = _padded_k(k)
    buffer = -(-(rows * (d | 1) + 4) // 4) * 4
    return 4 * (d * kp + kp + 2 * rows + buffer)


@functools.lru_cache(maxsize=None)
def assign_layout(k: int, d: int) -> int:
    """Tile rows of the fast kernel at (k, d): the tallest of
    :data:`ASSIGN_TILE_ROWS` whose layout fits in a block's shared memory,
    where the earlier one-tile kernel's layout fitted (:func:`tile_rows`);
    elsewhere :data:`GLOBAL`, and the global variant runs.  Short tiles fit
    past that line too, but there few of the CTA's threads have rows: at
    (10, 2048), 8-row tiles keep 8 of 128 busy, and the fast kernel took
    1.4 times the global variant's time on an H100 (``chip_smoke.py``)."""
    if tile_rows(k, d) == GLOBAL:
        return GLOBAL
    for rows in ASSIGN_TILE_ROWS:
        if assign_bytes(k, d, rows) <= MAX_SMEM_BYTES:
            return rows
    return GLOBAL   # unreachable: 8 rows fit where tile_rows found 32


def check_shapes(what: str, X: torch.Tensor, C: torch.Tensor):
    """(n, d, k) of X (..., n, d) and C (..., k, d); raises ``ValueError``
    on shapes the kernels do not take."""
    if X.ndim < 2 or C.ndim < 2:
        raise ValueError(f"{what} takes X (..., n, d), C (..., k, d); got "
                         f"{tuple(X.shape)}, {tuple(C.shape)}")
    n, d = X.shape[-2:]
    k = C.shape[-2]
    if C.shape[-1] != d:
        raise ValueError(f"C has width {C.shape[-1]}, X has {d}")
    if d < 1 or k < 1:
        raise ValueError(f"{what} needs d >= 1 and k >= 1, got d={d}, k={k}")
    return n, d, k


def kmeans_assign(X: torch.Tensor, C: torch.Tensor):
    """X: (..., n, d); C: (..., k, d) -> (assign int32 (..., n), d2 float32
    (..., n)).

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared); they fold into the launch grid."""
    dev = launch_device(X, C)
    if dev.type in PLAIN_DEVICES:
        return plain(X, C)
    return _launch(X, C)


def _launch(X: torch.Tensor, C: torch.Tensor, global_variant: bool = False):
    """The launch on the card: the fast kernel in the layout
    :func:`assign_layout` gives, or with ``global_variant`` the global
    variant (the bit oracle of the card's checks; not a user's switch)."""
    dev = launch_device(X, C)
    n, d, k = check_shapes("kmeans_assign", X, C)
    rows = GLOBAL if global_variant else assign_layout(k, d)
    batch, xb, cb = batch_shape(X.shape[:-2], C.shape[:-2], "kmeans_assign")
    B = math.prod(batch)
    assign = torch.empty(batch + (n,), dtype=torch.int32, device=dev)
    d2 = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return assign, d2
    Xc = X.to(torch.float32).contiguous()
    Cc = C.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_kmeans_assign(
            Xc.data_ptr(), Cc.data_ptr(), assign.data_ptr(), d2.data_ptr(),
            B, n, d, k, rows, n * d if xb else 0, k * d if cb else 0, stream)
    check(code, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, d2


kmeans_assign.launches = 0
