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

Where the centers do not fit in shared memory beside a row tile
(:func:`tile_rows`), the wrapper launches the kernel's global variant.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, batch_shape, check,
                                       launch_device, library)

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.kmeans_assign
#: Tile heights tried, largest first (one row per thread of a 128-thread CTA).
TILE_ROWS = (128, 64, 32)


def _padded_k(k: int) -> int:
    return -(-k // 8) * 8


def common_bytes(k: int, d: int, rows: int) -> int:
    """Bytes of the layout both k-means kernels share
    (``kmeans_common.cuh``): C transposed at k rounded up to 8 columns,
    ||c||^2, and a tile of ``rows`` rows at an odd row stride."""
    kp = _padded_k(k)
    return 4 * (d * kp + kp + rows * (d | 1))


#: ``tile_rows``'s answer when no tile fits: the kernel's global variant,
#: which reads C and the rows through the caches, runs instead.
GLOBAL = 0


def tile_rows(k: int, d: int, smem=common_bytes) -> int:
    """Which variant of a k-means kernel runs at (k, d): the tallest tile
    whose layout fits in a block's shared memory, or :data:`GLOBAL` when
    even the shortest does not.  Both variants give the same bits."""
    for rows in TILE_ROWS:
        if smem(k, d, rows) <= MAX_SMEM_BYTES:
            return rows
    return GLOBAL


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
    if dev.type == "cpu":
        return plain(X, C)
    n, d, k = check_shapes("kmeans_assign", X, C)
    rows = tile_rows(k, d)
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
