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

Stage 1 has two routes (:func:`route_for`), and a third stage-1 kernel
that no user's call runs:

- ``fast`` where :func:`layout` fits C, the partial sums and a row tile in
  shared memory: 256 threads per CTA, the range's rows in tiles of up to
  128 through a ring of two buffers where two fit.  Up to eight threads
  share a row's distances, split by center blocks, combined in center
  order; each tile is folded into the sums by warp tasks (one cluster, up
  to 128 columns each): a ballot per 32 rows finds the cluster's rows, and
  each lane adds them in row order.
- ``general`` where it gives ``GLOBAL``: an fp32 product X Cᵀ tiled over
  its own grid (row tiles x center groups x B), each row's (minimum,
  index) kept in center order, then a fold over the row split that sorts
  each tile's rows by cluster and gives each (cluster, column) entry to
  one thread, which takes the cluster's rows in row order
  (:func:`general_plan` gives the tiles).
- ``oracle``: the kernel's first general variant, which reads C and the
  rows from global memory, one row a thread, and rescans each tile for
  every entry.  The card's checks hold both routes to it bit for bit
  (:func:`_launch` with ``global_variant=True``).

Every entry is the same fmaf chain over the same rows in all three, and
stage 2 sums the partials in the same order.

Like :mod:`repro_torch.kernels.kmeans_assign`, the kernel takes the
argmin of the unclamped distance and clamps the minimum (the Pallas
kernel's order); the plain version clamps first (``repro.kernels.ref``'s).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, PLAIN_DEVICES, batch_shape, check,
                                       launch_device, library)
from repro_torch.kernels.kmeans_assign import (  # noqa: F401  (re-exported)
    ASSIGN_TARGET_CTAS, GLOBAL, TILE_ROWS, _padded_k, assign_tiles, check_shapes, tile_rows)

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


#: Stage 1's kernel on each route (csrc/kmeans_assign_update.cu); the
#: general route's fold kernel follows its assign kernel.
ROUTES = {"fast": "kau_partial_kernel", "general": "kau_assign_kernel",
          "oracle": "kau_partial_global_kernel"}


def route_for(k: int, d: int) -> str:
    """The route a user's call takes at (k, d): ``fast`` where
    :func:`layout` fits, else ``general``."""
    return "general" if layout(k, d)[0] == GLOBAL else "fast"


# The general route's assign is the tiled assign of kernels/kmeans_assign.py
# (csrc/kmeans_tiled.cuh) at 256 threads, its grid aiming for
# ASSIGN_TARGET_CTAS: eight CTAs for each of TARGET_CTAS ranges.
#: Rows of a fold tile (one sort key per thread), and the column chunks of
#: X it stages, widest first.
FOLD_ROWS = 256
FOLD_COLS = (64, 32)


class GeneralPlan(NamedTuple):
    """The general route's tiles at (B, n, k, d): the assign's thread
    columns ``tx``, its tile of ``tile_rows`` rows x ``tile_centers``
    centers, its chunk of ``kc`` columns, ``vec`` floats a copy (both
    stages), ``groups`` center groups of ``tiles_per_group`` center tiles; the
    fold's chunk of ``fold_cols`` columns, and whether its partial sums
    stay in shared memory."""
    tx: int
    tile_rows: int
    tile_centers: int
    kc: int
    vec: int
    groups: int
    tiles_per_group: int
    fold_cols: int
    acc_in_smem: bool


def fold_bytes(fc: int, k: int, d: int, acc_in_smem: bool) -> int:
    """Bytes of the fold's layout (csrc's kau_fold_floats): two chunks of
    FOLD_ROWS rows at the stride fc + 4, the sort keys (8 bytes a row), the
    rows' w and d2, the segments, 32 warp counts, and the k d + 2 k sums
    when they stay in shared memory."""
    return 4 * (2 * FOLD_ROWS * (fc + 4) + 4 * FOLD_ROWS + 2 * (FOLD_ROWS + 1) + 32
                + ((k * d + 2 * k) if acc_in_smem else 0))


def general_plan(B: int, n: int, k: int, d: int, align: int = 16) -> GeneralPlan:
    """The general route's plan, a function of the shapes and of ``align``,
    the bytes that both X's and C's first addresses are a multiple of.

    The assign's fields are :func:`assign_tiles`' at 256 threads (the
    center tile k rounded up to 8 up to 64 centers, copies as wide as d and
    ``align`` allow, the center tiles in groups that bring the grid to
    ASSIGN_TARGET_CTAS).  The fold stages the widest of FOLD_COLS (at most d
    rounded up to a power of two, at least 4) with which its partial sums
    fit in shared memory, else the widest with the sums in the scratch."""
    if min(B, n, k, d) < 1:
        raise ValueError(f"kmeans_assign_update's general route needs B, n, k, d >= 1; "
                         f"got {B}, {n}, {k}, {d}")
    tiles = assign_tiles(B, n, k, d, align)
    dpow = 1 << max(2, (d - 1).bit_length())   # d's power of two, at least 4
    fcs = [min(fc, dpow) for fc in FOLD_COLS]
    fits = [fc for fc in fcs if fold_bytes(fc, k, d, True) <= MAX_SMEM_BYTES]
    # all of the tiles but their threads: K2's CTA is always GEN_THREADS
    return GeneralPlan(*tiles[:-1], fold_cols=(fits or fcs)[0], acc_in_smem=bool(fits))


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
            global_variant: bool = False, route: Optional[str] = None):
    """The launch on the card: stage 1 on ``route`` (one of :data:`ROUTES`;
    by default :func:`route_for`'s), then stage 2.  ``global_variant`` is
    ``route="oracle"``, the bit oracle of the card's checks.  Neither is a
    user's switch; ``fast`` raises where its layout does not fit."""
    dev = launch_device(X, C) if w is None else launch_device(X, C, w)
    n, d, k = check_shapes("kmeans_assign_update", X, C)
    if w is not None and (w.ndim < 1 or w.shape[-1] != n):
        raise ValueError(f"w must be (..., {n}) to match X, got {tuple(w.shape)}")
    route = "oracle" if global_variant else (route or route_for(k, d))
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got {route!r}")
    rows, depth = layout(k, d) if route == "fast" else (GLOBAL, 0)
    if route == "fast" and rows == GLOBAL:
        raise ValueError(f"the fast stage 1 has no layout at (k, d) = ({k}, {d})")
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
    ptrs = (Xc.data_ptr(), Cc.data_ptr(), None if wc is None else wc.data_ptr(),
            assign.data_ptr(), d2.data_ptr())
    strides = (rows_per_cta, n * d if xb else 0, k * d if cb else 0, n if wb else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "general":
            plan = general_plan(B, n, k, d, align=math.gcd(ptrs[0], ptrs[1], 16))
            # the groups' minima: d2 and assign themselves when there is one
            pv, pa = d2, assign
            if plan.groups > 1:
                pv = torch.empty((B, plan.groups, n), dtype=torch.float32, device=dev)
                pa = torch.empty((B, plan.groups, n), dtype=torch.int32, device=dev)
            code = library().repro_kmeans_assign_update_general(
                *ptrs, pv.data_ptr(), pa.data_ptr(), part.data_ptr(), csum.data_ptr(),
                wsum.data_ptr(), ccost.data_ptr(), B, n, d, k, plan.tx, plan.kc,
                plan.groups, plan.tiles_per_group, plan.fold_cols, plan.vec,
                int(plan.acc_in_smem), *strides, stream)
        else:
            code = library().repro_kmeans_assign_update(
                *ptrs, part.data_ptr(), csum.data_ptr(), wsum.data_ptr(),
                ccost.data_ptr(), B, n, d, k, rows, depth, *strides, stream)
    check(code, "kmeans_assign_update")
    kmeans_assign_update.launches += 1
    return assign, d2, csum, wsum, ccost


kmeans_assign_update.launches = 0
