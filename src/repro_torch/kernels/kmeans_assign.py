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

A user's call takes one of two routes (:func:`route_for`), and a third
kernel runs on no user's call:

- ``fast`` where :func:`assign_layout` fits C and a row tile in half of a
  block's shared memory (:data:`FAST_LAYOUT_LIMIT`): persistent CTAs of
  128 threads, as many per batch entry as the card holds at once over the
  entries (the launcher asks CUDA's occupancy calculator), each walking
  its entry's row tiles.  C and ||c||^2 are staged once per CTA; the rows
  move through one buffer of up to 128 rows, copied with 16-byte
  ``cp.async`` where d is not a multiple of 4.  Each thread scans two rows
  at once, and runs of threads split a row's 8-center blocks, combined in
  center order.
- ``tiled`` where the layout takes more, or none fits (``GLOBAL``): the
  tiled fp32 product X Cᵀ that K2's general route runs too
  (``csrc/kmeans_tiled.cuh``), over row tiles x center groups
  (:func:`tiled_plan`), each row's (minimum, index) kept in center order;
  with more than one group a second kernel combines the groups in group
  order and clamps.
- ``oracle``: the global variant, which reads C and the rows from global
  memory, one row a thread.  The card's checks hold both routes to it bit
  for bit (:func:`_launch` with ``global_variant=True``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

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
    elsewhere :data:`GLOBAL`, and a user's call takes the tiled route.
    Short tiles fit past that line too, but there few of the CTA's threads
    have rows: at (10, 2048), 8-row tiles keep 8 of 128 busy, and the fast
    kernel took 1.4 times the one-row-a-thread global variant's time on an
    H100 (``chip_smoke.py``)."""
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


#: The kernel a call launches on each route (csrc/kmeans_assign.cu); the
#: tiled route's combine (``kmeans_assign_combine_kernel``) follows its
#: assign where the plan has more than one center group.
ROUTES = {"fast": "kmeans_assign_fast_kernel", "tiled": "kmeans_assign_tiled_kernel",
          "oracle": "kmeans_assign_global_kernel"}


#: Bytes of the fast kernel's layout past which a user's call takes the
#: tiled route though the layout fits: half of a block's shared memory, so
#: that the fast kernel would hold one CTA an SM.
FAST_LAYOUT_LIMIT = MAX_SMEM_BYTES // 2


def route_for(k: int, d: int) -> str:
    """The route a user's call takes at (k, d): ``fast`` where
    :func:`assign_layout` fits in FAST_LAYOUT_LIMIT bytes, else ``tiled``
    (:data:`GLOBAL` included).  Both give the same bits.  Past that limit
    the fast kernel's one CTA an SM keeps too few warps busy, and the tiled
    route was the faster at every such shape ``chip_smoke.py`` times on an
    H100 (its ``near_layout_line``); under it the fast kernel was the faster
    at most, though not at (64, 90), (128, 90) or (256, 64) (PERF.md §6)."""
    rows = assign_layout(k, d)
    return "fast" if rows != GLOBAL and assign_bytes(k, d, rows) <= FAST_LAYOUT_LIMIT else "tiled"


# ---- the tiled assign (csrc/kmeans_tiled.cuh): K4's tiled route and K2's
# general route ------------------------------------------------------------

#: Thread columns of a tiled assign's CTA (csrc's TX), each 8 centers of a
#: center tile; a CTA of 256 threads is TX columns of 256 / TX rows.
GEN_THREAD_COLS = (1, 2, 4, 8)
#: Threads of the tiled assign's CTA: K2's always, K4's where its grid fills;
#: K4's CTA halves down to MIN_GEN_THREADS where its grid has fewer than
#: TILED_MIN_CTAS CTAs (four per SM of an H100).
GEN_THREADS = 256
MIN_GEN_THREADS = 64
TILED_MIN_CTAS = 528
#: CTAs the tiled assign's grid aims for (eight for each of K2's row-split
#: ranges): where the row tiles of all entries fall short, the center tiles
#: split into groups, each a CTA's.
ASSIGN_TARGET_CTAS = 2112


def gen_rows(tx: int, threads: int = GEN_THREADS) -> int:
    """Rows of the tiled assign's tile for a CTA of ``threads`` threads
    (csrc's tiled_rows): 256 at TX = 1, else 128, at 256 threads."""
    return (256 if tx == 1 else 128) * threads // GEN_THREADS


def gen_kc(rows: int, centers: int, d: int) -> int:
    """Columns of the tiled assign's chunk: 64 where the tile has at most 200
    rows and centers (so two CTAs' rings of two fit an SM) and 64-column
    chunks pad d no further than 32-column ones, else 32.  Past d the chunk
    is zeros, which the product still multiplies: at d = 90, 96 columns
    rather than 128."""
    return 64 if rows + centers <= 200 and -(-d // 64) * 64 == -(-d // 32) * 32 else 32


class AssignTiles(NamedTuple):
    """A tiled assign's grid at (B, n, k, d): thread columns ``tx``, a tile
    of ``tile_rows`` rows x ``tile_centers`` centers, a chunk of ``kc``
    columns, ``vec`` floats a copy, ``groups`` center groups of
    ``tiles_per_group`` center tiles, and the CTA's ``threads`` (K2's
    always GEN_THREADS)."""
    tx: int
    tile_rows: int
    tile_centers: int
    kc: int
    vec: int
    groups: int
    tiles_per_group: int
    threads: int


def assign_tiles(B: int, n: int, k: int, d: int, align: int = 16,
                 threads: int = GEN_THREADS) -> AssignTiles:
    """The tiled assign's grid, a function of the shapes, of ``align`` (the
    bytes that both X's and C's first addresses are a multiple of) and of
    the CTA's ``threads``.

    The center tile is k rounded up to 8 where that is at most 64 (the
    narrowest power-of-two count of thread columns that covers it), else 64
    centers.  Copies are 16 bytes where d % 4 == 0 and ``align`` allows,
    else 8 where d is even, else 4.  The center tiles split into groups of
    as many tiles as still bring the grid to ASSIGN_TARGET_CTAS."""
    if min(B, n, k, d) < 1:
        raise ValueError(f"the tiled assign needs B, n, k, d >= 1; got {B}, {n}, {k}, {d}")
    kp = _padded_k(k)
    tx = next((t for t in GEN_THREAD_COLS if 8 * t >= kp), GEN_THREAD_COLS[-1])
    rows, centers = gen_rows(tx, threads), 8 * tx
    nct = -(-k // centers)
    groups = min(nct, -(-ASSIGN_TARGET_CTAS // (-(-n // rows) * B)))
    # the most tiles a group with which ceil(nct / per) >= groups
    per = nct if groups == 1 else -(-nct // (groups - 1)) - 1
    return AssignTiles(tx=tx, tile_rows=rows, tile_centers=centers,
                       kc=gen_kc(rows, centers, d),
                       vec=next(v for v in (4, 2, 1) if d % v == 0 and align % (4 * v) == 0),
                       groups=-(-nct // per), tiles_per_group=per, threads=threads)


@functools.lru_cache(maxsize=1024)
def tiled_plan(B: int, n: int, k: int, d: int, align: int = 16) -> AssignTiles:
    """K4's tiled route: K2's assign tiles (:func:`assign_tiles` at 256
    threads), except where their grid, even with a group per center tile,
    has fewer than TILED_MIN_CTAS CTAs: there the tile and the CTA halve,
    down to MIN_GEN_THREADS and never below a tile of as many rows as
    centers, while the grid stays short.  More, shorter tiles spread the
    rows more evenly over the SMs: at (20001, 2048) x (10, 2048) 157 CTAs of
    128 rows leave 25 of an H100's 132 SMs two tiles each.  Cached: a launch
    pays for the plan once a shape."""
    threads = GEN_THREADS
    while True:
        tiles = assign_tiles(B, n, k, d, align, threads)
        nct = -(-k // tiles.tile_centers)
        short = -(-n // tiles.tile_rows) * nct * B < TILED_MIN_CTAS
        if not (short and threads > MIN_GEN_THREADS
                and gen_rows(tiles.tx, threads // 2) >= tiles.tile_centers):
            return tiles
        threads //= 2


def kmeans_assign(X: torch.Tensor, C: torch.Tensor):
    """X: (..., n, d); C: (..., k, d) -> (assign int32 (..., n), d2 float32
    (..., n)).

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared); they fold into the launch grid."""
    dev = launch_device(X, C)
    if dev.type in PLAIN_DEVICES:
        return plain(X, C)
    return _launch(X, C)


def _launch(X: torch.Tensor, C: torch.Tensor, global_variant: bool = False,
            route: Optional[str] = None):
    """The launch on the card, on ``route`` (one of :data:`ROUTES`; by
    default :func:`route_for`'s).  ``global_variant`` is ``route="oracle"``,
    the bit oracle of the card's checks.  Neither is a user's switch;
    ``fast`` raises where its layout does not fit."""
    dev = launch_device(X, C)
    n, d, k = check_shapes("kmeans_assign", X, C)
    route = "oracle" if global_variant else (route or route_for(k, d))
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got {route!r}")
    rows = assign_layout(k, d) if route == "fast" else GLOBAL
    if route == "fast" and rows == GLOBAL:
        raise ValueError(f"the fast kernel has no layout at (k, d) = ({k}, {d})")
    batch, xb, cb = batch_shape(X.shape[:-2], C.shape[:-2], "kmeans_assign")
    B = math.prod(batch)
    assign = torch.empty(batch + (n,), dtype=torch.int32, device=dev)
    d2 = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return assign, d2
    Xc = X.to(torch.float32).contiguous()
    Cc = C.to(torch.float32).contiguous()
    strides = (n * d if xb else 0, k * d if cb else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tiled":
            plan = tiled_plan(B, n, k, d, align=math.gcd(Xc.data_ptr(), Cc.data_ptr(), 16))
            pv = pa = None   # the groups' minima, where there is more than one
            if plan.groups > 1:
                pv = torch.empty((B, plan.groups, n), dtype=torch.float32, device=dev)
                pa = torch.empty((B, plan.groups, n), dtype=torch.int32, device=dev)
            code = library().repro_kmeans_assign_tiled(
                Xc.data_ptr(), Cc.data_ptr(), assign.data_ptr(), d2.data_ptr(),
                None if pv is None else pv.data_ptr(), None if pa is None else pa.data_ptr(),
                B, n, d, k, plan.tx, plan.tile_rows, plan.kc, plan.groups,
                plan.tiles_per_group, plan.vec, *strides, stream)
        else:
            code = library().repro_kmeans_assign(
                Xc.data_ptr(), Cc.data_ptr(), assign.data_ptr(), d2.data_ptr(),
                B, n, d, k, rows, *strides, stream)
    check(code, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, d2


kmeans_assign.launches = 0
