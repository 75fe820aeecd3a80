"""Row-wise quadratic form lev_i = x_i^T M x_i — Algorithm 2's leverage
sweep, as a hand-written CUDA kernel (``csrc/leverage.cu``).

Port of :mod:`repro.kernels.leverage`.  :func:`leverage` launches the
kernel for CUDA tensors and takes the plain PyTorch version
(:data:`plain`) for CPU tensors; there is no fallback on the card.
``leverage.launches`` counts calls that launched (one a call, whatever
the number of CUDA launches behind it).

Four kernels compute the same function with the same arithmetic in the
same order (``csrc/leverage.cu``'s bit contract); :func:`kernel_for`
names the one a width takes:

- s up to 32 and not a multiple of 8 (the main path's parties, s = 31):
  persistent CTAs, as many per party as the card holds at once over the
  parties (the launcher asks CUDA's occupancy calculator), each staging M
  once and walking its party's tiles of 256 rows through a ring of two,
  copied with 16-byte ``cp.async``; every thread keeps the sums of M x
  for two rows in registers;
- other s up to :data:`SHARED_M_WIDTH`: M whole in shared memory, one CTA
  per 128-row tile;
- wider: the tiled kernel.  It writes T = X Mᵀ, each entry one fmaf chain
  over ascending b, into a scratch of :func:`tiled_plan`'s size (64 x 64
  tiles of T a CTA, slices of 32 b through shared memory, an 8 x 4 register
  tile a thread), then a fold kernel takes each row's chain of x_a t_a over
  ascending a.  The pair runs over row chunks and batch groups, so the
  scratch never exceeds :data:`TILED_SCRATCH_FLOATS`.  Its bound is the fp32 rate
  outside the tensor cores (67 TFLOP/s; 2 n s² FLOP: 32 us at (256, 2048),
  157 us at (20001, 512)); TF32 would round x and M and break the bits;
- the wide kernel, which reads M through the caches at any s, one row a
  thread.  It is the oracle the card's checks hold the other three to, bit
  for bit (:func:`_launch` with ``wide=True``), and no user's call runs it:
  the simplest of the four, it shares no tiling or staging with them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, PLAIN_DEVICES, batch_shape, check,
                                       launch_device, library)

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.leverage

#: Widest party whose (s, s) fp32 M the shared-memory kernels keep whole in
#: a block's 227 KB (238^2 * 4 = 226,576 bytes).  Wider parties take the
#: tiled kernel.
SHARED_M_WIDTH = 238
#: Widest party the register kernel takes (and only where s % 8 != 0).
REG_MAX_WIDTH = 32
#: Shared memory the wide kernel's X tile may take (the static 48 KB, no
#: opt-in).
WIDE_TILE_BYTES = 48 * 1024
#: Most floats of the tiled kernel's scratch T (2^24: 64 MB).
TILED_SCRATCH_FLOATS = 1 << 24
#: The tiled kernel's CTA tile of T, rows x a-values (csrc/leverage.cu's
#: kTileRows, kTileCols).
TILE_ROWS, TILE_COLS = 64, 64
#: Most CTAs along a launch grid's y and z.
MAX_GRID_YZ = 65535


def wide_rows(s: int) -> int:
    """Tile height of the wide kernel (the oracle): as many rows (up to 128,
    one per thread) as fit in WIDE_TILE_BYTES at the odd row stride, at
    least one; raises ``ValueError`` when one row of X does not fit in
    shared memory (s above 58,104, where M alone is 13.5 GB)."""
    row_bytes = 4 * (-(-s // 8) * 8 + 1)
    if row_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"leverage stages whole rows of X in shared memory; "
                         f"a row of s={s} takes {row_bytes} bytes")
    return max(1, min(128, WIDE_TILE_BYTES // row_bytes))


def kernel_for(s: int, wide: bool = False) -> str:
    """The ``__global__`` kernel that a launch at width ``s`` runs first
    (the tiled one is followed by ``leverage_fold_kernel``); with ``wide``
    the oracle."""
    if s < 1:
        raise ValueError(f"leverage needs a width s >= 1, got {s}")
    if wide:
        return "leverage_wide_kernel"
    if s > SHARED_M_WIDTH:
        return "leverage_tiled_kernel"
    if s <= REG_MAX_WIDTH and s % 8:
        return "leverage_reg_kernel"
    return "leverage_kernel"


class TiledPlan(NamedTuple):
    """How the tiled kernel covers (B, n, s): ``batches`` batch entries and
    ``chunk_rows`` rows a chunk, the scratch's floats, and the number of
    chunks (each one product and one fold launch); the C entry sizes each
    launch's grid from them."""
    sp: int
    chunk_rows: int
    batches: int
    scratch_floats: int
    chunks: int


def tiled_plan(B: int, n: int, s: int) -> TiledPlan:
    """The tiled kernel's plan, a function of the shapes alone: as many
    batch entries a chunk as the grid and the scratch take, then as many
    rows as fit in :data:`TILED_SCRATCH_FLOATS` beside them (whole 64-row
    tiles where the rows are cut)."""
    if B < 1 or n < 1 or s < 1:
        raise ValueError(f"leverage's tiled kernel needs B, n, s >= 1; got {B}, {n}, {s}")
    sp = -(-s // 8) * 8
    if -(-sp // TILE_COLS) > MAX_GRID_YZ:   # so a row of T fits in the scratch
        raise ValueError(f"leverage's tiled kernel takes s up to "
                         f"{MAX_GRID_YZ * TILE_COLS} ({MAX_GRID_YZ} grid rows of "
                         f"{TILE_COLS} a-values); got s={s}")
    batches = min(B, MAX_GRID_YZ, TILED_SCRATCH_FLOATS // sp)
    rows = min(n, TILED_SCRATCH_FLOATS // (batches * sp))
    if rows < n and rows > TILE_ROWS:
        rows -= rows % TILE_ROWS
    return TiledPlan(sp=sp, chunk_rows=rows, batches=batches,
                     scratch_floats=batches * rows * sp,
                     chunks=-(-n // rows) * -(-B // batches))


def leverage(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """X: (..., n, s); M: (..., s, s) -> (..., n) float32 quadratic forms.

    Either operand may carry leading batch dims (equal on both, or absent
    on one, which is then shared); the party axis of stacked scoring folds
    into the launch grid."""
    dev = launch_device(X, M)
    if dev.type in PLAIN_DEVICES:
        return plain(X, M)
    return _launch(X, M)


def _launch(X: torch.Tensor, M: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """The launch on the card: the kernel for s (:func:`kernel_for`), or
    with ``wide`` the wide kernel at any s (the bit oracle of the card's
    checks; not a user's switch)."""
    dev = launch_device(X, M)
    if X.ndim < 2 or M.ndim < 2:
        raise ValueError(f"leverage takes X (..., n, s), M (..., s, s); got "
                         f"{tuple(X.shape)}, {tuple(M.shape)}")
    n, s = X.shape[-2:]
    if M.shape[-2:] != (s, s):
        raise ValueError(f"M must be ({s}, {s}) to match X, got {tuple(M.shape)}")
    rows = wide_rows(s) if wide else 0
    batch, xb, mb = batch_shape(X.shape[:-2], M.shape[:-2], "leverage")
    B = math.prod(batch)
    out = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return out
    kernel = kernel_for(s, wide)
    plan = tiled_plan(B, n, s) if kernel == "leverage_tiled_kernel" else None
    Xc = X.to(torch.float32).contiguous()
    Mc = M.to(torch.float32).contiguous()
    xstride, mstride = (n * s if xb else 0), (s * s if mb else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is not None:
            scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
            code = library().repro_leverage_tiled(
                Xc.data_ptr(), Mc.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, n, s,
                plan.batches, plan.chunk_rows, xstride, mstride, stream)
        else:
            args = (Xc.data_ptr(), Mc.data_ptr(), out.data_ptr(), B, n, s)
            if rows:
                code = library().repro_leverage_wide(*args, rows, xstride, mstride, stream)
            else:
                code = library().repro_leverage(*args, xstride, mstride, stream)
    check(code, "leverage")
    leverage.launches += 1
    return out


leverage.launches = 0
