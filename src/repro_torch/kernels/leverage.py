"""Row-wise quadratic form lev_i = x_i^T M x_i — Algorithm 2's leverage
sweep, as a hand-written CUDA kernel (``csrc/leverage.cu``).

Port of :mod:`repro.kernels.leverage`.  :func:`leverage` launches the
kernel for CUDA tensors and takes the plain PyTorch version
(:data:`plain`) for CPU tensors; there is no fallback on the card.
``leverage.launches`` counts kernel launches.

Three kernels compute the same function with the same arithmetic in the
same order (``csrc/leverage.cu``'s bit contract), picked by s:

- s up to 32 and not a multiple of 8 (the main path's parties, s = 31):
  persistent CTAs, as many per party as the card holds at once over the
  parties (the launcher asks CUDA's occupancy calculator), each staging M
  once and walking its party's tiles of 256 rows through a ring of two,
  copied with 16-byte ``cp.async``; every thread keeps the sums of M x
  for two rows in registers;
- other s up to :data:`SHARED_M_WIDTH`: M whole in shared memory, one CTA
  per 128-row tile;
- wider: the wide kernel, which reads M through the caches.  It runs at
  any s and is the oracle the card's checks hold the other two to, bit for
  bit (:func:`_launch` with ``wide=True``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (MAX_SMEM_BYTES, PLAIN_DEVICES, batch_shape, check,
                                       launch_device, library)

#: The plain PyTorch version of the kernel (the CPU path and the oracle).
plain = ref.leverage

#: Widest party whose (s, s) fp32 M the shared-memory kernels keep whole in
#: a block's 227 KB (238^2 * 4 = 226,576 bytes).  Wider parties take the
#: wide kernel, which reads M through L1 and L2.
SHARED_M_WIDTH = 238
#: Shared memory the wide kernel's X tile may take (the static 48 KB, no
#: opt-in).
WIDE_TILE_BYTES = 48 * 1024


def wide_rows(s: int) -> int:
    """Tile height of the wide kernel: as many rows (up to 128, one per
    thread) as fit in WIDE_TILE_BYTES at the odd row stride, at least one;
    raises ``ValueError`` when one row of X does not fit in shared memory
    (s above 58,104, where M alone is 13.5 GB)."""
    row_bytes = 4 * (-(-s // 8) * 8 + 1)
    if row_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"leverage stages whole rows of X in shared memory; "
                         f"a row of s={s} takes {row_bytes} bytes")
    return max(1, min(128, WIDE_TILE_BYTES // row_bytes))


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
    """The launch on the card: the kernel for s (see the module's
    docstring), or with ``wide`` the wide kernel at any s (the bit oracle of
    the card's checks; not a user's switch)."""
    dev = launch_device(X, M)
    if X.ndim < 2 or M.ndim < 2:
        raise ValueError(f"leverage takes X (..., n, s), M (..., s, s); got "
                         f"{tuple(X.shape)}, {tuple(M.shape)}")
    n, s = X.shape[-2:]
    if M.shape[-2:] != (s, s):
        raise ValueError(f"M must be ({s}, {s}) to match X, got {tuple(M.shape)}")
    rows = wide_rows(s) if wide or s > SHARED_M_WIDTH else 0
    batch, xb, mb = batch_shape(X.shape[:-2], M.shape[:-2], "leverage")
    B = math.prod(batch)
    out = torch.empty(batch + (n,), dtype=torch.float32, device=dev)
    if n == 0 or B == 0:
        return out
    Xc = X.to(torch.float32).contiguous()
    Mc = M.to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        args = (Xc.data_ptr(), Mc.data_ptr(), out.data_ptr(), B, n, s)
        strides = (n * s if xb else 0, s * s if mb else 0, stream)
        if rows:
            code = library().repro_leverage_wide(*args, rows, *strides)
        else:
            code = library().repro_leverage(*args, *strides)
    check(code, "leverage")
    leverage.launches += 1
    return out


leverage.launches = 0
