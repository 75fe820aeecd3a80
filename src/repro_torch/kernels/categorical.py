"""The DIS draw, ``jax.random.categorical`` row by row, as a hand-written
CUDA kernel (``csrc/categorical.cu``).

Row r of a ``(cap, n)`` draw is ``argmax_c(gumbel[r, c] + logits[c])``,
its gumbel computed from the row's own flat counters in the
non-partitionable threefry layout, bit for bit
:func:`repro_torch.rng.categorical_plain`.  The reference has no Pallas
kernel here: XLA compiles ``jax.random.categorical`` (the DIS rounds,
``src/repro/core/dis.py:184`` and ``:196``, and k-means++).

Two entry shapes, one kernel:

- :func:`categorical`: one stream, the first ``take`` rows (a host int);
  the round-1 draw over T parties and each k-means++ pick;
- :func:`categorical_parties`: T party streams in one launch, party j's
  first ``counts[j]`` rows, with ``counts`` read on the device and the
  rows written party-major at the exclusive cumulative sum of the counts,
  so nothing between DIS rounds 1 and 2 goes through the host.

The draw follows the device of the logits (keys and counts are moved
there): on a CPU tensor each takes the plain version; on a CUDA tensor it
launches the kernel or raises.  It launches on the current stream and
never synchronises (given keys and counts already on the card), so a
CUDA graph can capture it.
``categorical.launches`` counts the launches of both.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import rng
from repro_torch.kernels._build import PLAIN_DEVICES, check, launch_device, library

#: Rows of at most this many columns take one thread a row; longer rows
#: take 256-thread CTAs over column tiles.
ROW_THREAD_MAX = 64
#: CTAs a launch over long rows aims for: about four waves of eight
#: 256-thread CTAs on each of an H100's 132 SMs, so that a few long rows
#: (one k-means++ pick) are split into tiles and many rows are not.
TARGET_CTAS = 4096
_THREADS = 256


def launch_shape(rows: int, n: int):
    """(tiles per row, columns per tile) for ``rows`` rows of ``n``
    columns: ``(0, n)`` for the row-per-thread kernel; else as many tiles
    as bring the launch to :data:`TARGET_CTAS` CTAs, at most one per 256
    columns."""
    if n <= ROW_THREAD_MAX:
        return 0, n
    tiles = min(-(-n // _THREADS), max(1, -(-TARGET_CTAS // max(rows, 1))))
    return tiles, -(-n // tiles)


def categorical(key: rng.Key, logits: torch.Tensor, cap: int,
                take: Optional[int] = None) -> torch.Tensor:
    """The first ``take`` (default all) rows of
    ``jax.random.categorical(key, logits, shape=(cap,))`` for 1-D
    ``logits``: int64 indices of shape ``(take,)``."""
    if logits.ndim != 1:
        raise ValueError(f"categorical takes 1-D logits, got {tuple(logits.shape)}")
    cap = int(cap)
    take = cap if take is None else int(take)
    if not 0 <= take <= cap:
        raise ValueError(f"take={take} outside [0, cap={cap}]")
    key = key.to(logits.device)
    if logits.device.type in PLAIN_DEVICES:
        return rng.categorical_plain(key, logits, cap, take)
    return _launch(key[None], logits[None], cap, None, take)


def categorical_parties(keys: torch.Tensor, logits: torch.Tensor, cap: int,
                        counts: torch.Tensor, total: Optional[int] = None
                        ) -> torch.Tensor:
    """Party j's first ``counts[j]`` rows of
    ``jax.random.categorical(keys[j], logits[j], shape=(cap,))``, for
    every party, concatenated in party order: keys ``(T, 2)``, logits
    ``(T, n)``, counts ``(T,)`` integers in ``[0, cap]``.

    ``total`` is ``counts.sum()``, the length of the result; pass it
    where the caller knows it (DIS: the budget m), since reading it from
    device counts would synchronise with the host.  On the card a count
    past cap, or a ``total`` above the counts' sum, leaves -1 in the rows
    it cannot fill."""
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"a key stack has shape (T, 2), got {tuple(keys.shape)}")
    T = logits.shape[0] if logits.ndim == 2 else -1
    if counts.shape != (T,) or keys.shape[0] != T:
        raise ValueError(f"keys (T, 2), logits (T, n) and counts (T,) must share T; got "
                         f"{tuple(keys.shape)}, {tuple(logits.shape)}, {tuple(counts.shape)}")
    cap = int(cap)
    keys, counts = keys.to(logits.device), counts.to(logits.device)
    if logits.device.type == "meta":
        # the plain version reads the counts on the host; a meta draw carries
        # only its length, which ``total`` gives
        if total is None:
            raise ValueError("a draw on the meta device needs total= (its length)")
        return torch.empty((int(total),), dtype=torch.int64, device=logits.device)
    if logits.device.type in PLAIN_DEVICES:
        out = rng.categorical_parties_plain(keys, logits, cap, counts)
        if total is not None and out.shape[0] != int(total):
            raise ValueError(f"counts sum to {out.shape[0]}, not total={total}")
        return out
    total = int(counts.sum()) if total is None else int(total)
    return _launch(keys, logits, cap, counts.to(torch.int64).contiguous(), total)


def _launch(keys: torch.Tensor, logits: torch.Tensor, cap: int,
            counts: Optional[torch.Tensor], rows: int) -> torch.Tensor:
    """One launch over ``rows`` output rows: keys ``(T, 2)``, logits
    ``(T, n)``, counts ``(T,)`` int64 on the card or None (one stream,
    rows 0..rows-1)."""
    dev = launch_device(keys, logits)
    T, n = logits.shape
    if n == 0:
        raise ValueError("categorical needs at least one column of logits")
    out = torch.empty((rows,), dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    size = cap * n
    table = rng.block_keys(keys, size).contiguous()        # (T, nblocks + 1, 2)
    lg = logits.to(torch.float32).contiguous()
    tiles, cols = launch_shape(rows, n)
    pval = pidx = None
    if tiles > 1:
        pval = torch.empty((rows, tiles), dtype=torch.float32, device=dev)
        pidx = torch.empty((rows, tiles), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_categorical(
            table.data_ptr(), table.shape[1], size, lg.data_ptr(), n, n, cap,
            None if counts is None else counts.data_ptr(), T, rows, tiles, cols,
            None if pval is None else pval.data_ptr(),
            None if pidx is None else pidx.data_ptr(), out.data_ptr(), stream)
    check(code, "categorical")
    categorical.launches += 1
    return out


categorical.launches = 0
