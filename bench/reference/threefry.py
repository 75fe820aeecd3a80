"""A frozen copy of the threefry2x32 and gumbel-max arithmetic the plain
reference needs to redraw the program's samples.

The arithmetic is ``jax.random``'s non-partitionable threefry layout, as
the port's ``rng`` module transcribes it (``_hash``, ``_bits_at``,
``split``, ``fold_in``, ``_to_unit``, ``_gumbel_of``): a draw of ``size``
words hashes the counter pair ``(p, p + half)`` for ``p < half`` and keeps
lane 0, and serves ``p >= half`` from lane 1 of ``(p - half, p)``.  Only
draws below ``2**32 - 1`` words are supported (every draw of the
benchmark's cells is: 6000 x 463,715 is 2.8e9).

Keys are ``(hi, lo)`` tuples of Python ints.  Words are int64 tensors
holding values in ``[0, 2**32)``.  The gumbel noise is evaluated in
float64 from the same float32 uniform the program draws, so the
reference's candidate values differ from the program's by rounding only.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY32 = 1.1754943508222875e-38          # float32's smallest normal

Key = Tuple[int, int]


def _hash(k1, k2, x1, x2):
    """threefry2x32's 20 rounds on counter words ``x1, x2`` (tensors or
    ints) under the key words ``k1, k2``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) & MASK) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``: hash the counters ``0 .. 2 num - 1``
    as the pairs (first half, second half) and read the words in pairs."""
    half = num
    words = [0] * (2 * num)
    for p in range(half):
        a, b = _hash(key[0], key[1], p, p + half)
        words[p], words[p + half] = a, b
    return [(words[2 * i], words[2 * i + 1]) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the two-word draw of ``(0, data)``."""
    return _hash(key[0], key[1], 0, int(data) & MASK)


def key_chain(key: Key, num: int) -> List[Key]:
    """``num`` subkeys of the sequential ``key, sub = split(key)`` chain."""
    subs = []
    for _ in range(num):
        key, sub = split(key)
        subs.append(sub)
    return subs


def bits_at(key: Key, pos: torch.Tensor, size: int) -> torch.Tensor:
    """The words at flat positions ``pos`` of a ``size``-word draw."""
    if size >= MASK:
        raise ValueError(f"a draw of {size} words needs the blocked layout, "
                         f"which the reference does not carry")
    half = (size + 1) // 2
    lo = pos < half
    x1 = torch.where(lo, pos, pos - half)
    x2 = torch.where(lo, pos + half, pos)
    x2 = torch.where(x2 >= size, torch.zeros_like(x2), x2)     # odd-size pad
    a, b = _hash(key[0], key[1], x1, x2)
    return torch.where(lo, a, b)


def uniform32(bits: torch.Tensor) -> torch.Tensor:
    """The float32 uniform in [tiny, 1) that the draw's gumbel starts from:
    the top 23 bits as a mantissa in [1, 2), minus 1, floored at tiny."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u, _TINY32)


def gumbel(bits: torch.Tensor, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """-log(-log(u)) of the draw's uniform, in ``dtype``."""
    u = uniform32(bits).to(dtype)
    return -torch.log(-torch.log(u))


def row_values(key: Key, logits: torch.Tensor, cap: int, rows: torch.Tensor,
               dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``gumbel[r, c] + logits[c]`` for rows ``rows`` of a ``(cap, n)``
    categorical draw: a ``(len(rows), n)`` tensor in ``dtype``."""
    n = logits.shape[0]
    cols = torch.arange(n, dtype=torch.int64, device=logits.device)
    pos = rows.to(torch.int64)[:, None] * n + cols[None, :]
    return gumbel(bits_at(key, pos, cap * n), dtype) + logits.to(dtype)[None, :]


def draw(key: Key, logits: torch.Tensor, cap: int, rows: torch.Tensor,
         dtype: torch.dtype = torch.float64, chunk: int = 32) -> torch.Tensor:
    """Rows ``rows`` of ``jax.random.categorical(key, logits, (cap,))``:
    the argmax of each row's candidate values, ``chunk`` rows at a time."""
    out = torch.empty((rows.numel(),), dtype=torch.int64, device=logits.device)
    for a in range(0, rows.numel(), chunk):
        out[a:a + chunk] = torch.argmax(
            row_values(key, logits, cap, rows[a:a + chunk], dtype), dim=1)
    return out
