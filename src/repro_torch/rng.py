"""Bit-exact threefry2x32 and the ``jax.random`` subset the DIS draws use.

The reference package samples with ``jax.random`` (``split``, ``fold_in``,
``categorical``); comparing the port with it draw for draw needs the same
bits.  This module reproduces jax's threefry2x32 PRNG in torch, on the
key's device, in the NON-partitionable layout
(``jax_threefry_partitionable=False``): an array of ``size`` random words
is ``threefry_2x32(key, iota(size))``, which hashes the counter pair
``(p, p + half)`` for flat position ``p < half`` and keeps lane 0, and
serves position ``p >= half`` from lane 1 of the pair ``(p - half, p)``
(``half = ceil(size / 2)``; an odd ``size`` pads the counter array with
one zero).  That pairing is what lets :func:`categorical_plain` compute any row
of a ``(cap, n)`` gumbel draw from its own flat positions alone.

torch has few ``uint32`` operations, so every word is an ``int64`` tensor
holding a value in ``[0, 2**32)`` and each wrapping step is masked with
``0xFFFFFFFF``.  Keys are explicit ``(2,)`` tensors of such words, passed
by the caller; there is no global generator.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF

#: Rows of the ``(cap, n)`` candidate grid that :func:`categorical_plain`
#: hashes at once.  Peak memory per chunk at n = 463,715 (YearPrediction):
#: 32 rows are 14.8M positions; at its peak a position holds about 130 B
#: (int64 counters and hash words, the log's float32 steps, and the float64
#: temporaries of its emulated fused multiply-adds), so one chunk of the
#: plain version peaks near 14.8M * 130 B = 1.9 GB, whatever the budget m.
CATEGORICAL_CHUNK_ROWS = 32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)

Key = torch.Tensor


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def _hash(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
          x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher (20 rounds), jax's unrolled lowering
    transcribed: ``k1, k2`` are scalar words, ``x1, x2`` counter words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def _words(key: Key) -> Tuple[torch.Tensor, torch.Tensor]:
    if key.shape != (2,):
        raise ValueError(f"a threefry key has shape (2,), got {tuple(key.shape)}")
    k = key.to(torch.int64)
    return k[0], k[1]


def threefry_2x32(key: Key, count: torch.Tensor) -> torch.Tensor:
    """``jax.prng.threefry_2x32``: hash the flat ``count`` words as the
    pairs (first half, second half), padding an odd length with a zero,
    and return the two lanes concatenated back to ``count``'s shape."""
    k1, k2 = _words(key)
    flat = count.reshape(-1).to(torch.int64)
    size = flat.numel()
    if size % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    a, b = _hash(k1, k2, flat[:half], flat[half:])
    return torch.cat([a, b])[:size].reshape(count.shape)


def _bits_at(key: Key, pos: torch.Tensor, size: int) -> torch.Tensor:
    """Words at flat positions ``pos`` of a ``size``-word draw under
    ``key`` — one position's word depends on that position alone.

    Below 2**32 - 1 words the draw is ``threefry_2x32(key, iota(size))``.
    From there on jax's counters would wrap, so it cuts the draw into
    blocks of 2**32 - 1 words: with ``nblocks, rem = divmod(size, MASK)``
    the keys are ``split(key, nblocks + 1)``, block b hashes
    ``iota(MASK)`` under key b and the last key hashes ``iota(rem)``
    (``_threefry_random_bits_original`` in jax's ``_src/prng.py``).  A
    position p is offset ``p % MASK`` of block ``p // MASK``, with that
    block's own size, pairing and odd-size pad."""
    nblocks, rem = divmod(int(size), MASK)
    if nblocks == 0:
        k1, k2 = _words(key)
        off, bsize = pos, size
    else:
        keys = split(key, nblocks + 1).to(pos.device)
        blk = torch.div(pos, MASK, rounding_mode="floor")
        off = pos - blk * MASK
        k1, k2 = keys[blk, 0], keys[blk, 1]
        bsize = torch.where(blk < nblocks, MASK, rem)
    half = (bsize + 1) // 2
    lo = off < half
    x1 = torch.where(lo, off, off - half)
    x2 = torch.where(lo, off + half, off)
    x2 = torch.where(x2 >= bsize, torch.zeros_like(x2), x2)   # odd-size pad
    a, b = _hash(k1, k2, x1, x2)
    return torch.where(lo, a, b)


def block_keys(keys: torch.Tensor, size: int) -> torch.Tensor:
    """The per-block keys of a ``size``-word draw under each key of a
    ``(T, 2)`` stack, as ``(T, nblocks + 1, 2)`` int64 words: the key
    itself below 2**32 - 1 words (``nblocks == 0``), else
    ``split(key, nblocks + 1)`` (see :func:`_bits_at`), on its device."""
    k = keys.to(torch.int64)
    nblocks = int(size) // MASK
    if nblocks == 0:
        return k[:, None, :]
    return torch.stack([split(kj, nblocks + 1) for kj in k])


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> Key:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & MASK)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def split(key: Key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: a ``(num, 2)`` stack of keys."""
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return threefry_2x32(key, counts).reshape(num, 2)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: hash the seed words of ``data``."""
    d = int(data) & MASK
    return threefry_2x32(key, torch.tensor([0, d], dtype=torch.int64,
                                           device=key.device))


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, shape, uint32)``."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    pos = torch.arange(size, dtype=torch.int64, device=key.device)
    return _bits_at(key, pos, size).reshape(shape)


def _check_int_range(minval: int, maxval: int) -> None:
    if not 0 <= minval <= maxval < 2 ** 31:
        raise ValueError(
            f"randint range [{minval}, {maxval}) must lie in [0, 2**31)")


def _fold_randint(hi: torch.Tensor, lo: torch.Tensor, minval: int,
                  maxval: int) -> torch.Tensor:
    """jax's int32 ``randint`` from its two 32-bit words: both folded
    modulo the span with uint32 wrap-around, its biased-but-cheap recipe."""
    span = max(int(maxval) - int(minval), 1)
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return (off % span + int(minval)).to(torch.int64)


def randint(key: Key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws folded modulo
    the span with uint32 wrap-around, jax's biased-but-cheap recipe."""
    _check_int_range(minval, maxval)
    k1, k2 = split(key)
    return _fold_randint(random_bits(k1, shape), random_bits(k2, shape),
                         minval, maxval)


def randint_each(keys: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """One scalar ``randint`` per key of a ``(num, 2)`` key stack, i.e.
    ``jax.vmap(lambda k: jax.random.randint(k, (), minval, maxval))(keys)``,
    in a few elementwise launches for the whole stack.

    Per key: ``split`` hashes the counter pairs (0, 2) and (1, 3), giving
    the two subkeys as lanes 0 and 1; a scalar draw under a subkey is lane
    0 of the pair (0, 0) (a one-word draw pads its counters with a zero).
    """
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"a key stack has shape (num, 2), got {tuple(keys.shape)}")
    _check_int_range(minval, maxval)
    k = keys.to(torch.int64)
    pair = torch.arange(4, dtype=torch.int64, device=k.device).reshape(2, 2)
    sub1, sub2 = _hash(k[:, :1], k[:, 1:], pair[:1], pair[1:])   # (num, 2) each
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    hi, _ = _hash(sub1[:, 0], sub1[:, 1], zero, zero)
    lo, _ = _hash(sub2[:, 0], sub2[:, 1], zero, zero)
    return _fold_randint(hi, lo, minval, maxval)


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """jax's mantissa trick: the top 23 bits under exponent 0 give a
    float32 in [1, 2); subtracting 1 gives [0, 1)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (the scaling ``f * span + minval``
    fused into one rounding, as jax's CPU backend compiles it)."""
    lo = _f32(minval)
    span = float(np.float32(maxval) - np.float32(minval))
    f = _to_unit(random_bits(key, shape))
    return torch.clamp_min(_fma(f, span, lo), lo)


def _f32(c: float) -> float:
    return float(np.float32(c))


# Cephes log(1+x) coefficients, highest degree first, as float32
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = 0.693359375
_SQRTHF = _f32(0.707106781186547524)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add does.

    The product of two float32 values is exact in float64 and TwoSum
    recovers the float64 sum's rounding error; rounding that sum to odd
    before the final rounding to float32 avoids the double-rounding error,
    so every device gives the single-rounded result."""
    p = a.double() * b
    c = c.double() if torch.is_tensor(c) else c
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    sb = s.view(torch.int64)
    toward_zero = torch.where((err < 0) != (s < 0), sb - 1, sb)
    odd = torch.where(err != 0, toward_zero | 1, sb)
    return odd.view(torch.float64).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bit-identical to ``jnp.log`` on jax's CPU
    backend: the Cephes polynomial that XLA emits for it, with the same
    evaluation order and the same fused multiply-adds.  Every step is one
    IEEE-rounded torch operation, so the card gives the same bits as the
    CPU.  Subnormal inputs count as zero, as XLA's flush-to-zero does."""
    x = x.float()
    xc = torch.clamp_min(x, _TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    mant = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < _SQRTHF
    t = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    e = e - low.float()
    z = t * t
    t3 = z * t
    P = _LOG_P
    p = _fma(_fma(t, P[0], P[1]), t, P[2])
    q = _fma(_fma(t, P[3], P[4]), t, P[5])
    r = _fma(_fma(t, P[6], P[7]), t, P[8])
    y = _fma(_fma(p, t3, q), t3, r)
    y = _fma(y, t3, e * _LOG_Q1)
    out = ((t - 0.5 * z) + y) + e * _LOG_Q2
    out = torch.where(torch.isposinf(x), x, out)
    out = torch.where(x.abs() < _TINY, torch.full_like(out, -float("inf")), out)
    return torch.where((x <= -_TINY) | torch.isnan(x),
                       torch.full_like(out, float("nan")), out)


def _gumbel_of(bits: torch.Tensor) -> torch.Tensor:
    # uniform(minval=tiny, maxval=1): the span 1 - tiny rounds to 1.0 in
    # float32, so the scaling is the identity and only the shift remains
    u = torch.clamp_min(_to_unit(bits) + _TINY, _TINY)
    return -log(-log(u))


def gumbel(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32."""
    return _gumbel_of(random_bits(key, shape))


def categorical_plain(key: Key, logits: torch.Tensor, cap: int,
                      take: Optional[int] = None) -> torch.Tensor:
    """The first ``take`` (default all) entries of
    ``jax.random.categorical(key, logits, shape=(cap,))`` for 1-D
    ``logits`` of length n: row r is ``argmax_c(gumbel[r, c] + logits[c])``
    over the ``(cap, n)`` gumbel draw, each row computed from its own flat
    counter positions, so the rows past ``take`` are never computed.

    The plain PyTorch version of the categorical kernel
    (:func:`repro_torch.kernels.ops.categorical` dispatches between them):
    rows are hashed :data:`CATEGORICAL_CHUNK_ROWS` at a time, so the
    ``(cap, n)`` tensor never exists; each row equals the full draw's."""
    if logits.ndim != 1:
        raise ValueError(f"categorical takes 1-D logits, got {tuple(logits.shape)}")
    n = logits.shape[0]
    cap = int(cap)
    take = cap if take is None else int(take)
    if not 0 <= take <= cap:
        raise ValueError(f"take={take} outside [0, cap={cap}]")
    size = cap * n
    lg = logits.to(torch.float32)
    out = torch.empty((take,), dtype=torch.int64, device=logits.device)
    cols = torch.arange(n, dtype=torch.int64, device=logits.device)
    for r0 in range(0, take, CATEGORICAL_CHUNK_ROWS):
        r1 = min(r0 + CATEGORICAL_CHUNK_ROWS, take)
        rows = torch.arange(r0, r1, dtype=torch.int64, device=logits.device)
        pos = rows[:, None] * n + cols[None, :]
        g = _gumbel_of(_bits_at(key, pos, size))
        out[r0:r1] = torch.argmax(g + lg[None, :], dim=1)
    return out


def categorical_parties_plain(keys: torch.Tensor, logits: torch.Tensor, cap: int,
                              counts: torch.Tensor) -> torch.Tensor:
    """Party j's first ``counts[j]`` entries of
    ``jax.random.categorical(keys[j], logits[j], shape=(cap,))`` for every
    party of a ``(T, 2)`` key stack and ``(T, n)`` logits, concatenated in
    party order.  The plain version of the kernel's party entry
    (:func:`repro_torch.kernels.ops.categorical_parties`): one
    :func:`categorical_plain` head per party, the counts read on the
    host."""
    takes = [int(a) for a in counts.tolist()]
    return torch.cat([categorical_plain(keys[j], logits[j], cap, take=takes[j])
                      for j in range(len(takes))])
