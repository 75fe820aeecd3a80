"""Wire codecs: real packed-byte encodings for the protocol's payloads.

The paper's ledger counts abstract units (one per transported float/int);
this module is what turns those units into an honest bytes-on-the-wire
number.  Every codec round-trips through REAL packed bytes — ``encode``
returns the byte string that would cross the wire, ``decode`` reconstructs
the array the receiver would see, and ``wire_bits(shape, dtype)`` states
the packed size up front so the planner can bill a message before it is
ever built.  ``wire_bits`` is a contract, not an estimate: for the
shape-determined codecs it equals ``8 * len(encode(x))`` exactly for every
``x`` of that shape/dtype (property-tested in ``tests/test_wire.py``);
for the value-dependent varint path it is a guaranteed upper bound and the
ledger bills the measured packed length instead.

Two payload families cross the wire (Compressed-VFL, Castiglia et al.,
motivates quantizing both):

* round-1 mass tables — float32 rows, one per party: per-row sensitivity
  scores (materialized engine) or per-block masses (streamed/pipelined);
* round-2 index uploads — int32 row indices, one vector per party.

Float payloads go through the named quantizer; integer payloads are
always LOSSLESS (a wrong index is a different coreset, not a noisier
one): ``raw_fp32`` ships them as packed int32 words, every compressed
codec ships them zigzag-delta varint encoded.

Tolerance contract (float payloads, per entry, relative to the payload's
absmax):  ``|decode(encode(x)) - x| <= tolerance * max|x|``.

============== ========== ===================== =======================
codec          tolerance  float payload          int payload
============== ========== ===================== =======================
raw_fp32       0 (exact)  4 B/entry             4 B/entry (int32 words)
fp16           2**-10     4 B + 2 B/entry       varint (<= 5 B/entry)
int8_blockscale1/127      4 B/64-block + 1 B/e  varint (<= 5 B/entry)
delta_varint   2**-10     fp16 scheme           varint (<= 5 B/entry)
============== ========== ===================== =======================

This module is numpy-only by design — it sits below ``repro.core.comm``
and must import nothing from the rest of the package.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

#: One ledger unit (a transported float/int, paper Section 2) is one
#: 32-bit word on the raw wire — the conversion the bits column defaults
#: to for scalar control messages that carry no payload descriptor.
UNIT_BITS = 32

#: Per-block quantization group for the int8 codec (absmax scale / block).
INT8_BLOCK = 64

#: Worst-case varint bytes for one zigzag-delta-encoded int32 index.
VARINT_MAX_BYTES_I32 = 5


def _is_int(dtype) -> bool:
    kind = np.dtype(dtype).kind
    if kind in "iu":
        return True
    if kind == "f":
        return False
    raise ValueError(f"wire codecs carry float/int payloads only, got {dtype}")


# --------------------------------------------------------------------------
# shared integer paths
# --------------------------------------------------------------------------

def _raw_i32_encode(arr: np.ndarray) -> bytes:
    v = np.ascontiguousarray(arr)
    if v.size and (v.min() < np.iinfo(np.int32).min
                   or v.max() > np.iinfo(np.int32).max):
        raise ValueError(
            "raw wire ships indices as int32 words; payload exceeds int32 "
            f"range (min={v.min()}, max={v.max()})"
        )
    return v.astype("<i4").tobytes()


def _raw_i32_decode(blob: bytes, shape: Tuple[int, ...], dtype) -> np.ndarray:
    return np.frombuffer(blob, "<i4").reshape(shape).astype(dtype)


def _varint_encode(arr: np.ndarray) -> bytes:
    """Zigzag delta varint: lossless, order-preserving, value-dependent size."""
    out = bytearray()
    prev = 0
    for v in np.asarray(arr, np.int64).ravel().tolist():
        d = v - prev
        prev = v
        u = d * 2 if d >= 0 else -d * 2 - 1
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def _varint_decode(blob: bytes, shape: Tuple[int, ...], dtype) -> np.ndarray:
    vals = []
    acc = 0
    cur = 0
    shift = 0
    for b in blob:
        cur |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
        else:
            d = cur // 2 if cur % 2 == 0 else -((cur + 1) // 2)
            acc += d
            vals.append(acc)
            cur = 0
            shift = 0
    if cur or shift:
        raise ValueError("truncated varint payload")
    out = np.asarray(vals, np.int64).reshape(shape)
    return out.astype(dtype)


def _varint_max_bits(size: int) -> int:
    return size * VARINT_MAX_BYTES_I32 * 8


# --------------------------------------------------------------------------
# codec protocol + concrete codecs
# --------------------------------------------------------------------------

class Codec:
    """One wire format: named, tolerance-documented, byte-measured.

    Subclasses implement the float payload path; the integer path is the
    shared lossless machinery above (raw int32 words or zigzag-delta
    varint, per ``int_varint``)."""

    name: str = ""
    #: per-entry round-trip error bound relative to the payload absmax
    #: (float payloads; integer payloads are always exact)
    tolerance: float = 0.0
    #: True when decode(encode(x)) reproduces x bit-for-bit (float32 domain)
    lossless: bool = True
    #: compressed codecs varint their integer payloads; raw ships i32 words
    int_varint: bool = False

    # -- float payload path (subclass responsibility) ----------------------
    def _encode_f(self, x: np.ndarray) -> bytes:
        raise NotImplementedError

    def _decode_f(self, blob: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        raise NotImplementedError

    def _float_bits(self, size: int) -> int:
        raise NotImplementedError

    # -- public protocol ---------------------------------------------------
    def encode(self, arr) -> bytes:
        a = np.asarray(arr)
        if _is_int(a.dtype):
            return (_varint_encode(a) if self.int_varint
                    else _raw_i32_encode(a))
        return self._encode_f(np.ascontiguousarray(a, np.float32))

    def decode(self, blob: bytes, shape: Sequence[int], dtype) -> np.ndarray:
        shape = tuple(int(s) for s in shape)
        if _is_int(dtype):
            return (_varint_decode(blob, shape, dtype) if self.int_varint
                    else _raw_i32_decode(blob, shape, dtype))
        return self._decode_f(blob, shape)

    def wire_bits(self, shape: Sequence[int], dtype) -> int:
        """Packed size of any payload of ``(shape, dtype)``: exact where
        :meth:`bits_exact`, else a guaranteed upper bound (varint ints)."""
        size = int(np.prod([int(s) for s in shape], dtype=np.int64)) \
            if len(tuple(shape)) else 1
        if _is_int(dtype):
            return _varint_max_bits(size) if self.int_varint else 32 * size
        return self._float_bits(size)

    def bits_exact(self, dtype) -> bool:
        """True when ``wire_bits`` equals the packed length for EVERY value
        of that dtype (the property the ledger reconciliation relies on)."""
        return not (self.int_varint and _is_int(dtype))

    def exact_for(self, dtype) -> bool:
        """True when decode(encode(x)) reproduces x's VALUES exactly for
        this dtype — integer payloads are exact under every codec (indices
        are never quantized), floats only under the lossless ones."""
        return self.lossless or _is_int(dtype)


class RawFP32(Codec):
    """The unit convention made literal: one 32-bit word per float/int.

    Lossless for the float32 wire domain — the default codec, pinned
    draw- and ledger-identical to the uncompressed protocol."""

    name = "raw_fp32"
    tolerance = 0.0
    lossless = True
    int_varint = False

    def _encode_f(self, x: np.ndarray) -> bytes:
        return x.astype("<f4").tobytes()

    def _decode_f(self, blob: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        return np.frombuffer(blob, "<f4").reshape(shape).astype(np.float32)

    def _float_bits(self, size: int) -> int:
        return 32 * size


class FP16(Codec):
    """Scaled half precision: one float32 scale (absmax / 32768) + fp16
    mantissas.  The scale keeps every entry inside fp16's exactly-normal
    range, so the per-entry error is <= 2**-11 of the entry's magnitude;
    tolerance documents 2**-10 (a 2x margin covering subnormal dust)."""

    name = "fp16"
    tolerance = 2.0 ** -10
    lossless = False
    int_varint = True

    _SPAN = np.float32(32768.0)

    def _scale(self, x: np.ndarray) -> np.float32:
        a = float(np.max(np.abs(x))) if x.size else 0.0
        if not math.isfinite(a) or a == 0.0:
            return np.float32(1.0)
        return np.float32(a) / self._SPAN

    def _encode_f(self, x: np.ndarray) -> bytes:
        s = self._scale(x)
        q = (x.ravel() / s).astype("<f2")
        return s.tobytes() + q.tobytes()

    def _decode_f(self, blob: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        s = np.frombuffer(blob[:4], "<f4")[0]
        q = np.frombuffer(blob[4:], "<f2").astype(np.float32)
        return (q * s).reshape(shape)

    def _float_bits(self, size: int) -> int:
        return 32 + 16 * size


class Int8BlockScale(Codec):
    """Per-block absmax int8: one float32 scale per 64-entry block + one
    signed byte per entry.  Round-trip error is <= scale/2 = absmax_block
    / 254 per entry; tolerance documents 1/127 (2x margin) relative to
    the payload absmax.  ~3.8x smaller than raw_fp32 for long rows."""

    name = "int8_blockscale"
    tolerance = 1.0 / 127.0
    lossless = False
    int_varint = True

    def _encode_f(self, x: np.ndarray) -> bytes:
        v = x.ravel()
        size = v.size
        nb = -(-size // INT8_BLOCK) if size else 0
        pad = nb * INT8_BLOCK - size
        xb = np.pad(v, (0, pad)).reshape(nb, INT8_BLOCK) if nb \
            else v.reshape(0, INT8_BLOCK)
        a = np.max(np.abs(xb), axis=1) if nb else np.zeros((0,), np.float32)
        s = np.where((a > 0) & np.isfinite(a), a / 127.0, 1.0).astype("<f4")
        qf = np.round(xb / s[:, None].astype(np.float32)) if nb else xb
        qf = np.where(np.isfinite(qf), qf, 0.0)
        q = np.clip(qf, -127, 127).astype("<i1").ravel()[:size]
        return s.tobytes() + q.tobytes()

    def _decode_f(self, blob: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nb = -(-size // INT8_BLOCK) if size else 0
        s = np.frombuffer(blob[:4 * nb], "<f4").astype(np.float32)
        q = np.frombuffer(blob[4 * nb:], "<i1").astype(np.float32)
        pad = nb * INT8_BLOCK - size
        qb = np.pad(q, (0, pad)).reshape(nb, INT8_BLOCK) if nb \
            else q.reshape(0, INT8_BLOCK)
        return (qb * s[:, None]).ravel()[:size].reshape(shape)

    def _float_bits(self, size: int) -> int:
        nb = -(-size // INT8_BLOCK) if size else 0
        return 32 * nb + 8 * size


class DeltaVarint(Codec):
    """Round-2 upload format: zigzag-delta varint indices (lossless —
    a flipped index is a different coreset, never acceptable) plus
    fp16-quantized float payloads ("quantized weights") should a float
    array travel under it.  Used internally by every compressed codec's
    integer path; selectable by name for tests and benchmarks."""

    name = "delta_varint"
    tolerance = FP16.tolerance
    lossless = False
    int_varint = True

    _fp16 = FP16()

    def _encode_f(self, x: np.ndarray) -> bytes:
        return self._fp16._encode_f(x)

    def _decode_f(self, blob: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        return self._fp16._decode_f(blob, shape)

    def _float_bits(self, size: int) -> int:
        return self._fp16._float_bits(size)


#: name -> codec instance (codecs are stateless; one shared instance each)
WIRE_CODECS: Dict[str, Codec] = {
    c.name: c for c in (RawFP32(), FP16(), Int8BlockScale(), DeltaVarint())
}

#: fidelity order for the planner's comm-budget walk: the first codec
#: whose predicted bits fit ``comm_budget_bits`` wins (best tolerance
#: that fits the budget)
CODEC_LADDER: Tuple[str, ...] = ("raw_fp32", "fp16", "int8_blockscale")

#: valid values for ``CoresetSpec.codec`` — the spec names the round-1
#: mass-table format; compressed codecs varint the round-2 uploads
#: automatically (``delta_varint`` is their shared integer path, not a
#: table format, so it is not spec-selectable)
SPEC_CODECS: Tuple[str, ...] = ("auto",) + CODEC_LADDER


def get_codec(name: str) -> Codec:
    try:
        return WIRE_CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {name!r}; known: {sorted(WIRE_CODECS)}"
        ) from None
