"""Payload descriptors: the bridge between schedules and packed bytes.

A :class:`WirePayload` rides on a :class:`~repro.core.comm.CommOp` and
states what the op's message physically is on the wire — shape, dtype,
codec, and the packed bit count the ledger should bill.  Scalar control
messages carry no descriptor and default to one 32-bit word per unit
(:data:`~repro.core.wire.codecs.UNIT_BITS`), which keeps the bits column
consistent with the paper's unit convention everywhere a real payload
does not travel.

``WirePayload.of`` computes the bits from the codec contract (exact for
shape-determined codecs); ``WirePayload.measured`` records an
already-encoded payload's actual packed length (the varint round-2
uploads), so the schedule bills precisely what
:meth:`~repro.core.faults.Transport.ship` later puts on the wire —
that is what lets the benchmark reconcile bills against receipts to
the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np

from repro_torch.core.wire.codecs import get_codec


@dataclasses.dataclass(frozen=True)
class WirePayload:
    """What one scheduled message physically carries."""

    shape: Tuple[int, ...]
    dtype: str
    codec: str
    bits: int

    def __post_init__(self) -> None:
        if self.bits < 0:
            raise ValueError(f"negative wire bits: {self.bits}")

    @staticmethod
    def of(shape, dtype, codec: str) -> "WirePayload":
        """Descriptor with bits from the codec contract (shape-determined
        codecs: exact; varint integer payloads: certified upper bound)."""
        shape = tuple(int(s) for s in shape)
        dt = np.dtype(dtype).name
        return WirePayload(shape, dt, codec,
                           get_codec(codec).wire_bits(shape, dt))

    @staticmethod
    def measured(shape, dtype, codec: str, bits: int) -> "WirePayload":
        """Descriptor for a payload that was actually encoded: ``bits`` is
        the measured packed length (``8 * len(blob)``)."""
        return WirePayload(tuple(int(s) for s in shape),
                           np.dtype(dtype).name, codec, int(bits))


def fmt_bits(bits: int) -> str:
    """Human-readable wire size: raw bits below 1 KiB, then KiB/MiB."""
    nbytes = bits / 8.0
    if nbytes >= (1 << 20):
        return f"{nbytes / (1 << 20):.2f}MiB"
    if nbytes >= (1 << 10):
        return f"{nbytes / (1 << 10):.2f}KiB"
    return f"{int(bits)}b"


def encode_payloads(
    codec: str, payloads: Mapping[int, np.ndarray],
) -> Tuple[Dict[int, bytes], Dict[int, int]]:
    """Encode a per-party payload map once, up front.

    Returns ``(blobs, bits)`` keyed like ``payloads``.  The executor
    builds the round-2 schedule from ``bits`` (measured, not modeled) and
    hands ``blobs`` to :meth:`Transport.ship` so the bytes billed are the
    bytes sealed — encode exactly once per payload."""
    c = get_codec(codec)
    blobs = {j: c.encode(arr) for j, arr in payloads.items()}
    return blobs, {j: 8 * len(b) for j, b in blobs.items()}
