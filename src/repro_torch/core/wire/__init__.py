"""repro_torch.core.wire — the wire codecs and payload descriptors, copied
from the reference package so the port bills the same bits.

Numpy-only, like the reference: it sits below the ledger and imports
nothing from the rest of ``repro_torch.core``.  The plan-time bit
prediction (``budget.py``) waits for the planner's codec axis.
"""

from repro_torch.core.wire.codecs import (
    CODEC_LADDER,
    SPEC_CODECS,
    UNIT_BITS,
    WIRE_CODECS,
    Codec,
    get_codec,
)
from repro_torch.core.wire.payload import WirePayload, encode_payloads, fmt_bits

__all__ = [
    "CODEC_LADDER",
    "Codec",
    "SPEC_CODECS",
    "UNIT_BITS",
    "WIRE_CODECS",
    "WirePayload",
    "encode_payloads",
    "fmt_bits",
    "get_codec",
]
