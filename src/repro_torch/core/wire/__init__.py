"""repro_torch.core.wire — the wire codecs and payload descriptors, copied
from the reference package so the port bills the same bits.

Numpy-only, like the reference: it sits below the ledger and imports
nothing from the rest of ``repro_torch.core``.  ``budget.py`` holds the
plan-time bit prediction and the ``comm_budget_bits`` codec walk.
"""

from repro_torch.core.wire.budget import (
    choose_codec,
    predict_dis_bits,
    predict_uniform_bits,
)
from repro_torch.core.wire.codecs import (
    CODEC_LADDER,
    INT8_BLOCK,
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
    "INT8_BLOCK",
    "SPEC_CODECS",
    "UNIT_BITS",
    "WIRE_CODECS",
    "WirePayload",
    "choose_codec",
    "encode_payloads",
    "fmt_bits",
    "get_codec",
    "predict_dis_bits",
    "predict_uniform_bits",
]
