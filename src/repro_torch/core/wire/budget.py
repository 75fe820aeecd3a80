"""Plan-time wire-bit prediction and the comm-budget codec walk (a copy
of :mod:`repro.core.wire.budget`).

Mirrors :meth:`CommSchedule.dis_total` one level down: where the unit
prediction is exact because the total is split-invariant, the bit
prediction is exact for every shape-determined message and a certified
upper bound for the value-dependent varint uploads — so a plan's
``predicted_wire_bits`` is a number the realized bill can never exceed,
which is what makes ``comm_budget_bits`` a real admission criterion
rather than a hope.

Numpy-free and comm-free on purpose: :mod:`repro_torch.core.plan` calls in
here before any executor exists.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.wire.codecs import (
    CODEC_LADDER,
    UNIT_BITS,
    get_codec,
)


def predict_dis_bits(T: int, m: int, cells: int, codec: str) -> int:
    """Exact-or-upper-bound wire bits for one DIS cell (Algorithm 1).

    Round 1: each party uploads its mass-table row — ``cells`` float32
    entries through ``codec`` (the real payload behind the paper's G_j
    scalar) — and receives its a_j scalar.  Round 2: the m realized
    index uploads (int32 words raw; varint bound compressed — the total
    is split-invariant because the bound is per index) plus the m-index
    broadcast to every party.  Round 3: m score scalars up per party.
    """
    c = get_codec(codec)
    row = c.wire_bits((cells,), "float32")
    round1 = T * (row + UNIT_BITS)
    round2_up = c.wire_bits((m,), "int32")
    round23 = round2_up + 2 * T * m * UNIT_BITS
    return round1 + round23


def predict_uniform_bits(T: int, m: int) -> int:
    """U-* baseline: the m-index broadcast only (no tables, no uploads)."""
    return T * m * UNIT_BITS


def choose_codec(
    spec_codec: str,
    budget_bits: Optional[int],
    bits_by_codec: Dict[str, int],
) -> Tuple[str, bool, str]:
    """Resolve the spec's codec axis against a bit budget.

    Returns ``(codec, budget_exceeded, note)``.  ``codec="auto"`` walks
    :data:`CODEC_LADDER` in fidelity order and picks the FIRST codec whose
    predicted bits fit the budget — the best tolerance money can buy; if
    none fits, the smallest codec is chosen and the plan is flagged.  An
    explicit codec is honoured as-is and only checked against the budget.
    """
    if spec_codec != "auto":
        bits = bits_by_codec[spec_codec]
        if budget_bits is not None and bits > budget_bits:
            return spec_codec, True, (
                f"codec {spec_codec} predicted {bits} bits exceeds "
                f"comm_budget_bits={budget_bits}"
            )
        return spec_codec, False, ""
    if budget_bits is None:
        return CODEC_LADDER[0], False, ""
    for name in CODEC_LADDER:
        if bits_by_codec[name] <= budget_bits:
            others = ", ".join(
                f"{n}={bits_by_codec[n]}b" for n in CODEC_LADDER if n != name
            )
            return name, False, (
                f"comm budget {budget_bits}b -> {name} "
                f"({bits_by_codec[name]}b predicted; {others}; "
                f"tolerance {get_codec(name).tolerance:.3g})"
            )
    name = min(CODEC_LADDER, key=lambda n: bits_by_codec[n])
    return name, True, (
        f"comm budget {budget_bits}b unmeetable; smallest codec {name} "
        f"still predicts {bits_by_codec[name]}b"
    )
