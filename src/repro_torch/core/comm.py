"""Communication accounting for the VFL model of the paper.

The paper (Section 2) counts one unit per transported integer/float, so a
d-dimensional vector costs d units.  Every protocol in ``repro_torch.core`` takes an
optional :class:`CommLedger` and records each message with its direction and
round, so benchmarks can reproduce the paper's communication-complexity
columns exactly (Table 1 "Com. compl.").

Alongside units, every message carries a ``bits`` column: the packed size
of the bytes that physically cross the wire.  Scalar control messages
default to one 32-bit word per unit (the paper's float/int is a raw
float32 on the wire); ops that carry a real payload — the round-1 mass
tables, the round-2 index uploads — bill their codec's packed size via a
:class:`~repro_torch.core.wire.WirePayload` descriptor instead.  The units
column is untouched by compression: it stays the paper's abstract count,
while bits answer "how many bytes did that actually cost".
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.wire import UNIT_BITS, WirePayload, fmt_bits


@dataclasses.dataclass
class Message:
    """One logical message in the star topology (server <-> party)."""

    tag: str          # e.g. "dis/round1/G_j"
    src: str          # "server" or "party:<j>"
    dst: str
    units: int        # floats/ints transported (paper Section 2 count)
    bits: int = 0     # packed bits on the wire (codec-measured)


class CommLedger:
    """Unit-accounting ledger for server<->party communication.

    Only server<->party links exist (paper Section 2 / Figure 1a); any
    party<->party exchange must be relayed and is recorded as two messages.
    """

    def __init__(self) -> None:
        self.messages: List[Message] = []
        self._by_tag: Dict[str, int] = defaultdict(int)
        self._bits_by_tag: Dict[str, int] = defaultdict(int)

    def send(self, tag: str, src: str, dst: str, units: int,
             bits: Optional[int] = None) -> None:
        if units < 0:
            raise ValueError(f"negative units for {tag}: {units}")
        if bits is None:
            bits = UNIT_BITS * int(units)
        if bits < 0:
            raise ValueError(f"negative bits for {tag}: {bits}")
        self.messages.append(Message(tag, src, dst, int(units), int(bits)))
        self._by_tag[tag] += int(units)
        self._bits_by_tag[tag] += int(bits)

    # -- convenience wrappers ------------------------------------------------
    def party_to_server(self, tag: str, party: int, units: int,
                        bits: Optional[int] = None) -> None:
        self.send(tag, f"party:{party}", "server", units, bits)

    def server_to_party(self, tag: str, party: int, units: int,
                        bits: Optional[int] = None) -> None:
        self.send(tag, "server", f"party:{party}", units, bits)

    def broadcast(self, tag: str, n_parties: int, units_each: int,
                  bits_each: Optional[int] = None) -> None:
        for j in range(n_parties):
            self.server_to_party(tag, j, units_each, bits_each)

    # -- queries ---------------------------------------------------------------
    @property
    def total(self) -> int:
        return sum(m.units for m in self.messages)

    @property
    def total_bits(self) -> int:
        """Packed bits across every message — the honest wire total the
        unit column abstracts away."""
        return sum(m.bits for m in self.messages)

    def by_tag(self, *, bits: bool = False) -> Dict[str, int]:
        """Per-tag units (default) or, with ``bits=True``, per-tag packed
        wire bits — same keys, the byte-billed view of the same traffic."""
        return dict(self._bits_by_tag if bits else self._by_tag)

    def by_prefix(self, prefix: str, *, bits: bool = False) -> int:
        src = self._bits_by_tag if bits else self._by_tag
        return sum(u for t, u in src.items() if t.startswith(prefix))

    def fork(self) -> "CommLedger":
        """Fresh ledger (used to isolate a sub-protocol's cost)."""
        return CommLedger()

    # -- crash-safe snapshots ------------------------------------------------
    def mark(self) -> int:
        """A rollback point: the current message count.  Pair with
        :meth:`rollback` to undo a failed multi-schedule operation (e.g. a
        tree insert that died mid-merge) so the composed bill never counts
        work that was rolled back."""
        return len(self.messages)

    def rollback(self, mark: int) -> None:
        """Truncate to the state :meth:`mark` captured (``_by_tag`` is
        rebuilt from the surviving messages)."""
        if not 0 <= mark <= len(self.messages):
            raise ValueError(
                f"bad mark {mark}: ledger has {len(self.messages)} messages"
            )
        del self.messages[mark:]
        self._by_tag = defaultdict(int)
        self._bits_by_tag = defaultdict(int)
        for m in self.messages:
            self._by_tag[m.tag] += m.units
            self._bits_by_tag[m.tag] += m.bits

    def since(self, mark: int, *, bits: bool = False) -> int:
        """Units (or packed bits, with ``bits=True``) recorded after a
        :meth:`mark` — the cost delta of the bracketed operation (e.g. the
        integrity benchmark reads one build's retransmission overhead off
        this without forking ledgers)."""
        if not 0 <= mark <= len(self.messages):
            raise ValueError(
                f"bad mark {mark}: ledger has {len(self.messages)} messages"
            )
        if bits:
            return sum(m.bits for m in self.messages[mark:])
        return sum(m.units for m in self.messages[mark:])

    def merge(self, other: "CommLedger") -> None:
        for m in other.messages:
            self.send(m.tag, m.src, m.dst, m.units, m.bits)

    def summary(self) -> str:
        lines = [f"total={self.total} units "
                 f"({fmt_bits(self.total_bits)} on the wire)"]
        for tag in sorted(self._by_tag):
            lines.append(f"  {tag}: {self._by_tag[tag]} "
                         f"({fmt_bits(self._bits_by_tag[tag])})")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One planned message: party j's uplink (or downlink when ``down``).

    ``payload`` states what the message physically carries on the wire
    (shape/dtype/codec + packed bits); ops without one are scalar control
    messages billed at one 32-bit word per unit."""

    tag: str
    party: int
    units: int
    down: bool = False    # True: server -> party, False: party -> server
    payload: Optional[WirePayload] = None

    @property
    def bits(self) -> int:
        """Packed wire bits this op bills — the descriptor's measured
        size, or the raw-word default for scalar messages."""
        return self.payload.bits if self.payload is not None \
            else UNIT_BITS * self.units


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Declarative per-round ledger entries for a protocol execution.

    The protocol core (:func:`repro_torch.core.dis.dis_plan_full`) carries no
    ledger side effects; instead the exact entries are *derived after the
    fact* from the protocol parameters — ``(T, m)`` plus, for DIS round 2,
    the realised per-party sample counts ``a_j``.  ``record`` replays the
    schedule onto a :class:`CommLedger`, producing the same bill the seed's
    in-line accounting did, without ever entering the traced hot path.
    """

    ops: Tuple[CommOp, ...]

    @property
    def total(self) -> int:
        return sum(op.units for op in self.ops)

    @property
    def total_bits(self) -> int:
        """Packed wire bits for the whole schedule (payload-descriptor
        bits where present, one raw word per unit otherwise)."""
        return sum(op.bits for op in self.ops)

    def record(self, ledger: Optional["CommLedger"]) -> "CommSchedule":
        """Replay onto ``ledger`` (no-op when None); returns self for chaining."""
        if ledger is not None:
            for op in self.ops:
                if op.down:
                    ledger.server_to_party(op.tag, op.party, op.units,
                                           op.bits)
                else:
                    ledger.party_to_server(op.tag, op.party, op.units,
                                           op.bits)
        return self

    def __add__(self, other: "CommSchedule") -> "CommSchedule":
        return CommSchedule(self.ops + other.ops)

    @staticmethod
    def dis(
        T: int, m: int, counts: Sequence[int],
        round1_payload: Optional[WirePayload] = None,
        upload_payloads: Optional[Sequence[Optional[WirePayload]]] = None,
    ) -> "CommSchedule":
        """Algorithm 1's three rounds.  ``counts`` is the realised a_j vector
        (sum = m): round 2's m index uploads are attributed to the party that
        actually sent them, not lumped onto party 0.

        Composed from :meth:`dis_round1` + :meth:`dis_rounds23` with
        identical op order — the split exists so a fault-aware executor can
        deliver round 1 BEFORE scoring (the point where a party can still
        drop under ``fault_policy="degrade"``) and rounds 2-3 after the
        draw, while fault-free delivery of the two halves back to back is
        bit-identical to this one-shot schedule.

        ``round1_payload`` / ``upload_payloads`` are the wire descriptors
        for the two messages that carry real payloads (the per-party mass
        table row, the per-party index upload) — they change the bits
        column only, never units."""
        return (CommSchedule.dis_round1(T, payload=round1_payload)
                + CommSchedule.dis_rounds23(
                    T, m, counts, upload_payloads=upload_payloads))

    @staticmethod
    def dis_round1(
        T: int, parties: Optional[Sequence[int]] = None,
        payload: Optional[WirePayload] = None,
    ) -> "CommSchedule":
        """DIS round 1 only: each party's total-score scalar up, its a_j
        scalar down.  ``parties`` restricts (and re-labels) the ops to a
        surviving subset — ids stay the ORIGINAL party numbers so degraded
        builds bill against the parties that actually spoke.  ``payload``
        describes the mass-table row each party's G_j upload physically
        carries (the scalar is the paper's unit count; the row is what
        crosses the wire)."""
        ids = list(range(T)) if parties is None else [int(j) for j in parties]
        ops: List[CommOp] = []
        ops += [CommOp("dis/round1/G_j", j, 1, payload=payload) for j in ids]
        ops += [CommOp("dis/round1/a_j", j, 1, down=True) for j in ids]
        return CommSchedule(tuple(ops))

    @staticmethod
    def dis_rounds23(
        T: int, m: int, counts: Sequence[int],
        parties: Optional[Sequence[int]] = None,
        upload_payloads: Optional[Sequence[Optional[WirePayload]]] = None,
    ) -> "CommSchedule":
        """DIS rounds 2-3: per-party index uploads (the realised a_j),
        the m-index broadcast, and the m score uploads.  ``parties`` maps
        position i of ``counts`` to original party id ``parties[i]`` for
        degraded builds over a surviving subset; ``upload_payloads``
        (aligned with ``counts``) carries each S_up op's measured wire
        descriptor for the bits column."""
        counts = [int(c) for c in counts]
        ids = (list(range(T)) if parties is None
               else [int(j) for j in parties])
        if len(counts) != len(ids) or sum(counts) != m:
            raise ValueError(
                f"bad round-2 counts {counts} for parties={ids}, m={m}"
            )
        if upload_payloads is None:
            upload_payloads = [None] * len(ids)
        if len(upload_payloads) != len(ids):
            raise ValueError(
                f"{len(upload_payloads)} upload payloads for "
                f"{len(ids)} parties"
            )
        ops: List[CommOp] = []
        ops += [CommOp("dis/round2/S_up", j, c, payload=p)
                for j, c, p in zip(ids, counts, upload_payloads)]
        ops += [CommOp("dis/round2/S_bcast", j, m, down=True) for j in ids]
        ops += [CommOp("dis/round3/g_scores", j, m) for j in ids]
        return CommSchedule(tuple(ops))

    @staticmethod
    def dis_total(T: int, m: int) -> int:
        """Algorithm 1's exact total bill, BEFORE any draw happens.

        The total is independent of the realised round-2 split (the a_j
        only re-attribute the m index uploads between parties):
        2T (round 1) + m (round 2 up) + mT (round 2 broadcast) + mT
        (round 3).  This is what lets the planner
        (:mod:`repro_torch.core.plan`) predict the bill exactly at compile time.
        """
        return CommSchedule.dis(T, m, counts=[m] + [0] * (T - 1)).total

    @staticmethod
    def uniform(T: int, m: int) -> "CommSchedule":
        """U-* baseline: the server broadcasts its m uniform indices (mT)."""
        return CommSchedule(
            tuple(CommOp("uniform/S_bcast", j, m, down=True) for j in range(T))
        )

    @staticmethod
    def materialize(T: int, m: int) -> "CommSchedule":
        """Theorem 2.5's ``+2mT`` term: when the downstream scheme A runs
        in-protocol on the coreset, each party receives the m selected
        indices (m down) and contributes its m per-row scalar shares (m up).

        This is the paper's composition bill.  Shipping the raw
        feature blocks of the m rows to a central solver instead costs
        ``sum_j m*d_j`` — the benchmarks account that convention explicitly
        (their ``materialize/rows`` entries); don't mix the two on one
        ledger."""
        ops = [CommOp("materialize/S_down", j, m, down=True) for j in range(T)]
        ops += [CommOp("materialize/rows_up", j, m) for j in range(T)]
        return CommSchedule(tuple(ops))


def null_ledger(ledger: Optional[CommLedger]) -> CommLedger:
    """Allow ``ledger=None`` call sites without branching everywhere."""
    return ledger if ledger is not None else CommLedger()
