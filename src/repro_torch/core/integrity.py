"""Integrity layer: checksummed wire envelopes, value-level validators and
numerical-health guardrails (port of :mod:`repro.core.integrity`).

A single silently corrupted round-1 mass table skews the DIS sampling
distribution without raising any error.  Three independent defenses:

* :class:`WireEnvelope` — a CRC32 digest of the payload's raw bytes plus a
  shape/dtype header, sealed by the sender and verified on delivery by
  :class:`~repro_torch.core.faults.Transport`; a mismatch is retransmitted
  and billed under ``retry/<tag>``.  Under a :mod:`repro_torch.core.wire`
  codec the envelope seals the ENCODED bytes.
* Value-level validators (:func:`check_mass_table`, :func:`check_weights`,
  :func:`check_merge_children`) — host-side numpy checks at every
  accumulation seam, raising a party-attributed :exc:`IntegrityError`
  under ``fault_policy="fail"`` or naming the offenders for quarantine.
* :class:`HealthReport` — finite fractions, per-party mass shares, zero-mass
  parties and Gram condition numbers of the scoring state a draw used.

Everything here is host-side numpy on bytes: digests equal the reference
package's byte for byte, the validators consume no PRNG state and touch no
ledger when the data is clean.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


class IntegrityError(RuntimeError):
    """A value-level integrity violation, attributed to the offending party.

    ``party`` is the party index the violation is pinned on (or ``None``
    when the violation cannot be attributed to a single party, e.g. a
    server-side merge invariant)."""

    def __init__(self, party: Optional[int], reason: str,
                 tag: Optional[str] = None) -> None:
        who = "server" if party is None else f"party {party}"
        where = f" on {tag!r}" if tag else ""
        super().__init__(f"integrity violation by {who}{where}: {reason}")
        self.party = None if party is None else int(party)
        self.tag = tag
        self.reason = reason


def payload_digest(payload: Any) -> int:
    """CRC32 of the payload's raw bytes — stable across processes (Python's
    ``hash`` is salted per process and would break replayable envelopes)."""
    arr = np.ascontiguousarray(np.asarray(payload))
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WireEnvelope:
    """Sender-sealed integrity header for one wire payload: a byte digest
    plus the declared shape/dtype, verified on delivery."""

    tag: str
    party: int
    shape: Tuple[int, ...]
    dtype: str
    digest: int

    @staticmethod
    def seal(tag: str, party: int, payload: Any) -> "WireEnvelope":
        arr = np.asarray(payload)
        return WireEnvelope(tag, int(party), tuple(arr.shape),
                            str(arr.dtype), payload_digest(arr))

    @staticmethod
    def seal_bytes(tag: str, party: int, blob: bytes) -> "WireEnvelope":
        """Seal a codec's packed byte string (the compressed-wire form:
        the digest covers the ENCODED payload, so verify against the
        received blob's uint8 view)."""
        return WireEnvelope.seal(tag, party, np.frombuffer(blob, np.uint8))

    def mismatch(self, payload: Any) -> Optional[str]:
        """Why the received payload fails verification, or None if it
        passes.  Shape and dtype are checked before the digest so a header
        mismatch names itself instead of reading as random bit damage."""
        arr = np.asarray(payload)
        if tuple(arr.shape) != self.shape:
            return f"shape {tuple(arr.shape)} != sealed {self.shape}"
        if str(arr.dtype) != self.dtype:
            return f"dtype {arr.dtype} != sealed {self.dtype}"
        if payload_digest(arr) != self.digest:
            return "payload digest mismatch"
        return None

    def verify(self, payload: Any) -> bool:
        return self.mismatch(payload) is None


# --------------------------------------------------------------------------
# Value-level validators
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One validator hit: which party, and why."""

    party: int
    reason: str


def check_mass_table(
    masses: Any,
    totals: Optional[Any] = None,
    *,
    bound: Optional[float] = None,
    rel_tol: float = 1e-4,
    bound_slack: float = 1.05,
) -> List[Finding]:
    """Validate a (T, cells) mass table at the server's accumulation seam.

    Per party: every entry finite, every entry nonnegative, and — when the
    independently communicated round-1 scalar totals are given — the row
    sum must agree with the party's own declared total within ``rel_tol``
    (a lying party cannot keep both stories straight without also faking
    the scalar round the schedule bills separately).  When ``bound`` is the
    task's total-sensitivity bound (Thm 4.2 / Lemma F.2), the grand total
    must stay within ``bound_slack`` of it; an excess is attributed to the
    party with the largest row sum.  Returns findings in party order.
    """
    m = np.asarray(masses, dtype=np.float64)
    findings: List[Finding] = []
    t = None if totals is None else np.asarray(totals, dtype=np.float64)
    for j, row in enumerate(m):
        finite = np.isfinite(row)
        if not finite.all():
            bad = int((~finite).sum())
            findings.append(Finding(j, f"mass table has {bad} non-finite "
                                       f"entr{'y' if bad == 1 else 'ies'}"))
            continue
        if (row < 0.0).any():
            findings.append(Finding(
                j, f"negative mass (min {row.min():.6g}); sensitivities "
                   f"are nonnegative by construction"))
            continue
        if t is not None:
            s = float(row.sum())
            declared = float(t[j])
            if not np.isfinite(declared):
                findings.append(Finding(j, "non-finite round-1 scalar total"))
                continue
            tol = rel_tol * max(abs(s), abs(declared), 1.0)
            if abs(s - declared) > tol:
                findings.append(Finding(
                    j, f"mass row sums to {s:.6g} but the round-1 scalar "
                       f"total was {declared:.6g}"))
    if bound is not None and not findings:
        grand = float(m.sum())
        if np.isfinite(grand) and grand > bound_slack * bound:
            worst = int(np.argmax(m.sum(axis=1)))
            findings.append(Finding(
                worst, f"total sensitivity {grand:.6g} exceeds the task "
                       f"bound {bound:.6g} (x{bound_slack} slack); largest "
                       f"contribution from party {worst}"))
    return findings


def require_valid_masses(
    masses: Any,
    totals: Optional[Any] = None,
    *,
    bound: Optional[float] = None,
    tag: str = "dis/round1/G_j",
    policy: str = "fail",
    rel_tol: float = 1e-4,
) -> Tuple[int, ...]:
    """Run the mass-table validators under a fault policy.

    Under ``"quarantine"`` the sorted offender set is returned for the
    caller's degrade machinery; under any other policy the first finding
    raises a party-attributed :exc:`IntegrityError`.  Clean data returns
    ``()`` either way.  ``rel_tol`` widens the row-sum/scalar cross-check
    for quantized wire tables (the caller knows the codec's tolerance);
    the finiteness/nonnegativity/bound checks are tolerance-independent."""
    findings = check_mass_table(masses, totals, bound=bound, rel_tol=rel_tol)
    if not findings:
        return ()
    if policy == "quarantine":
        return tuple(sorted({f.party for f in findings}))
    f = findings[0]
    raise IntegrityError(f.party, f.reason, tag=tag)


def check_weights(weights: Any) -> Optional[str]:
    """Realized coreset weights must be positive and finite — anything else
    means a corrupted mass total or score leaked into the draw.  Returns
    the violation string, or None."""
    w = np.asarray(weights, dtype=np.float64)
    if w.size == 0:
        return "empty weight vector"
    finite = np.isfinite(w)
    if not finite.all():
        return f"{int((~finite).sum())} non-finite weight(s)"
    if (w <= 0.0).any():
        return f"min weight {w.min():.6g} <= 0"
    return None


def check_merge_children(
    indices: Sequence[Any], weights: Sequence[Any]
) -> None:
    """Tree-merge pre-checks: every child's weights positive/finite, and no
    global id appears in two DIFFERENT children.

    Children of a merge summarize DISJOINT stream segments, so a cross-child
    id collision means a corrupted upload or a broken offset chain.  (Ids
    may legitimately repeat WITHIN a child — DIS samples with replacement.)
    Raises :exc:`IntegrityError` naming the offending child as the party."""
    for c, w in enumerate(weights):
        why = check_weights(w)
        if why is not None:
            raise IntegrityError(c, f"merge child {c}: {why}",
                                 tag="merge/children")
    for a in range(len(indices)):
        ia = np.unique(np.asarray(indices[a]))
        for b in range(a + 1, len(indices)):
            clash = np.intersect1d(ia, np.asarray(indices[b]))
            if clash.size:
                raise IntegrityError(
                    b, f"merge children {a} and {b} share {clash.size} "
                       f"global id(s) (first: {int(clash[0])}); children "
                       f"must summarize disjoint stream segments",
                    tag="merge/children")


# --------------------------------------------------------------------------
# Numerical-health guardrails (fault-independent)
# --------------------------------------------------------------------------

GRAM_COND_WARN = 1e8


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Numerical health of one build's scoring state — computed host-side
    from the mass table (and, for streaming VRLR, the accumulated Gram
    spectra), independent of any injected fault.

    ``max_cell_share`` is the largest single cell's share of the total
    sensitivity G — the sampling concentration (a share near 1 means the
    coreset draw is dominated by one (party, block) cell)."""

    finite_fraction: float
    mass_total: float
    max_cell_share: float
    party_shares: Tuple[float, ...]
    zero_mass_parties: Tuple[int, ...] = ()
    gram_conds: Optional[Tuple[float, ...]] = None
    notes: Tuple[str, ...] = ()

    @property
    def healthy(self) -> bool:
        return (self.finite_fraction == 1.0 and self.mass_total > 0.0
                and not self.zero_mass_parties and not self.notes)

    def describe(self) -> str:
        lines = [
            f"HealthReport: {'healthy' if self.healthy else 'WARNINGS'}",
            f"  finite fraction: {self.finite_fraction:.6f}",
            f"  total sensitivity G: {self.mass_total:.6g}",
            f"  max cell share: {self.max_cell_share:.4f}",
            "  party shares: "
            + ", ".join(f"{s:.4f}" for s in self.party_shares),
        ]
        if self.gram_conds is not None:
            lines.append("  Gram condition numbers: "
                         + ", ".join(f"{c:.3g}" for c in self.gram_conds))
        if self.zero_mass_parties:
            lines.append(f"  zero-mass parties: "
                         f"{list(self.zero_mass_parties)}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def health_from_masses(
    masses: Any,
    gram_conds: Optional[Any] = None,
    cond_warn: float = GRAM_COND_WARN,
) -> HealthReport:
    """Build a :class:`HealthReport` from any (T, cells) nonnegative mass
    table — per-row scores for the materialized engine (cells = rows), the
    (T, num_blocks) block table for the streaming engines."""
    m = np.asarray(masses, dtype=np.float64)
    if m.ndim != 2:
        m = m.reshape(len(m), -1)
    finite = np.isfinite(m)
    total_cells = max(m.size, 1)
    finite_fraction = float(finite.sum()) / total_cells
    clean = np.where(finite, m, 0.0)
    party_sums = clean.sum(axis=1)
    total = float(party_sums.sum())
    shares = tuple(float(s / total) if total > 0 else 0.0
                   for s in party_sums)
    max_share = float(clean.max() / total) if total > 0 else 0.0
    zero = tuple(int(j) for j, s in enumerate(party_sums) if s <= 0.0)
    notes: List[str] = []
    if finite_fraction < 1.0:
        notes.append(f"{m.size - int(finite.sum())} non-finite mass entries")
    if total <= 0.0:
        notes.append("zero total sensitivity — DIS cannot sample")
    conds: Optional[Tuple[float, ...]] = None
    if gram_conds is not None:
        conds = tuple(float(c) for c in np.asarray(gram_conds, np.float64))
        for j, c in enumerate(conds):
            if not np.isfinite(c):
                notes.append(f"party {j} Gram is singular (constant or "
                             f"all-zero feature slice)")
            elif c > cond_warn:
                notes.append(f"party {j} Gram condition {c:.3g} exceeds "
                             f"{cond_warn:.0e}")
    return HealthReport(
        finite_fraction=finite_fraction, mass_total=total,
        max_cell_share=max_share, party_shares=shares,
        zero_mass_parties=zero, gram_conds=conds, notes=tuple(notes),
    )
