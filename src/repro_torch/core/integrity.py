"""Numerical-health guardrails for a coreset build.

:class:`HealthReport` summarises the scoring state a draw used — finite
fraction, per-party mass shares, zero-mass parties, Gram condition
numbers — computed host-side from the (T, cells) mass table, independent
of any injected fault.  The reference package's wire envelopes and value
validators wait for the port's transport layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np

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
