"""The :class:`Coreset` container (port of :mod:`repro.core.coreset`).

The builders live in :mod:`repro_torch.core.api`.  The merge-and-reduce
``MaterializedCoreset`` waits for the serving slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.integrity import HealthReport
from repro_torch.core.vfl import VFLDataset


@dataclasses.dataclass
class Coreset:
    """Index coreset: indices into the original rows + importance weights.

    Per Problem 1, the coreset is indices/weights — never raw rows — so the
    construction itself moves no feature data across parties.  ``health``
    is the :class:`~repro_torch.core.integrity.HealthReport` of the scoring
    state the draw used (None for the uniform baseline and the identity
    coreset).
    """

    indices: torch.Tensor   # (m,) int
    weights: torch.Tensor   # (m,) float32
    comm_units: int         # construction cost in paper units
    #: Construction cost in wire bits (32 bits/unit on the raw wire, the
    #: mass-table row billed at its packed size).
    comm_bits: int = 0
    health: Optional[HealthReport] = None

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    def materialize(
        self, ds: VFLDataset, ledger: Optional[CommLedger] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """(X_S, y_S, w) on the server.

        Running the downstream scheme on the coreset costs Theorem 2.5's
        ``+2mT`` extra units (each party: m indices down, m per-row scalar
        shares up); pass ``ledger`` to record them via
        ``CommSchedule.materialize``.
        """
        CommSchedule.materialize(ds.T, self.m).record(ledger)
        sub = ds.rows(self.indices.to(ds.device))
        return sub.full(), sub.y, self.weights.to(ds.device)
