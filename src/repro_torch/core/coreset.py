"""The :class:`Coreset` container (port of :mod:`repro.core.coreset`).

The builders live in :mod:`repro_torch.core.api`.  The merge-and-reduce
``MaterializedCoreset`` waits for the serving slice.  The empirical
epsilon of a coreset (:func:`vrlr_coreset_ratio`,
:func:`vkmc_coreset_ratio`) is plain torch, as the reference computes it
outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.integrity import HealthReport
from repro_torch.core.vfl import VFLDataset

if TYPE_CHECKING:
    from repro_torch.core.faults import DegradedBuild


@dataclasses.dataclass
class Coreset:
    """Index coreset: indices into the original rows + importance weights.

    Per Problem 1, the coreset is indices/weights — never raw rows — so the
    construction itself moves no feature data across parties.  ``health``
    is the :class:`~repro_torch.core.integrity.HealthReport` of the scoring
    state the draw used (None for the uniform baseline and the identity
    coreset).  ``degraded`` (default None: a full-federation build) is the
    :class:`~repro_torch.core.faults.DegradedBuild` receipt when the
    construction continued without every party under
    ``fault_policy="degrade"`` or ``"quarantine"``.
    """

    indices: torch.Tensor   # (m,) int
    weights: torch.Tensor   # (m,) float32
    comm_units: int         # construction cost in paper units
    #: Construction cost in wire bits (32 bits/unit on the raw wire, the
    #: mass-table row billed at its packed size).
    comm_bits: int = 0
    degraded: Optional["DegradedBuild"] = None
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


def vrlr_coreset_ratio(ds: VFLDataset, cs: Coreset, thetas: torch.Tensor,
                       lam: float) -> torch.Tensor:
    """max_theta |cost^R(S,theta)/cost^R(X,theta) - 1| over a probe set of
    thetas (P, d) (empirical epsilon; Definition 2.3)."""
    X, y = ds.full(), ds.y
    XS, yS, w = cs.materialize(ds)
    thetas = thetas.to(X.device)
    reg = lam * torch.sum(thetas * thetas, dim=1)                   # (P,)
    full = torch.sum((X @ thetas.T - y[:, None]) ** 2, dim=0) + reg
    sub = torch.sum(w[:, None] * (XS @ thetas.T - yS[:, None]) ** 2, dim=0) + reg
    return torch.max(torch.abs(sub / full - 1.0))


def vkmc_coreset_ratio(ds: VFLDataset, cs: Coreset,
                       center_sets: torch.Tensor) -> torch.Tensor:
    """max_C |cost^C(S,C)/cost^C(X,C) - 1| over probe center sets
    (P, k, d) (empirical epsilon; Definition 2.4)."""
    X = ds.full()
    XS, _, w = cs.materialize(ds)

    def min_d2(A: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
        return torch.min(torch.sum((A[:, None, :] - C[None, :, :]) ** 2, dim=-1),
                         dim=1).values

    ratios = [torch.abs((w * min_d2(XS, C)).sum() / min_d2(X, C).sum() - 1.0)
              for C in center_sets.to(X.device)]
    return torch.max(torch.stack(ratios))
