"""The :class:`Coreset` container and the :class:`MaterializedCoreset`
that the merge-and-reduce tree keeps (port of :mod:`repro.core.coreset`).

The builders live in :mod:`repro_torch.core.api`; the seed-era
``build_vrlr_coreset`` / ``build_vkmc_coreset`` / ``build_uniform_coreset``
entry points survive as deprecation shims in :mod:`repro_torch.core`.  A
``Coreset`` lives on the device that built it; a ``MaterializedCoreset``
keeps its rows in host memory (numpy), as the reference does.  The
empirical epsilon of a coreset (:func:`vrlr_coreset_ratio`,
:func:`vkmc_coreset_ratio`) is plain torch, as the reference computes it
outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.integrity import HealthReport
from repro_torch.core.vfl import VFLDataset, _as_tensor
from repro_torch.device import DeviceLike, resolve_device

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


@dataclasses.dataclass
class MaterializedCoreset:
    """A coreset together with its (host-resident) rows — the unit of state
    a long-lived serving layer keeps after the source rows are gone.

    An index :class:`Coreset` only points into a live :class:`VFLDataset`;
    a merge-and-reduce tree (:mod:`repro_torch.serve.tree`) must instead
    retain the m selected rows themselves (per party, numpy, host memory)
    so later merges can re-score them without the original data.
    ``indices`` stay GLOBAL row ids into the full stream, so the result
    still evaluates against the full dataset; ``comm_units`` is the
    protocol cost that produced this node (Thm 2.5-composed across
    merges).
    """

    indices: np.ndarray                 # (m,) int64 — global row ids
    weights: np.ndarray                 # (m,) float32
    parts: List[np.ndarray]             # party j's selected rows (m, d_j)
    y: Optional[np.ndarray] = None      # (m,), when the task carries labels
    comm_units: int = 0
    comm_bits: int = 0                  # wire bits behind those units

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def T(self) -> int:
        return len(self.parts)

    def dataset(self, device: DeviceLike = "cpu") -> VFLDataset:
        """The rows as a :class:`VFLDataset` on ``device`` — host memory by
        default, as the reference keeps them; a merge asks for the device
        it re-scores on."""
        dev = resolve_device(device)
        return VFLDataset([_as_tensor(p, dev) for p in self.parts],
                          None if self.y is None else _as_tensor(self.y, dev))

    def coreset(self, device: DeviceLike = "cuda") -> Coreset:
        """The index/weight view (global ids) on ``device``, for
        ledger-free evaluation against the full dataset."""
        dev = resolve_device(device)
        return Coreset(torch.tensor(self.indices, dtype=torch.int64, device=dev),
                       torch.tensor(self.weights, dtype=torch.float32, device=dev),
                       self.comm_units, comm_bits=self.comm_bits)

    @staticmethod
    def from_coreset(
        cs: Coreset, ds: VFLDataset, offset: int = 0
    ) -> "MaterializedCoreset":
        """Materialize ``cs``'s rows out of ``ds`` into host memory.
        ``offset`` shifts the (ds-local) indices into the global row space —
        the leaf case of the merge-and-reduce tree, where ``ds`` is one
        arriving superchunk starting at global row ``offset``.  The rows
        are gathered where ``ds`` lives and copied to the host; the indices
        cross once."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        idx = cs.indices.cpu().numpy().astype(np.int64)
        if idx.size and offset > np.iinfo(np.int64).max - int(idx.max()):
            raise OverflowError(
                f"global id overflow: offset {offset} + max local index "
                f"{int(idx.max())} exceeds int64"
            )
        sel = (torch.from_numpy(idx) if ds.device.type == "cpu"
               else cs.indices.to(device=ds.device, dtype=torch.int64))
        return MaterializedCoreset(
            indices=idx + offset,
            weights=cs.weights.cpu().numpy(),
            parts=[p[sel].cpu().numpy() for p in ds.parts],
            y=None if ds.y is None else ds.y[sel].cpu().numpy(),
            comm_units=int(cs.comm_units),
            comm_bits=int(cs.comm_bits),
        )

    @staticmethod
    def concat(mats: List["MaterializedCoreset"]) -> "MaterializedCoreset":
        """The weighted union of several materialized coresets (rows and
        weights concatenated; no re-sampling, no protocol cost — union is
        server-side bookkeeping).  ``comm_units`` sums the children's."""
        if not mats:
            raise ValueError("concat needs at least one coreset")
        T = mats[0].T
        if any(m.T != T for m in mats):
            raise ValueError("party counts differ across coresets")
        widths = tuple(p.shape[1] for p in mats[0].parts)
        for i, mt in enumerate(mats[1:], start=1):
            w = tuple(p.shape[1] for p in mt.parts)
            if w != widths:
                raise ValueError(
                    f"party widths differ across coresets: coreset 0 has "
                    f"{widths}, coreset {i} has {w}"
                )
        has_y = mats[0].y is not None
        if any((m.y is not None) != has_y for m in mats):
            raise ValueError("label presence differs across coresets")
        return MaterializedCoreset(
            indices=np.concatenate([m.indices for m in mats]),
            weights=np.concatenate([m.weights for m in mats]),
            parts=[np.concatenate([m.parts[j] for m in mats])
                   for j in range(T)],
            y=np.concatenate([m.y for m in mats]) if has_y else None,
            comm_units=sum(m.comm_units for m in mats),
            comm_bits=sum(m.comm_bits for m in mats),
        )


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
