"""The downstream solve + evaluation layer for the ridge leg (port of
:mod:`repro.core.solve`).

  * :func:`fit_ridge`   — closed-form weighted ridge on the coreset rows
    (the ``weighted_gram`` kernel), Theorem 4.1's scheme A.
  * :func:`evaluate`    — the paper's relative error: the FULL-data
    objective at the coreset-fit parameters vs at the full-data fit
    (solved through ``weighted_gram`` at the full n).  ``rel_error =
    cost_fit / cost_opt - 1``; the identity coreset
    (:func:`full_data_coreset`) reproduces the full-data solve.
  * :func:`end_to_end`  — spec in, (Coreset, FitResult, EvalReport) out.

The k-means leg (``fit_kmeans``, ``k=``) waits for the k-means kernels.
Pass ``ledger`` to ``fit_ridge`` to account Theorem 2.5's ``+2mT``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch import rng
from repro_torch.core.api import CoresetPipeline
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import Coreset
from repro_torch.core.plan import CoresetSpec
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vrlr import ridge_closed_form, ridge_cost
from repro_torch.device import DeviceLike


def full_data_coreset(ds: VFLDataset) -> Coreset:
    """The identity coreset: every row once, weight 1, zero protocol cost.
    ``fit_ridge`` on it IS the full-data solve."""
    n = ds.n
    return Coreset(torch.arange(n, device=ds.device),
                   torch.ones((n,), dtype=torch.float32, device=ds.device), 0)


@dataclasses.dataclass(frozen=True)
class FitResult:
    """One downstream solve on one coreset: ``params`` is theta (d,);
    ``objective`` is the WEIGHTED objective on the coreset itself."""

    task: str                     # "ridge"
    params: torch.Tensor
    coreset: Coreset
    objective: float
    lam: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EvalReport:
    """The paper's relative-error ratio on the FULL data:
    ``rel_error = cost_fit / cost_opt - 1``."""

    task: str
    cost_fit: float
    cost_opt: float
    rel_error: float
    m: int
    n: int
    comm_units: int


def fit_ridge(
    ds: VFLDataset,
    cs: Coreset,
    lam: float,
    *,
    ledger: Optional[CommLedger] = None,
) -> FitResult:
    """Closed-form weighted ridge on the coreset rows (Theorem 4.1's
    downstream scheme): argmin_theta sum_{i in S} w_i (x_i^T theta - y_i)^2
    + lam ||theta||^2."""
    if ds.y is None:
        raise ValueError("fit_ridge requires labels at party T")
    XS, yS, w = cs.materialize(ds, ledger)
    theta = ridge_closed_form(XS, yS, lam, w)
    obj = float(ridge_cost(XS, yS, theta, lam, w))
    return FitResult("ridge", theta, cs, obj, lam=float(lam))


def evaluate(
    ds: VFLDataset,
    fit: FitResult,
    *,
    baseline: Optional[torch.Tensor] = None,
) -> EvalReport:
    """Full-data relative error of a coreset fit (the paper's y-axis).
    ``baseline`` (precomputed full-data parameters) skips the full-data
    solve."""
    if fit.task != "ridge":
        raise NotImplementedError(
            f"evaluate supports the ridge leg only; {fit.task!r} waits for "
            f"the vkmc slice (ROADMAP.md queue 1, item 9)")
    X, y = ds.full(), ds.y
    cost_fit = float(ridge_cost(X, y, fit.params, fit.lam))
    if baseline is None:
        baseline = ridge_closed_form(X, y, fit.lam)
    cost_opt = float(ridge_cost(X, y, baseline, fit.lam))
    rel = cost_fit / max(cost_opt, 1e-30) - 1.0
    return EvalReport(fit.task, cost_fit, cost_opt, rel,
                      m=fit.coreset.m, n=ds.n,
                      comm_units=fit.coreset.comm_units)


def end_to_end(
    spec: Union[CoresetSpec, str],
    ds: VFLDataset,
    *,
    key: rng.Key,
    lam: Optional[float] = None,
    k: Optional[int] = None,
    baseline: Optional[torch.Tensor] = None,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = "cuda",
):
    """Spec -> coreset -> fit -> full-data evaluation, in one call, on
    ``device`` (the card unless the caller asks for the CPU).

    ``spec`` may be a task name (compiled with spec defaults).  Pass
    ``lam`` for the ridge leg.  Returns ``(coreset, FitResult,
    EvalReport)``.
    """
    if isinstance(spec, str):
        spec = CoresetSpec(task=spec)
    if spec.is_grid:
        raise ValueError(
            "end_to_end runs one construction; build grids with "
            "CoresetPipeline.build and fit cells individually"
        )
    if (lam is None) == (k is None):
        raise ValueError("pass exactly one of `lam` (ridge) or `k` (k-means)")
    if k is not None:
        raise NotImplementedError(
            "the k-means leg waits for the vkmc slice (ROADMAP.md queue 1, "
            "item 9)")
    cs = CoresetPipeline(ds).build(spec, key=key, ledger=ledger, device=device)
    fit = fit_ridge(ds, cs, lam, ledger=ledger)
    return cs, fit, evaluate(ds, fit, baseline=baseline)
