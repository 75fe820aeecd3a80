"""The downstream solve + evaluation layer (port of
:mod:`repro.core.solve`).

  * :func:`fit_ridge`   — closed-form weighted ridge on the coreset rows
    (the ``weighted_gram`` kernel), Theorem 4.1's scheme A.
  * :func:`fit_kmeans`  — weighted k-means++ + Lloyd on the coreset rows
    (each Lloyd iteration ONE ``kmeans_assign_update`` launch), Theorem
    5.2's scheme A, with ``fold_in`` restarts picked by the weighted
    coreset objective (``kmeans_assign``).
  * :func:`evaluate`    — the paper's relative error: the FULL-data
    objective at the coreset-fit parameters vs at the full-data fit.
    ``rel_error = cost_fit / cost_opt - 1``; the identity coreset
    (:func:`full_data_coreset`) reproduces the full-data solve.
  * :func:`end_to_end`  — spec in, (Coreset, FitResult, EvalReport) out.

Pass ``ledger`` to ``fit_*`` to account Theorem 2.5's ``+2mT``.  The
solvers run on the dataset's device; ``backend="auto"`` takes the kernels
there on the card and the plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.api import CoresetPipeline, get_task, resolve_backend
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import Coreset
from repro_torch.core.plan import CoresetSpec
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vkmc import kmeans, kmeans_cost
from repro_torch.core.vrlr import ridge_closed_form, ridge_cost
from repro_torch.device import DeviceLike


def full_data_coreset(ds: VFLDataset) -> Coreset:
    """The identity coreset: every row once, weight 1, zero protocol cost.
    ``fit_*`` on it IS the full-data solve."""
    n = ds.n
    return Coreset(torch.arange(n, device=ds.device),
                   torch.ones((n,), dtype=torch.float32, device=ds.device), 0)


@dataclasses.dataclass(frozen=True)
class FitResult:
    """One downstream solve on one coreset: ``params`` is theta (d,) for
    ridge, centers (k, d) for k-means; ``objective`` is the WEIGHTED
    objective on the coreset itself.  ``lam``/``k`` carry the
    hyperparameter so ``evaluate`` can recompute objectives."""

    task: str                     # "ridge" | "kmeans"
    params: torch.Tensor
    coreset: Coreset
    objective: float
    lam: Optional[float] = None
    k: Optional[int] = None


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


def fit_kmeans(
    ds: VFLDataset,
    cs: Coreset,
    k: int,
    *,
    key: rng.Key,
    iters: int = 25,
    restarts: int = 1,
    backend: str = "auto",
    ledger: Optional[CommLedger] = None,
) -> FitResult:
    """Weighted k-means++ + Lloyd on the coreset rows (Theorem 5.2's
    downstream scheme).  ``restarts`` re-seeds ``kmeans`` with
    ``fold_in(key, r)`` and keeps the centers with the lowest WEIGHTED
    coreset objective — the only objective the server can evaluate
    without touching the full data."""
    if restarts < 1:
        raise ValueError(f"restarts must be >= 1, got {restarts}")
    use_kernel = resolve_backend(backend, ds.device) == "pallas"
    key = key.to(ds.device)
    XS, _, w = cs.materialize(ds, ledger)
    best, best_obj = None, float("inf")
    for r in range(restarts):
        centers = kmeans(rng.fold_in(key, r), XS, k, w, iters=iters,
                         use_kernel=use_kernel)
        obj = float(kmeans_cost(XS, centers, w, use_kernel=use_kernel))
        if best is None or obj < best_obj:
            best, best_obj = centers, obj
    if not np.isfinite(best_obj):
        raise ValueError(
            f"every k-means restart produced a non-finite objective "
            f"({best_obj}); the coreset rows or weights are degenerate"
        )
    return FitResult("kmeans", best, cs, best_obj, k=int(k))


def evaluate(
    ds: VFLDataset,
    fit: FitResult,
    *,
    key: Optional[rng.Key] = None,
    baseline: Optional[torch.Tensor] = None,
    iters: int = 25,
    restarts: int = 1,
    backend: str = "auto",
) -> EvalReport:
    """Full-data relative error of a coreset fit (the paper's y-axis).

    ``baseline`` (precomputed full-data parameters) skips the full-data
    solve.  For k-means the baseline solve needs ``key`` (the restarts
    policy of :func:`fit_kmeans`, on the identity coreset)."""
    use_kernel = resolve_backend(backend, ds.device) == "pallas"
    X, y = ds.full(), ds.y
    if fit.task == "ridge":
        cost_fit = float(ridge_cost(X, y, fit.params, fit.lam))
        if baseline is None:
            baseline = ridge_closed_form(X, y, fit.lam)
        cost_opt = float(ridge_cost(X, y, baseline, fit.lam))
    elif fit.task == "kmeans":
        cost_fit = float(kmeans_cost(X, fit.params, use_kernel=use_kernel))
        if baseline is None:
            if key is None:
                raise ValueError(
                    "evaluate needs `key` (or a precomputed `baseline`) for "
                    "the full-data k-means baseline"
                )
            baseline = fit_kmeans(ds, full_data_coreset(ds), fit.k, key=key,
                                  iters=iters, restarts=restarts,
                                  backend=backend).params
        cost_opt = float(kmeans_cost(X, baseline, use_kernel=use_kernel))
    else:
        raise ValueError(f"unknown fit task {fit.task!r}")
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
    solve_key: Optional[rng.Key] = None,
    baseline: Optional[torch.Tensor] = None,
    iters: int = 25,
    restarts: int = 1,
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = "cuda",
):
    """Spec -> coreset -> fit -> full-data evaluation, in one call, on
    ``device`` (the card unless the caller asks for the CPU).

    ``spec`` may be a task name (compiled with spec defaults).  Pass
    ``lam`` for the ridge leg or ``k`` for the k-means leg (exactly one).
    ``solve_key`` seeds the k-means solve and its baseline (default
    ``fold_in(key, 1)``; the build consumes ``key`` itself).  Returns
    ``(coreset, FitResult, EvalReport)``.
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
    cs = CoresetPipeline(ds).build(spec, key=key, ledger=ledger, device=device)
    if lam is not None:
        fit = fit_ridge(ds, cs, lam, ledger=ledger)
        return cs, fit, evaluate(ds, fit, baseline=baseline)
    sk = rng.fold_in(key, 1) if solve_key is None else solve_key
    fit = fit_kmeans(ds, cs, k, key=sk, iters=iters, restarts=restarts,
                     ledger=ledger)
    rep = evaluate(ds, fit, key=sk, baseline=baseline, iters=iters,
                   restarts=restarts)
    return cs, fit, rep


# Task name -> default downstream solver: the paper's pairing of
# construction (Alg 2/3) with downstream scheme A.
DEFAULT_SOLVER = {"vrlr": "ridge", "vkmc": "kmeans", "uniform": None}


def solver_for(task) -> Optional[str]:
    """The canonical downstream solver for a task name (None = caller's
    choice; the uniform baseline works with either)."""
    return DEFAULT_SOLVER.get(get_task(task).name)
