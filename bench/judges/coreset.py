"""The comparison that decides ``correct`` for a coreset configuration
(its ``check.judge`` is ``"coreset"``): the program's answers against the
plain reference (``bench/reference``), after the window has closed.

A sample of the window's requests (:func:`sample_requests`, ``check.requests``
of them) is judged cell by cell:

* ``weight_err``: the largest relative gap between a coreset weight and
  the reference's G / (m sum_j g_i^(j)) at the same row, over every row:
  the scores (Algorithm 2 or 3) and the party totals.
  ``weight_off_share``: the largest share of a cell's rows whose gap
  passes the configuration's ``check.weight_row_tol``.
* ``draw_gap``: the widest gap by which a drawn candidate's value (gumbel
  plus log score, the reference's) lies below the best value of its draw:
  round 1 (the counts a_j; for counts that differ, the cheapest draws
  that would have to move) and round 2 at ``rows_per_cell`` rows of S
  drawn from the seed, each row's winner recomputed over all n rows.
  A correct draw reads 0, or a rounding-sized gap at a near tie.
* ``bill_gap``: the bill against Theorem 2.5's 2T + m + 2mT, and the
  ledger after the fit against that + 2mT (exact).
* ``fit_err``: theta, or the centers, against the reference's fit of the
  same coreset (the program's rows and weights, read to judge the fit
  stage alone); ``objective_err``: the fit's objective likewise.
* ``failed``: requests that raised.

Each number is the largest over the judged cells, but two that read the
run's fits together: ``fit_off_share``, the share of the judged fits whose
``fit_err`` passes the configuration's ``check.fit_row_tol`` (or is NaN),
and ``objective_err_median``, the median ``objective_err``.  Lloyd's 25
steps carry one near-tie assignment that float32 and float64 decide apart
(about 2% of fits) to centers a few percent apart, so a sound run may hold
such a fit, and its worst fit reads as the control's best does; a fault
on a few fits of the run, or the control, moves many.  The
configuration's ``check.limits`` says which are compared and with what
limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchlib.coreset import Fitted
from benchlib.coreset import parts as split_parts
from benchlib.traffic import Request
from reference import algorithms as ref

NUMBERS = ("weight_err", "weight_off_share", "draw_gap", "bill_gap", "fit_err",
           "fit_off_share", "objective_err", "objective_err_median", "failed")
#: numbers read from the judged cells together: (the cells' number, how);
#: the rest are the largest over the cells
ACROSS = {"fit_off_share": ("fit_off", np.mean),
          "objective_err_median": ("objective_err", np.median)}


class Judge:
    """The reference side of one run: the inputs the benchmark made, the
    configuration, and the reference's scores where they do not depend on
    the key (Algorithm 2)."""

    def __init__(self, cfg: dict, inputs):
        X, y = inputs
        self.cfg, self.X, self.y = cfg, X, y
        self.parts = split_parts(X, cfg["dims"])
        self.T, self.n = len(self.parts), X.shape[0]
        self._vrlr = {}

    def scores(self, key, p: ref.Precision):
        """(T, n) scores and the DIS key for a request's build key."""
        if self.cfg["task"] == "vrlr":
            if p.name not in self._vrlr:
                self._vrlr[p.name] = ref.vrlr_scores(self.parts, self.y, p)
            return self._vrlr[p.name], key
        tp = self.cfg["task_params"]
        return ref.vkmc_scores(key, self.parts, int(tp["k"]), float(tp["alpha"]),
                               int(tp["local_iters"]), p)

    def fit(self, cell: Fitted, fit_key, p: ref.Precision):
        """The reference's fit of the coreset (S, w) and its objective."""
        dev = self.X.device
        S = cell.indices.to(dev)
        w = cell.weights.to(dev)
        f = self.cfg["fit"]
        if f["kind"] == "ridge":
            return ref.ridge(self.X[S], self.y[S], w, float(f["lam_per_row"]) * self.n, p)
        return ref.kmeans_fit(fit_key, self.X[S], w, int(f["k"]), int(f["iters"]), p)


def _round1_gap(d: ref.Dis, counts: List[int]) -> float:
    """The widest gap of the cheapest round-1 draws that would have to move
    to turn the reference's counts into ``counts``; 0 when they agree."""
    delta = torch.tensor(counts, device=d.counts.device) - d.counts
    if not bool(delta.any()):
        return 0.0
    best = torch.argmax(d.round1, dim=1)
    top = d.round1.max(dim=1).values
    movable = delta[best] < 0
    gap = 0.0
    for j in torch.nonzero(delta > 0).flatten().tolist():
        cost = torch.where(movable, top - d.round1[:, j],
                           torch.full_like(top, float("inf")))
        need = int(delta[j])
        if need > int(movable.sum()):
            return float("inf")
        gap = max(gap, float(torch.topk(cost, need, largest=False).values.max()))
    return gap


def _round2_gap(d: ref.Dis, cell: Fitted, rows: int, rng) -> float:
    """The widest gap at ``rows`` positions of S drawn from ``rng``."""
    dev = d.scores.device
    counts = cell.counts
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.sort(rng.choice(cell.m, size=min(rows, cell.m), replace=False))
    S = cell.indices.to(dev)
    gap = 0.0
    for j in range(len(counts)):
        sel = pos[(pos >= starts[j]) & (pos < starts[j + 1])]
        sel = sel[sel - starts[j] < int(d.counts[j])]   # rows the reference's count has
        r = sel - starts[j]
        for a in range(0, len(r), 32):
            rr = torch.as_tensor(r[a:a + 32], dtype=torch.int64, device=dev)
            v = d.row_values(j, rr)
            got = v.gather(1, S[torch.as_tensor(sel[a:a + 32], device=dev)][:, None])[:, 0]
            gap = max(gap, float((v.max(dim=1).values - got).max()))
    return gap


def judge_cell(judge: Judge, req: Request, cell: Fitted, scores, dis_key,
               rows: int, rng) -> Dict[str, float]:
    """Every number of one cell, the reference in float64."""
    d = ref.dis(dis_key, scores, cell.m, cell.cap, ref.FLOAT64)
    S = cell.indices.to(judge.X.device)
    w_ref = d.weights(S)
    rel = ((cell.weights.to(w_ref) - w_ref).abs() / w_ref)
    if len(cell.counts) != judge.T or sum(cell.counts) != cell.m:
        draw = float("inf")
    else:
        draw = max(_round1_gap(d, cell.counts), _round2_gap(d, cell, rows, rng))
    units = ref.bill(judge.T, cell.m)
    bill = max(abs(cell.comm_units - units),
               abs(cell.ledger_total - units - ref.fit_bill(judge.T, cell.m)))
    params, obj = judge.fit(cell, req.fit_key, ref.FLOAT64)
    got = cell.params.to(params)
    if params.ndim == 1:
        fit = float(torch.linalg.norm(got - params) / torch.linalg.norm(params))
    else:
        scale = torch.sqrt(torch.mean(torch.sum(params * params, dim=1)))
        fit = float(torch.linalg.norm(got - params, dim=1).max() / scale)
    tol = judge.cfg["check"]
    return {"weight_err": float(rel.max()),
            "weight_off_share": float((rel > float(tol.get("weight_row_tol", "inf")))
                                      .double().mean()),
            "draw_gap": draw, "bill_gap": float(bill), "fit_err": fit,
            "fit_off": float(not fit <= float(tol.get("fit_row_tol", "inf"))),
            "objective_err": abs(cell.objective - obj) / abs(obj)}


def judge_cells(cfg: dict, inputs, judged: list, seed: int) -> List[Dict[str, float]]:
    """Every judged cell's numbers, ``judged`` being [(Request, [Fitted])]."""
    j = Judge(cfg, inputs)
    rng = np.random.default_rng([int(seed), 3])
    rows = int(cfg["check"]["rows_per_cell"])
    per_cell = []
    for req, req_cells in judged:
        scores, dis_key = j.scores(req.key, ref.FLOAT64)
        for cell in req_cells:
            per_cell.append(judge_cell(j, req, cell, scores, dis_key, rows, rng))
    return per_cell


def sample_requests(done: Sequence[Tuple[Request, list]], k: int, seed: int) -> list:
    """``k`` of the completed requests, drawn from the seed, with one of the
    largest budget among them."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed), 2])
    pick = sorted(rng.choice(len(done), size=min(k, len(done)), replace=False).tolist())
    top = max(max(r.ms) for r, _ in done)
    if not any(max(done[i][0].ms) == top for i in pick):
        longest = [i for i, (r, _) in enumerate(done) if max(r.ms) == top]
        pick[-1] = longest[int(rng.integers(len(longest)))]
    return [done[i] for i in sorted(set(pick))]


def judge(cfg: dict, inputs, done: list, seed: int, failed: int) -> Dict[str, float]:
    """The run's numbers over a sample of ``done``, the window's completed
    requests [(Request, [Fitted])]: each the largest over the judged cells,
    or as :data:`ACROSS` says; NaN where no cell was judged."""
    judged = sample_requests(done, int(cfg["check"]["requests"]), seed)
    return aggregate(judge_cells(cfg, inputs, judged, seed), failed)


def aggregate(per_cell: List[Dict[str, float]], failed: int) -> Dict[str, float]:
    out = {"failed": float(failed)}
    for k in NUMBERS:
        if k == "failed":
            continue
        cell_key, how = ACROSS.get(k, (k, np.max))
        v = np.array([c[cell_key] for c in per_cell])
        out[k] = float("nan") if not per_cell or np.isnan(v).any() else float(how(v))
    return out


def reference_serve(cfg: dict, mix: dict, engine, inputs, req: Request,
                    p: ref.Precision) -> List[Fitted]:
    """The reference in the program's place: every cell of ``req`` served
    by the plain reference in precision ``p`` (the control, in TF32), at
    the draw capacity of the mix's ``engine`` module.  Its draw covers
    every row, so it costs about a millisecond a row."""
    j = Judge(cfg, inputs)
    scores, dis_key = j.scores(req.key, p)
    T = j.T
    cells = []
    for m in req.ms:
        cap = engine.capacity(mix, req.ms)
        d = ref.dis(dis_key, scores, m, cap, p)
        S = d.draw_all()
        w = d.weights(S).to(torch.float32)
        cell = Fitted(m, cap, d.counts.tolist(), ref.bill(T, m),
                      ref.bill(T, m) + ref.fit_bill(T, m), S.cpu(), w.cpu(),
                      torch.zeros(0), 0.0)
        params, obj = j.fit(cell, req.fit_key, p)
        cell.params, cell.objective = params.cpu(), float(obj)
        cells.append(cell)
    return cells
