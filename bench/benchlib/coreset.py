"""The coreset program under test, set up for one configuration: the
parties' ``VFLDataset`` on the device, a build on the mix's engine
(``bench/engines/<engine>.py``), then the configuration's fit on every
coreset it returned.

With the engines, this is the only code of the harness that calls the
program (``repro_torch``): ``fit_ridge`` or ``fit_kmeans``, each on the
engine's ``CommLedger`` so that the bill, and round 1's counts, are read
from what the program recorded.  What it returns for each coreset is a
:class:`Fitted`, the form the correctness check reads; the reference can
fill the same form (``bench/judges/coreset.py``'s ``reference_serve``),
which is how the control takes the program's place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List

import torch


@dataclasses.dataclass
class Fitted:
    """One fitted coreset of a request, on the host."""

    m: int
    cap: int                      # the draw's capacity (the batched grid's m_cap)
    counts: List[int]             # round 1's a_j
    comm_units: int               # the build's bill
    ledger_total: int             # the bill after the fit
    indices: torch.Tensor         # (m,) int64
    weights: torch.Tensor         # (m,) float32
    params: torch.Tensor          # theta (d,) or centers (k, d)
    objective: float


def parts(X: torch.Tensor, dims) -> list:
    """The column blocks of the parties, in order."""
    out, a = [], 0
    for w in dims:
        out.append(X[:, a:a + int(w)].contiguous())
        a += int(w)
    return out


def _span(name: str, traced: bool):
    if not traced:
        return contextlib.nullcontext()
    return torch.profiler.record_function("bench." + name)


class CoresetProgram:
    """The system under test for one configuration and mix; ``build(self,
    req)`` is the engine's, returning ``[(Coreset, ledger, cap)]``."""

    def __init__(self, cfg: dict, mix: dict, inputs, build: Callable, traced: bool = False):
        from repro_torch.core.vfl import VFLDataset

        X, y = inputs
        self.cfg, self.mix, self.traced, self._build = cfg, mix, traced, build
        self.ds = VFLDataset(parts(X, cfg["dims"]), y)
        self.dev = self.ds.device
        self.task = cfg["task"]
        self.params = dict(cfg.get("task_params", {}))
        self.fit_cfg = cfg["fit"]
        self.lam = float(self.fit_cfg.get("lam_per_row", 0.0)) * self.ds.n

    @staticmethod
    def key(words) -> torch.Tensor:
        return torch.tensor(list(words), dtype=torch.int64)

    def _fit(self, cs, led, req):
        from repro_torch.core.solve import fit_kmeans, fit_ridge

        if self.fit_cfg["kind"] == "ridge":
            return fit_ridge(self.ds, cs, self.lam, ledger=led)
        return fit_kmeans(self.ds, cs, int(self.fit_cfg["k"]), key=self.key(req.fit_key),
                          iters=int(self.fit_cfg["iters"]),
                          restarts=int(self.fit_cfg.get("restarts", 1)), ledger=led)

    def serve(self, req) -> list:
        """Build and fit; returns ``[(Coreset, ledger, cap, FitResult, host
        params)]``.  Ends with every fitted parameter on the host."""
        with _span("build", self.traced):
            built = self._build(self, req)
            if self.traced and self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        out = []
        for cs, led, cap in built:
            with _span("fit", self.traced):
                fit = self._fit(cs, led, req)
                host = fit.params.cpu()
            out.append((cs, led, cap, fit, host))
        return out

    @staticmethod
    def cells(served: list) -> List[Fitted]:
        """The check's view of a served request, copied to the host."""
        cells = []
        for cs, led, cap, fit, host in served:
            counts = [0] * len({msg.src for msg in led.messages
                                if msg.tag == "dis/round1/G_j"})
            for msg in led.messages:
                if msg.tag == "dis/round2/S_up":
                    counts[int(msg.src.split(":")[1])] += msg.units
            cells.append(Fitted(cs.m, cap, counts, int(cs.comm_units), int(led.total),
                                cs.indices.cpu(), cs.weights.cpu(), host,
                                float(fit.objective)))
        return cells
