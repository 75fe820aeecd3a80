"""A cell cut to a size the CPU tests run in a second or two: the same
files, n and the budgets shrunk and a small check sample.  Only tests use
it (with :data:`SLICE`, a short traced slice); a measured run never does.

Cells are found in ``bench/later.json``: ``BENCHMARK.json`` with the cells
that wait for their chip runs (PERF.md, Open questions), so that their
files run here too."""

from __future__ import annotations

import copy

from benchlib import manifest

#: the traced slice of a tiny run: from the window's start, 0.2 s
SLICE = (0.0, 0.2)
LATER = manifest.BENCH / "later.json"


def later() -> dict:
    return manifest.load_json(LATER)


def cell(workload: str, n: int = 2000, budgets=(40, 80)):
    c = manifest.resolve(later(), workload)
    c.config = copy.deepcopy(c.config)
    c.mix = copy.deepcopy(c.mix)
    c.config["n"] = n
    c.mix["budgets"] = list(budgets)
    if "m_cap" in c.mix:
        c.mix["m_cap"] = max(budgets)
    c.config["check"]["requests"] = 2
    return c
