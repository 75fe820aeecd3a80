"""Requests drawn from a mix's parameters (``bench/traffic/<mix>.json``),
shared by the loops (``bench/loops/<loop>.py``) that send them.

A mix names its loop and its engine (``bench/engines/<engine>.py``), the
budgets, and whether a request asks for all of them at once
(``"per_request": "all"``, one sweep of the paper's Figures 2-3) or for
one, the budgets cycling in an order drawn from the seed (``"cycle"``:
every block of ``len(budgets)`` requests holds each budget once, so every
seed gives the same set of sizes in another order).  Each request carries
its own build key and fit key, threefry ``(hi, lo)`` words drawn from the
seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

PER_REQUEST = ("all", "cycle")


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    ms: Tuple[int, ...]           # the budgets of the coresets it asks for
    key: Tuple[int, int]          # the build's threefry key words
    fit_key: Tuple[int, int]      # the k-means fit's key words


def validate(mix: dict) -> dict:
    if mix.get("per_request") not in PER_REQUEST:
        raise ValueError(f"mix per_request {mix.get('per_request')!r} not in {PER_REQUEST}")
    budgets = [int(m) for m in mix["budgets"]]
    if not budgets or min(budgets) < 1:
        raise ValueError(f"bad budgets {budgets}")
    return mix


def requests(mix: dict, seed: int, stream: int) -> Iterator[Request]:
    """The endless request sequence of ``stream`` (0: the measured window,
    1: set-up's warm-up) under ``seed``."""
    rng = np.random.default_rng([int(seed), int(stream)])
    budgets = tuple(int(m) for m in mix["budgets"])
    i = 0
    while True:
        if mix["per_request"] == "all":
            block = [budgets]
        else:
            block = [(budgets[j],) for j in rng.permutation(len(budgets))]
        for ms in block:
            w = rng.integers(0, 2 ** 32, size=4, dtype=np.uint64).tolist()
            yield Request(i, ms, (int(w[0]), int(w[1])), (int(w[2]), int(w[3])))
            i += 1


def warmup(mix: dict, seed: int) -> list:
    """Set-up's requests: one for each shape the window sends, that is one
    sweep, or one request of each budget."""
    n = 1 if mix["per_request"] == "all" else len(mix["budgets"])
    gen = requests(mix, seed, 1)
    return [next(gen) for _ in range(n)]
