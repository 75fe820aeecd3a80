"""The batched engine, ``core.api.build_coresets_batched``: a request's
budgets in one call on a grid of capacity ``m_cap`` (the mix's, else the
largest budget), one key; every coreset of the grid is then fitted."""

from benchlib import traffic
from benchlib.coreset import CoresetProgram


def validate(mix: dict) -> dict:
    traffic.validate(mix)
    if int(mix.get("m_cap", max(mix["budgets"]))) < max(int(m) for m in mix["budgets"]):
        raise ValueError("m_cap below the largest budget")
    return mix


def capacity(mix: dict, ms) -> int:
    """The draw's capacity for a request of budgets ``ms``."""
    return int(mix.get("m_cap", max(ms)))


def build(prog: CoresetProgram, req) -> list:
    """[(Coreset, ledger, cap)] for the request's budgets."""
    from repro_torch.core.api import build_coresets_batched
    from repro_torch.core.comm import CommLedger

    cap = capacity(prog.mix, req.ms)
    grid = build_coresets_batched(prog.task, prog.ds, req.ms, keys=prog.key(req.key)[None],
                                  m_cap=cap, device=prog.dev, **prog.params)
    out = []
    for i in range(len(req.ms)):
        led = CommLedger()
        out.append((grid.coreset(0, i, ledger=led), led, cap))
    return out


def setup(cfg: dict, mix: dict, inputs, traced: bool = False) -> CoresetProgram:
    return CoresetProgram(cfg, mix, inputs, build, traced)
