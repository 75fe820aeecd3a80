"""The fused engine, ``core.api.build_coreset_jit``: one coreset a
request, its scoring and DIS draw replayed as one CUDA graph per shape
(captured on the shape's first call, in set-up)."""

from benchlib import traffic
from benchlib.coreset import CoresetProgram


def validate(mix: dict) -> dict:
    traffic.validate(mix)
    if mix["per_request"] != "cycle":
        raise ValueError("the fused engine builds one budget a request")
    return mix


def capacity(mix: dict, ms) -> int:
    (m,) = ms
    return int(m)


def build(prog: CoresetProgram, req) -> list:
    from repro_torch.core.api import build_coreset_jit
    from repro_torch.core.comm import CommLedger

    (m,) = req.ms
    led = CommLedger()
    cs = build_coreset_jit(prog.task, prog.ds, m, key=prog.key(req.key), ledger=led,
                           device=prog.dev, **prog.params)
    return [(cs, led, m)]


def setup(cfg: dict, mix: dict, inputs, traced: bool = False) -> CoresetProgram:
    return CoresetProgram(cfg, mix, inputs, build, traced)
