"""Readings for the limits of ``correct``: the program's numbers over many
seeds (the lower readings) and the control's (the upper readings), at a
cell's own size, in one process.

    python3 bench/calibrate.py --workload vrlr-sweep --program-seeds 101-112 \\
        --control-seeds 201-203 [--fault draw|weights] [--out calibrate.jsonl]

The program serves ``check.requests`` requests of the cell's traffic for
each program seed, and they are judged as a run judges its sample.  The
control is the plain reference in TF32 put in the program's place
(the configuration's judge's ``reference_serve``), which draws every row
of every cell; it is judged by the same comparison.  ``--fault`` breaks the
program underneath for its seeds, an answer altered where it is produced:
``draw`` moves every index the categorical kernel draws to the next row,
``weights`` scales every weight the draw returns by 1.01.  One JSON line
per seed, with the run's numbers and each judged cell's.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def _break(fault: str) -> None:
    """Plant ``fault`` in the program (see the module's docstring)."""
    import repro_torch.core.api as api
    import repro_torch.kernels.ops as kops

    if fault == "draw":
        draw = kops.categorical_parties

        def moved(keys, logits, cap, counts, total=None):
            return (draw(keys, logits, cap, counts, total) + 1) % logits.shape[1]

        kops.categorical_parties = moved
    else:
        plan_full = api.dis_plan_full

        def scaled(*a, **kw):
            p = plan_full(*a, **kw)
            return p._replace(weights=p.weights * 1.01)

        api.dis_plan_full = scaled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-requests", type=int, default=1)
    ap.add_argument("--fault", choices=("draw", "weights"), default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    import torch

    from benchlib import manifest, traffic
    from reference import algorithms as ref

    if args.fault:
        _break(args.fault)
    # bench/later.json: BENCHMARK.json and the cells that wait (PERF.md, Open questions)
    cell = manifest.resolve(manifest.load_json(BENCH / "later.json"), args.workload)
    cfg = cell.config
    mix = cell.engine.validate(cell.mix)
    judge = cell.judge
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    k = int(cfg["check"]["requests"])
    for seed in _seeds(args.program_seeds) if args.program_seeds else []:
        t = time.perf_counter()
        inputs = cell.inputs.make(cfg, seed, dev)
        prog = cell.engine.setup(cfg, mix, inputs)
        gen = traffic.requests(mix, seed, 0)
        done = []
        for _ in range(k):
            req = next(gen)
            done.append((req, prog.cells(prog.serve(req))))
        per_cell = judge.judge_cells(cfg, inputs, done, seed)
        emit({"workload": cell.name, "side": args.fault or "program", "seed": seed,
              "numbers": judge.aggregate(per_cell, 0), "cells": per_cell,
              "seconds": time.perf_counter() - t})
        del prog, inputs
    for seed in _seeds(args.control_seeds) if args.control_seeds else []:
        t = time.perf_counter()
        inputs = cell.inputs.make(cfg, seed, dev)
        gen = traffic.requests(mix, seed, 0)
        done = []
        for _ in range(args.control_requests):
            req = next(gen)
            done.append((req, judge.reference_serve(cfg, mix, cell.engine, inputs, req,
                                                    ref.TF32)))
        per_cell = judge.judge_cells(cfg, inputs, done, seed)
        emit({"workload": cell.name, "side": "control", "seed": seed,
              "numbers": judge.aggregate(per_cell, 0), "cells": per_cell,
              "seconds": time.perf_counter() - t})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
