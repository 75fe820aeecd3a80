#!/usr/bin/env python3
"""Time the streaming engines' builds from host memory on one NVIDIA GPU.

    python3 stream_times.py [--tree DIR] [--runs R] [--m M]

Builds a ``vrlr`` and a ``vkmc`` coreset of m rows (k = 10, alpha = 2, 15
local iterations on a 16,384-row subsample) with ``CoresetPipeline.build``
from a host-resident copy of ``chip_smoke.py``'s main-path data
(n = 463,715, d = 90, T = 3, made from seed 0), at blocks of 65,536 and
16,384 rows: the streamed engine and, where the tree has it, the pipelined
engine (superchunks of 8 blocks, prefetched).  One warm-up build, then R
timed builds with R keys, host clock around ``torch.cuda.synchronize``;
prints each engine's median and runs, with the card's name and power
limit.  ``--tree`` is the root of a checkout whose ``src/repro_torch`` is
timed (default: this one), so two commits compare in one call, one
process each: unpack the other with ``git archive`` and run parent,
change, change, parent.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--m", type=int, default=1000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch finds no CUDA device; these times are the card's")
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    from chip_smoke import D_FULL, N_FULL, T_PARTIES, make_data
    from repro_torch import rng
    from repro_torch.core import CoresetPipeline, CoresetSpec, VFLDataset
    from repro_torch.core.plan import compile_plan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    X, y = make_data(0, N_FULL, D_FULL)
    ds = VFLDataset.from_dense(X, y, T=T_PARTIES, device="cpu")
    engines = [("streamed", {})]
    try:
        compile_plan(CoresetSpec(engine="pipelined", chunk_blocks=8), ds, "cuda")
        engines.append(("pipelined", {"chunk_blocks": 8, "prefetch": True}))
    except NotImplementedError:
        pass
    vkmc = {"k": 10, "alpha": 2.0, "local_iters": 15, "center_sample": 16384}
    for task, params in (("vrlr", {}), ("vkmc", vkmc)):
        for block_size in (65536, 16384):
            for engine, knobs in engines:
                spec = CoresetSpec(task=task, budgets=args.m, engine=engine,
                                   block_size=block_size, params=params, **knobs)
                pipe = CoresetPipeline(ds)
                pipe.build(spec, key=rng.PRNGKey(args.runs))
                times = []
                for r in range(args.runs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pipe.build(spec, key=rng.PRNGKey(r))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                print(f"{tree.name} {task} m={args.m} block_size={block_size} {engine}: "
                      f"build_s median {statistics.median(times):.4f} runs "
                      f"{[round(t, 4) for t in times]} ({smi})", flush=True)


if __name__ == "__main__":
    main()
