"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's chips.  The last
line of standard output is the result (one JSON object); the compared
numbers and their limits are the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, it prints no result and
exits with 2.
"""

import time

T0 = time.perf_counter()          # set-up counts from the process's start

import argparse
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return "card " + " | ".join(out.splitlines())


def _cpu_line() -> str:
    model = platform.processor() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((l.split(":", 1)[1].strip() for l in f
                          if l.startswith("model name")), model)
    except OSError:
        pass
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"host cpu {model} x {os.cpu_count()}; load average {load}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))

    from benchlib import manifest, runner

    cell = manifest.resolve(manifest.load(ROOT), args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; fails without src/)

    dev = torch.device("cuda", 0)
    torch.set_num_threads(2)          # few host threads: steadier runs
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, T0)

    found = runner.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
              "memory_peak_bytes": out["peak_bytes"]}
    if args.trace and "busy_s" in out:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    print(_card_line())
    print(_cpu_line())
    for line in runner.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(runner.result_line(out, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
