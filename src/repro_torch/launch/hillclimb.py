"""Hill-climbing runner (port of :mod:`repro.launch.hillclimb`).

Runs the named variants of three (arch x shape) pairs against the
single-pod production mesh through the port's layer-slope
:func:`~repro_torch.launch.dryrun.roofline_one` (on the ``meta`` device:
nothing is allocated) and appends the records to ``--out`` (default
``launch_out/hillclimb.jsonl``, ignored by git).  Each variant is a
(cfg_transform, selector) pair, the reference's table.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --step A1
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --step B1 C1 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.core.selector import SelectorConfig
from repro_torch.launch.dryrun import roofline_one


def _t(**kw):
    def tr(cfg):
        return dataclasses.replace(cfg, **kw)

    return tr


STEPS = {
    # ---- pair A: deepseek-v2-236b train_4k (worst roofline fraction) ------
    "A1": ("deepseek-v2-236b", "train_4k", _t(moe_dispatch="einsum"), None),
    "A2": ("deepseek-v2-236b", "train_4k",
           _t(moe_dispatch="einsum", capacity_factor=1.0), None),
    "A3": ("deepseek-v2-236b", "train_4k",
           _t(moe_dispatch="einsum", capacity_factor=1.0, moe_group=128), None),
    "A4": ("deepseek-v2-236b", "train_4k",
           _t(moe_dispatch="einsum", capacity_factor=1.0, moe_group=512), None),
    # ---- pair B: rwkv6-3b train_4k (most collective-bound) ----------------
    "B1": ("rwkv6-3b", "train_4k", _t(pure_fsdp=True, fsdp=True), None),
    "B2": ("rwkv6-3b", "train_4k",
           _t(pure_fsdp=True, fsdp=True, ssm_chunk=64), None),
    "B3": ("rwkv6-3b", "train_4k",
           _t(pure_fsdp=True, fsdp=True, ssm_chunk=128), None),
    # ---- pair C: granite train_4k (paper-technique representative) --------
    "C1": ("granite-moe-3b-a800m", "train_4k", None,
           SelectorConfig(mode="coreset", fraction=0.25)),
    "C2": ("granite-moe-3b-a800m", "train_4k", _t(moe_dispatch="einsum"),
           SelectorConfig(mode="coreset", fraction=0.25)),
    "C3": ("granite-moe-3b-a800m", "train_4k", _t(moe_dispatch="einsum"), None),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step", nargs="+", required=True, choices=list(STEPS))
    ap.add_argument("--out", default="launch_out/hillclimb.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fails = 0
    with open(args.out, "a") as out:
        for step in args.step:
            arch, shape, tr, sel = STEPS[step]
            rec = roofline_one(arch, shape, cfg_transform=tr, selector=sel)
            rec["step"] = step
            rec.pop("trace", None)
            out.write(json.dumps(rec) + "\n")
            out.flush()
            if rec["status"] != "ok":
                fails += 1
                print(f"[{step}] ERROR {rec.get('error', '')[:300]}")
            else:
                print(f"[{step}] {arch}/{rec['shape']}: t_comp={rec['t_compute_s']:.3f} "
                      f"t_mem={rec['t_memory_s']:.3f} t_coll={rec['t_collective_s']:.3f} "
                      f"bneck={rec['bottleneck']} useful={rec['useful_fraction']:.3f} "
                      f"peakGiB={(rec.get('peak_bytes_per_device') or 0) / 2**30:.1f}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
