"""Training launcher (port of :mod:`repro.launch.train`): ``--arch <id>``
selects an architecture; ``--reduced`` (the default) trains the family's
smoke-scale variant on the synthetic corpus with optional coreset batch
selection, on the card unless ``--device cpu``.  ``--production`` prints
the production-mesh plan instead: every parameter's path and spec from
:func:`repro_torch.sharding.specs.param_shardings` at the published width,
the shapes taken from a ``meta``-device model (nothing allocated).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
      --steps 50 --selector coreset --fraction 0.25
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--selector", default="none", choices=["none", "uniform", "coreset"])
    ap.add_argument("--fraction", type=float, default=0.25)
    ap.add_argument("--reduced", dest="reduced", action="store_true", default=True)
    ap.add_argument("--production", dest="reduced", action="store_false",
                    help="print the production-mesh plan instead of training")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if not args.reduced:
        return production_plan(args.arch)

    import torch

    from repro_torch import rng
    from repro_torch.configs import get_arch
    from repro_torch.core.selector import SelectorConfig
    from repro_torch.data.lm import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.optim.schedules import cosine_with_warmup
    from repro_torch.train import make_train_step, save_checkpoint, train_state_init
    from repro_torch.utils.logging import get_logger

    log = get_logger("train")
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    sel = None if args.selector == "none" else SelectorConfig(
        mode=args.selector, fraction=args.fraction)
    key = rng.PRNGKey(args.seed, device=dev)
    state = train_state_init(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                             device=dev)
    step = make_train_step(
        cfg, cosine_with_warmup(args.lr, max(args.steps // 10, 1), args.steps), sel)
    stream = iter(TokenStream(vocab=cfg.vocab_size, seq_len=args.seq,
                              batch_size=args.batch, seed=args.seed, device=dev))
    losses, t0 = [], time.time()
    for i in range(args.steps):
        state, m = step(state, next(stream), rng.fold_in(key, i))
        losses.append(float(m["ce"]))
        if (i + 1) % max(args.steps // 10, 1) == 0:
            log.info("step %4d/%d ce=%.4f avg10=%.4f lr=%.2e %.0f ms/step",
                     i + 1, args.steps, losses[-1], np.mean(losses[-10:]),
                     float(m["lr"]), (time.time() - t0) / (i + 1) * 1e3)
    if args.ckpt:
        path = save_checkpoint(args.ckpt, state, args.steps)
        log.info("checkpoint: %s", path)
    log.info("final ce (last 10 avg): %.4f", np.mean(losses[-10:]))
    return 0


def production_plan(arch: str) -> int:
    """Log the production mesh and every parameter's spec, as the
    reference's ``--production`` does."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.sharding.specs import flat_specs, param_shardings, stacked_shapes
    from repro_torch.utils.logging import get_logger

    log = get_logger("train")
    cfg = get_arch(arch)
    shapes = stacked_shapes(api.init_params(cfg, device="meta"))
    specs = param_shardings(shapes, cfg, multi_pod=False)
    log.info("production mesh: 16x16 ('data','model'); param shardings:")
    for name, spec in flat_specs(specs).items():
        log.info("  %-55s %s", name, spec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
