"""Training step factory (port of :mod:`repro.train.trainer`): loss +
grad + AdamW, with the paper's coreset batch selection as a first-class
option.

With ``SelectorConfig.mode == "coreset"`` the step is two-phase:
  1. SCORE (cheap, communication-light): per-example features are the
     mean-pooled token embeddings, scored party-locally
     (:func:`repro_torch.core.selector.local_scores`) and drawn by
     :func:`~repro_torch.core.selector.sample_coreset` (one ``categorical``
     launch on the card).  It runs under ``torch.no_grad()``: the importance
     weights are constants of the loss, as the reference's
     ``jax.value_and_grad`` closes over them;
  2. STEP (expensive): the forward/backward runs only on the m-row
     weighted coreset; the loss uses the DIS importance weights so the
     gradient stays an unbiased estimate of the full-batch gradient
     (Theorem 2.5 with the optimizer step as the downstream scheme A).

``mode == "uniform"`` is the U-* baseline (same m, weight B/m);
``mode == "none"`` is the dense step.

The state is ``{"params": model, "opt": AdamW state, "step"}`` (the model a
``DecoderLM`` or an ``EncDecLM``, FSDP-sharded or not); a step updates it
in place, returns its metrics as device tensors and reads nothing on the
host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.core.dis import uniform_plan
from repro_torch.core.selector import SelectorConfig, local_scores, sample_coreset
from repro_torch.device import DeviceLike
from repro_torch.models import api as model_api
from repro_torch.models.layers import embed
from repro_torch.optim.adamw import adamw_init, adamw_update

TrainState = Dict[str, Any]   # {"params", "opt", "step"}


def train_state_init(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                     device: DeviceLike = "cuda") -> TrainState:
    """A fresh state of ``cfg`` on ``device``, the weights drawn from
    ``generator`` (which must live on ``device``)."""
    params = model_api.init_params(cfg, generator=generator, device=device)
    step = torch.zeros((), dtype=torch.int32, device=params.embed.device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def _select_rows(batch: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v[idx] for k, v in batch.items()}


def _score_features(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, D) mean-pooled embedding features — the cheap, party-local score
    input (O(B*S*D) lookups; no layer compute, no cross-shard traffic).
    An embedding held by FSDP is gathered whole for the lookup."""
    from torch.distributed.tensor import DTensor

    table = params.embed
    if isinstance(table, DTensor):
        table = table.full_tensor()
    x = embed(batch["tokens"], table)                        # (B, S, D)
    feats = torch.mean(x.to(torch.float32), dim=1)
    if "prefix_embeds" in batch:
        feats = feats + torch.mean(batch["prefix_embeds"].to(torch.float32), dim=1)
    return feats


def make_train_step(
    cfg: ArchConfig,
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    selector: Optional[SelectorConfig] = None,
    weight_decay: float = 0.1,
) -> Callable[[TrainState, Dict[str, torch.Tensor], rng.Key], Tuple[TrainState, Dict]]:
    """Returns train_step(state, batch, key) -> (state, metrics): the state
    updated in place, the metrics ``loss``, ``ce``, ``aux`` and ``lr`` as
    0-d device tensors.  The gradients stay in the parameters' ``.grad``
    until the next step."""
    sel = selector or SelectorConfig(mode="none")

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], key: rng.Key):
        params = state["params"]
        dev = params.embed.device
        weights = None
        if sel.mode == "uniform":
            B = batch["tokens"].shape[0]
            idx, weights = uniform_plan(key, B, sel.m_of(B), device=dev)
            batch = _select_rows(batch, idx)
        elif sel.mode == "coreset":
            with torch.no_grad():
                feats = _score_features(params, cfg, batch)
                g = local_scores(feats, sel.score, sel.ridge)
                idx, weights = sample_coreset(key.to(dev), g, sel.m_of(feats.shape[0]))
            batch = _select_rows(batch, idx)

        params.zero_grad(set_to_none=True)
        total, metrics = model_api.loss_fn(params, cfg, batch, example_weights=weights)
        total.backward()
        grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
                 for name, p in params.named_parameters()}
        lr = lr_schedule(state["step"])
        adamw_update(params, grads, state["opt"], lr, weight_decay=weight_decay)
        state["step"].add_(1)
        out_metrics = {
            "loss": total.detach(),
            "ce": metrics["ce"].detach(),
            "aux": metrics["aux"].detach(),
            "lr": lr,
        }
        return state, out_metrics

    return step_fn


def make_eval_step(cfg: ArchConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model_api.loss_fn(params, cfg, batch)
        return metrics["ce"]

    return eval_step
