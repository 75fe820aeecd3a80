"""Family-dispatching model API (port of :mod:`repro.models.api`): init /
loss / decode for any ArchConfig — the decoder families
(:mod:`repro_torch.models.lm`) and the encoder-decoder
(:mod:`repro_torch.models.encdec`, ``cfg.kind == "encdec"``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import encdec, lm


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> torch.nn.Module:
    if cfg.kind == "encdec":
        return encdec.init_params(cfg, generator=generator, device=device)
    return lm.init_params(cfg, generator=generator, device=device)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            example_weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    if cfg.kind == "encdec":
        return encdec.loss_fn(params, cfg, batch, example_weights=example_weights)
    return lm.loss_fn(params, cfg, batch, example_weights=example_weights)


def forward_hidden(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Hidden states (B, S_text, D) — used by the coreset batch selector."""
    if cfg.kind == "encdec":
        return encdec.forward(params, cfg, batch["tokens"], batch["prefix_embeds"])[0]
    return lm.text_hidden(params, cfg, batch["tokens"], batch.get("prefix_embeds"))[0]


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda"):
    if cfg.kind == "encdec":
        return encdec.init_cache(cfg, batch, cache_len, dtype, device=device)
    return lm.init_cache(cfg, batch, cache_len, dtype, device=device)


def decode_step(params, cfg: ArchConfig, cache, tokens):
    if cfg.kind == "encdec":
        return encdec.decode_step(params, cfg, cache, tokens)
    return lm.decode_step(params, cfg, cache, tokens)


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def active_param_count(cfg: ArchConfig, params: torch.nn.Module) -> int:
    """Active params per token (MoE: top-k of routed experts + the rest)."""
    total = param_count(params)
    if not cfg.is_moe:
        return total
    e_total = sum(p.numel() for name, p in params.named_parameters()
                  if "moe" in name.split(".") and "router" not in name.split("."))
    active_frac = cfg.num_experts_per_tok / max(cfg.num_experts, 1)
    return int(total - e_total + e_total * active_frac)
