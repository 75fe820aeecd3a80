"""Batched LM serving engine (port of :mod:`repro.models.lm_serve`):
prefill + greedy/temperature decode over the family-dispatched
``decode_step``.

``make_serve_step`` is the decode unit: ONE token against a standing
cache of ``cache_len``.  ``repro_torch.serve.engine`` keeps the
reference's deprecated re-export.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import rng
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api as model_api
from repro_torch.models import encdec


def make_serve_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens (B,1)) -> (logits (B,1,V), cache)."""

    def serve_step(params, cache, tokens):
        return model_api.decode_step(params, cfg, cache, tokens)

    return serve_step


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched engine: greedy/temperature sampling on the model's
    device, under ``torch.inference_mode``.

    Prefill runs token-by-token through ``decode_step``, as the reference
    does (exact; fine at example scale).  Greedy decoding takes the first
    index of the largest logit; temperature sampling is
    ``jax.random.categorical`` on the same logits bit for bit.
    """

    cfg: ArchConfig
    params: Any
    cache_len: int = 4096

    def __post_init__(self) -> None:
        self._step = make_serve_step(self.cfg)

    @torch.inference_mode()
    def generate(
        self,
        prompts: torch.Tensor,             # (B, P) int
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        key: Optional[rng.Key] = None,
        prefix_embeds: Optional[torch.Tensor] = None,   # encdec frame embeddings
    ) -> torch.Tensor:
        """(B, max_new_tokens) int32 tokens on the model's device.  An
        encoder-decoder model needs ``prefix_embeds`` (B, num_prefix, D):
        the encoder runs once (``encdec.prefill_cross``) before the
        prefill."""
        dev = self.params.embed.device
        prompts = prompts.to(dev)
        key = None if key is None else key.to(dev)
        B, P = prompts.shape
        cache = model_api.init_cache(self.cfg, B, self.cache_len, device=dev)
        if self.cfg.kind == "encdec":
            if prefix_embeds is None:
                raise ValueError(f"{self.cfg.name}: an encoder-decoder model needs frame "
                                 f"embeddings (prefix_embeds)")
            cache = encdec.prefill_cross(self.params, self.cfg, cache, prefix_embeds.to(dev))
        # prefill
        logits = None
        for t in range(P):
            logits, cache = self._step(self.params, cache, prompts[:, t:t + 1])
        # decode
        out = []
        tok = self._sample(logits, temperature, key, 0)
        for i in range(max_new_tokens):
            out.append(tok)
            logits, cache = self._step(self.params, cache, tok)
            key = None if key is None else rng.fold_in(key, i)
            tok = self._sample(logits, temperature, key, i + 1)
        return torch.cat(out, dim=1)                   # (B, max_new_tokens)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float, key: Optional[rng.Key],
                i: int) -> torch.Tensor:
        last = logits[:, -1, :]
        if temperature <= 0.0 or key is None:
            return torch.argmax(last, dim=-1, keepdim=True).to(torch.int32)
        g = rng.gumbel(rng.fold_in(key, 7919 + i), tuple(last.shape))
        return torch.argmax(g + last / temperature, dim=-1, keepdim=True).to(torch.int32)
