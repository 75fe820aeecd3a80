"""Decoder-only language model (port of :mod:`repro.models.lm`), the
``attention`` mixer with GQA and a dense SwiGLU or a mixture-of-experts
FFN: the dense, VLM and MoE families (``llama3.2-1b``, ``qwen3-14b``,
``phi3-medium-14b``, ``starcoder2-3b``, ``internvl2-26b``,
``granite-moe-3b-a800m``).

The model is a :class:`DecoderLM` module whose parameters keep the
reference's names and ``(in, out)`` layout; the reference stacks the
layers on a leading L axis and scans them, the port keeps an
``nn.ModuleList`` and loops.  With ``cfg.remat`` the training forward
recomputes each layer in backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``).  The functions take the model where the
reference takes its parameter pytree.  Families not ported yet raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    cross_entropy,
    dense_init,
    embed,
    MLP,
    init_embed,
    mlp,
    model_device,
    ones_param,
    rms_norm,
    unembed,
)

KPOS_EMPTY = torch.iinfo(torch.int32).max // 2   # "slot never written" marker


def require_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item a config's
    family waits for; nothing for a ported config."""
    if cfg.kind == "encdec":
        missing = "the encoder-decoder family (models/encdec.py): ROADMAP queue 1, item 18.6"
    elif cfg.mixer in ("rwkv6", "hymba"):
        missing = f"the {cfg.mixer} mixer (models/ssm.py): ROADMAP queue 1, item 18.5"
    elif cfg.attn_type == "mla":
        missing = f"MLA attention: {attn.MLA_ITEM}"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {missing} is not ported yet")


# ==========================================================================
# init
# ==========================================================================

class Block(torch.nn.Module):
    """One layer: ``attn_norm``, ``attn`` (GQA), ``ffn_norm``, and ``ffn``
    (SwiGLU) or, for MoE, ``moe`` plus ``ffn`` (d_ff ``shared_d_ff``) when
    the config has a shared expert."""

    def __init__(self, cfg: ArchConfig, generator, device: torch.device):
        super().__init__()
        self.attn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.ffn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.attn = attn.GQA(cfg, generator, device)
        if cfg.is_moe:
            self.moe = moe_mod.MoE(cfg, generator, device)
            if cfg.shared_d_ff:
                self.ffn = MLP(cfg.d_model, cfg.shared_d_ff, cfg.param_dtype, generator, device)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.param_dtype, generator, device)


class DecoderLM(torch.nn.Module):
    """``embed`` (vocab_pad, D), ``layers`` (one :class:`Block` each),
    ``final_norm``, ``head`` (D, vocab_pad) when the embeddings are untied,
    and ``pos_embed`` (learned_pos, D) when positions are learned."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.embed = init_embed(cfg.vocab_pad, cfg.d_model, cfg.param_dtype, generator, device)
        self.final_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.layers = torch.nn.ModuleList(
            Block(cfg, generator, device) for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.head = dense_init((cfg.d_model, cfg.vocab_pad), cfg.param_dtype,
                                   generator, device)
        if cfg.learned_pos:
            self.pos_embed = dense_init((cfg.learned_pos, cfg.d_model), cfg.param_dtype,
                                        generator, device, scale=0.02)

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S_text, V) in float32."""
        hidden, _ = text_hidden(self, self.cfg, tokens, prefix_embeds)
        return logits_of(self, self.cfg, hidden)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> DecoderLM:
    """A :class:`DecoderLM` of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), its matrices fan-in truncated normals drawn from
    ``generator`` (which must live on ``device``)."""
    return DecoderLM(cfg, generator, model_device(device))


# ==========================================================================
# training / prefill forward
# ==========================================================================

def _ffn(cfg: ArchConfig, p: Block, h: torch.Tensor,
         with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the normed ``h``: (out, the MoE aux loss; None for
    a dense block or without ``with_aux``)."""
    if not cfg.is_moe:
        return mlp(p.ffn, h), None
    out, aux = moe_mod.moe_ffn(p.moe, cfg, h, cfg.capacity_factor, with_aux=with_aux)
    if cfg.shared_d_ff:
        out = out + mlp(p.ffn, h)
    return out, aux


def _layer_fwd(cfg: ArchConfig, x: torch.Tensor, p: Block,
               positions: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block. Returns (x, aux_loss; None for a dense block).  Mutates
    none of its inputs: under ``cfg.remat`` backward runs it again."""
    h = rms_norm(x, p.attn_norm)
    out, _ = attn.gqa_attention(p.attn, cfg, h, positions, chunk=cfg.attn_chunk)
    x = x + out
    out, aux = _ffn(cfg, p, rms_norm(x, p.ffn_norm))
    return x + out, aux


def forward(
    params: DecoderLM,
    cfg: ArchConfig,
    tokens: torch.Tensor,                            # (B, S_text)
    prefix_embeds: Optional[torch.Tensor] = None,    # (B, P, D) for vlm stubs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, D), total_aux_loss)."""
    require_ported(cfg)
    x = embed(tokens, params.embed)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)
    if cfg.learned_pos:
        x = x + params.pos_embed[positions][None]
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for layer in params.layers:
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer_fwd, cfg, x, layer, positions, use_reentrant=False)
        else:
            x, aux = _layer_fwd(cfg, x, layer, positions)
        auxes.append(aux)
    x = rms_norm(x, params.final_norm)
    if not cfg.is_moe:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, torch.sum(torch.stack(auxes))


def text_hidden(
    params: DecoderLM,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` with the prefix positions dropped: (hidden (B,
    S_text, D), total_aux_loss)."""
    hidden, aux = forward(params, cfg, tokens, prefix_embeds)
    if prefix_embeds is not None:
        hidden = hidden[:, prefix_embeds.shape[1]:]
    return hidden, aux


def mask_pad_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 on the padded vocab columns (see ArchConfig.vocab_pad)."""
    if logits.shape[-1] == vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab, logits, -1e30)


def logits_of(params: DecoderLM, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    head = params.embed if cfg.tie_embeddings else params.head
    return mask_pad_logits(unembed(hidden, head, cfg.tie_embeddings), cfg.vocab_size)


def loss_fn(
    params: DecoderLM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    aux_weight: float = 0.01,
    example_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ ``aux_weight`` x the MoE aux). For prefix archs
    (vlm) the loss is computed on the text positions only."""
    hidden, aux = text_hidden(params, cfg, batch["tokens"], batch.get("prefix_embeds"))
    logits = logits_of(params, cfg, hidden)
    ce = cross_entropy(logits, batch["labels"])              # (B, S_text)
    per_example = ce.mean(dim=-1)                            # (B,)
    if example_weights is not None:
        denom = torch.clamp_min(torch.sum(example_weights), 1e-6)
        loss = torch.sum(example_weights * per_example) / denom
    else:
        loss = per_example.mean()
    total = loss + aux_weight * aux
    return total, {"ce": loss, "aux": aux}


# ==========================================================================
# decode (serve_step)
# ==========================================================================

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode state: ``layers`` {``k``, ``v``} (L, B, ring, KV, hd), the
    int32 ``pos`` and ``kpos`` (ring,) as device tensors.  ``cache_len`` is
    the ring size: full seq_len for exact attention, ``min(cache_len,
    window)`` for sliding-window."""
    require_ported(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    layers = {"k": torch.zeros((L, batch, eff, KV, hd), dtype=dt, device=dev),
              "v": torch.zeros((L, batch, eff, KV, hd), dtype=dt, device=dev)}
    return {"layers": layers,
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
            "kpos": torch.full((eff,), KPOS_EMPTY, dtype=torch.int32, device=dev)}


def _layer_decode(cfg: ArchConfig, x: torch.Tensor, p: Block, ck: torch.Tensor,
                  cv: torch.Tensor, positions: torch.Tensor,
                  kpos: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p.attn_norm)
    out, _ = attn.gqa_attention(p.attn, cfg, h, positions, kv_cache=(ck, cv),
                                cache_positions=kpos)
    x = x + out
    out, _ = _ffn(cfg, p, rms_norm(x, p.ffn_norm), with_aux=False)
    return x + out


@torch.no_grad()
def decode_step(
    params: DecoderLM,
    cfg: ArchConfig,
    cache: Dict[str, Any],
    tokens: torch.Tensor,                 # (B, 1)
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """serve_step: ONE new token against the standing cache.  The cache is
    updated in place (k, v and kpos at the token's ring slot, ``pos`` + 1)
    and returned; nothing is read on the host."""
    pos = cache["pos"]
    positions = pos.reshape(1).clone()                       # (1,)
    x = embed(tokens, params.embed)
    if cfg.learned_pos:
        x = x + params.pos_embed[positions][None]
    kpos = attn.update_kpos(cache["kpos"], positions)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i, layer in enumerate(params.layers):
        x = _layer_decode(cfg, x, layer, ks[i], vs[i], positions, kpos)
    x = rms_norm(x, params.final_norm)
    logits = logits_of(params, cfg, x)                       # (B, 1, V)
    pos.add_(1)
    return logits, cache
