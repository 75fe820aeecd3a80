"""Decoder-only language model (port of :mod:`repro.models.lm`): the
``attention`` mixer with GQA or MLA, the ``rwkv6`` mixer and the
``hymba`` mixer (sliding-window GQA in parallel with a Mamba branch),
each with a dense SwiGLU or a mixture-of-experts FFN — every decoder
family of the catalog (``llama3.2-1b``, ``qwen3-14b``,
``phi3-medium-14b``, ``starcoder2-3b``, ``internvl2-26b``,
``granite-moe-3b-a800m``, ``deepseek-v2-236b``, ``rwkv6-3b``,
``hymba-1.5b``; the encoder-decoder ``whisper-medium`` is
:mod:`repro_torch.models.encdec`).

The model is a :class:`DecoderLM` module whose parameters keep the
reference's names and ``(in, out)`` layout; the reference stacks the
layers on a leading L axis and scans them, the port keeps an
``nn.ModuleList`` and calls each layer module in turn.  With
``cfg.remat`` the training forward recomputes each layer in backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  The
functions take the model where the reference takes its parameter pytree;
the loss runs inside the model's own call, so that
:func:`repro_torch.sharding.fsdp.fully_shard_model` gathers the root's
weights around it as it gathers each layer's around that layer's call.
The reference's activation-sharding hooks (``shard_batch_seq``,
``shard_logits``) sit where it has them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
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
    wide,
)
from repro_torch.sharding.ctx import shard_batch_seq, shard_logits

KPOS_EMPTY = torch.iinfo(torch.int32).max // 2   # "slot never written" marker


# ==========================================================================
# init
# ==========================================================================

class Block(torch.nn.Module):
    """One layer: ``attn_norm``, ``ffn_norm``, the mixer — ``attn`` (GQA),
    ``mla`` (MLA), ``rwkv`` (RWKV-6), or ``attn`` and ``mamba`` (Hymba) —
    and ``ffn`` (SwiGLU) or, for MoE, ``moe`` plus ``ffn`` (d_ff
    ``shared_d_ff``) when the config has a shared expert."""

    def __init__(self, cfg: ArchConfig, generator, device: torch.device):
        super().__init__()
        self.attn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.ffn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        if cfg.mixer == "attention":
            if cfg.attn_type == "mla":
                self.mla = attn.MLA(cfg, generator, device)
            else:
                self.attn = attn.GQA(cfg, generator, device)
        elif cfg.mixer == "rwkv6":
            self.rwkv = ssm.RWKV6(cfg, generator, device)
        elif cfg.mixer == "hymba":
            self.attn = attn.GQA(cfg, generator, device)
            self.mamba = ssm.Mamba(cfg, generator, device)
        else:
            raise ValueError(cfg.mixer)
        if cfg.is_moe:
            self.moe = moe_mod.MoE(cfg, generator, device)
            if cfg.shared_d_ff:
                self.ffn = MLP(cfg.d_model, cfg.shared_d_ff, cfg.param_dtype, generator, device)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.param_dtype, generator, device)

    def forward(self, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The training / prefill block (:func:`_layer_fwd`), recomputed in
        backward under ``cfg.remat``."""
        return remat_call(cfg, _layer_fwd, cfg, x, self, positions)


def remat_call(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``cfg.remat`` with grad enabled through
    ``torch.utils.checkpoint`` (recomputed in backward)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class DecoderLM(torch.nn.Module):
    """``embed`` (vocab_pad, D), ``layers`` (one :class:`Block` each),
    ``final_norm``, ``head`` (D, vocab_pad) when the embeddings are untied,
    and ``pos_embed`` (learned_pos, D) when positions are learned."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
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

    def forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
                cfg: Optional[ArchConfig] = None, with_aux: bool = False):
        """Logits (B, S_text, V) in float32 under ``cfg`` (the model's own
        by default); with ``with_aux`` (logits, the MoE aux loss)."""
        cfg = self.cfg if cfg is None else cfg
        hidden, aux = text_hidden(self, cfg, tokens, prefix_embeds)
        logits = logits_of(self, cfg, hidden)
        return (logits, aux) if with_aux else logits


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
    if cfg.mixer == "attention":
        if cfg.attn_type == "mla":
            out, _ = attn.mla_attention(p.mla, cfg, h, positions, chunk=cfg.attn_chunk)
        else:
            out, _ = attn.gqa_attention(p.attn, cfg, h, positions, chunk=cfg.attn_chunk)
    elif cfg.mixer == "rwkv6":
        out, _ = ssm.rwkv6_mixer(p.rwkv, cfg, h, chunk=cfg.ssm_chunk)
    else:  # hymba: parallel attention + mamba heads
        a, _ = attn.gqa_attention(p.attn, cfg, h, positions, chunk=cfg.attn_chunk)
        m, _ = ssm.mamba_mixer(p.mamba, cfg, h, chunk=max(cfg.ssm_chunk, 4))
        out = 0.5 * (a + m)
    x = x + shard_batch_seq(out)
    out, aux = _ffn(cfg, p, rms_norm(x, p.ffn_norm))
    return x + shard_batch_seq(out), aux


def forward(
    params: DecoderLM,
    cfg: ArchConfig,
    tokens: torch.Tensor,                            # (B, S_text)
    prefix_embeds: Optional[torch.Tensor] = None,    # (B, P, D) for vlm stubs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, D), total_aux_loss)."""
    x = embed(tokens, params.embed)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)
    if cfg.learned_pos:
        x = x + params.pos_embed[positions][None]
    x = shard_batch_seq(x)
    auxes = []
    for layer in params.layers:
        x, aux = layer(cfg, x, positions)
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
    logits = shard_logits(unembed(hidden, head, cfg.tie_embeddings))
    return mask_pad_logits(logits, cfg.vocab_size)


def loss_fn(
    params: DecoderLM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    aux_weight: float = 0.01,
    example_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ ``aux_weight`` x the MoE aux). For prefix archs
    (vlm) the loss is computed on the text positions only.  It runs
    through the model's call (see the module docstring)."""
    logits, aux = params(batch["tokens"], batch.get("prefix_embeds"), cfg=cfg, with_aux=True)
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
    """Decode state: ``layers`` holding, per family, stacked on L, ``k``,
    ``v`` (L, B, ring, KV, hd) for GQA and Hymba's attention; ``c_kv`` (L,
    B, ring, r_kv) and ``k_pe`` (L, B, ring, dr) for MLA; ``wkv`` (L, B, H,
    hd, hd) float32 and ``shift`` (L, B, D) for RWKV-6; ``mamba_h`` (L, B,
    di, N) float32 for Hymba's Mamba branch; the int32 ``pos`` and, with a
    ring, its ``kpos`` (ring,), all on ``device`` (``"meta"`` allocates
    nothing).  ``cache_len`` is the
    ring size: full seq_len for exact attention, ``min(cache_len,
    window)`` for sliding-window, ignored by RWKV-6."""
    dev = model_device(device)
    dt = dtype or cfg.param_dtype
    f32 = wide(dt)
    L = cfg.num_layers
    zeros = lambda shape, d: torch.zeros(shape, dtype=d, device=dev)
    layers: Dict[str, torch.Tensor] = {}
    if cfg.mixer in ("attention", "hymba") and cfg.attn_type != "mla":
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
        layers["k"] = zeros((L, batch, eff, KV, hd), dt)
        layers["v"] = zeros((L, batch, eff, KV, hd), dt)
    if cfg.attn_type == "mla":
        layers["c_kv"] = zeros((L, batch, cache_len, cfg.kv_lora_rank), dt)
        layers["k_pe"] = zeros((L, batch, cache_len, cfg.qk_rope_dim), dt)
    if cfg.mixer == "rwkv6":
        H, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
        layers["wkv"] = zeros((L, batch, H, hd, hd), f32)
        layers["shift"] = zeros((L, batch, cfg.d_model), dt)
    if cfg.mixer == "hymba":
        layers["mamba_h"] = zeros((L, batch, cfg.mamba_d_inner, cfg.ssm_state), f32)
    cache: Dict[str, Any] = {"layers": layers,
                             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if "k" in layers or "c_kv" in layers:
        eff = layers.get("k", layers.get("c_kv")).shape[2]
        cache["kpos"] = torch.full((eff,), KPOS_EMPTY, dtype=torch.int32, device=dev)
    return cache


def _layer_decode(cfg: ArchConfig, x: torch.Tensor, p: Block, lc: Dict[str, torch.Tensor],
                  positions: torch.Tensor, kpos: Optional[torch.Tensor]) -> torch.Tensor:
    """One block on one token; ``lc`` holds the layer's views of the cache,
    updated in place."""
    h = rms_norm(x, p.attn_norm)
    if cfg.mixer == "attention":
        if cfg.attn_type == "mla":
            out, _ = attn.mla_attention(p.mla, cfg, h, positions,
                                        kv_cache=(lc["c_kv"], lc["k_pe"]),
                                        cache_positions=kpos)
        else:
            out, _ = attn.gqa_attention(p.attn, cfg, h, positions, kv_cache=(lc["k"], lc["v"]),
                                        cache_positions=kpos)
    elif cfg.mixer == "rwkv6":
        out, st = ssm.rwkv6_mixer(p.rwkv, cfg, h,
                                  state={"wkv": lc["wkv"], "shift": lc["shift"]}, chunk=1)
        lc["wkv"].copy_(st["wkv"])
        lc["shift"].copy_(st["shift"])
    else:  # hymba
        a, _ = attn.gqa_attention(p.attn, cfg, h, positions, kv_cache=(lc["k"], lc["v"]),
                                  cache_positions=kpos)
        m, hm = ssm.mamba_mixer(p.mamba, cfg, h, state=lc["mamba_h"], chunk=1)
        lc["mamba_h"].copy_(hm)
        out = 0.5 * (a + m)
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
    updated in place (the layers' state at the token's ring slot, ``kpos``
    where the cache has a ring, ``pos`` + 1) and returned; nothing is read
    on the host."""
    pos = cache["pos"]
    positions = pos.reshape(1).clone()                       # (1,)
    x = embed(tokens, params.embed)
    if cfg.learned_pos:
        x = x + params.pos_embed[positions][None]
    kpos = cache.get("kpos")
    if kpos is not None:
        kpos = attn.update_kpos(kpos, positions)
    stacked = cache["layers"]
    for i, layer in enumerate(params.layers):
        x = _layer_decode(cfg, x, layer, {k: t[i] for k, t in stacked.items()}, positions, kpos)
    x = rms_norm(x, params.final_norm)
    logits = logits_of(params, cfg, x)                       # (B, 1, V)
    pos.add_(1)
    return logits, cache
