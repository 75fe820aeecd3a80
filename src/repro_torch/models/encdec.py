"""Encoder-decoder backbone, Whisper-medium shape (port of
:mod:`repro.models.encdec`).

Frontend carve-out, as the reference: the mel-spectrogram + conv feature
extractor is a STUB — the model consumes precomputed frame embeddings
(B, num_prefix, d_model).  The encoder is bidirectional self-attention +
MLP; the decoder adds causal self-attention (ring-cached for decode) and
cross-attention over the encoder output, whose K and V are computed once
per layer (:func:`prefill_cross`) and cached for decode.

The model is an :class:`EncDecLM` module with the reference's parameter
names and ``(in, out)`` layout: ``enc_layers`` and ``layers`` are
``nn.ModuleList``s where the reference stacks on a leading L axis.  As in
:mod:`repro_torch.models.lm`, each layer module is called in turn (under
``cfg.remat`` through ``torch.utils.checkpoint``) and the loss runs inside
the model's call, so FSDP (:mod:`repro_torch.sharding.fsdp`) gathers each
unit's weights around its call.  Positions are learned tables (no RoPE:
``rope_theta`` is 0): ``enc_pos_embed`` (num_prefix, D) for the frames,
``pos_embed`` (learned_pos, D) for the tokens, read at the device ``pos``
in decode.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    MLP,
    cross_entropy,
    dense_init,
    embed,
    init_embed,
    mlp,
    model_device,
    ones_param,
    rms_norm,
    unembed,
    wide,
)
from repro_torch.models.lm import KPOS_EMPTY, mask_pad_logits, remat_call
from repro_torch.sharding.ctx import shard_batch_seq, shard_logits


# ==========================================================================
# cross attention
# ==========================================================================

class Cross(torch.nn.Module):
    """Cross-attention projections ``wq``, ``wk``, ``wv`` (d, H*hd) and
    ``wo`` (H*hd, d)."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
        dt = cfg.param_dtype
        self.wq = dense_init((d, H * hd), dt, generator, device)
        self.wk = dense_init((d, H * hd), dt, generator, device)
        self.wv = dense_init((d, H * hd), dt, generator, device)
        self.wo = dense_init((H * hd, d), dt, generator, device)


def init_cross(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> Cross:
    """The cross-attention projections of ``cfg`` on ``device``."""
    return Cross(cfg, generator, model_device(device))


def cross_kv(params: Cross, cfg: ArchConfig,
             memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, v) (B, P, H, hd) of the encoder output ``memory`` (B, P, D)."""
    B, P, _ = memory.shape
    H, hd = cfg.num_heads, cfg.head_dim
    k = (memory @ params.wk).reshape(B, P, H, hd)
    v = (memory @ params.wv).reshape(B, P, H, hd)
    return k, v


def cross_attention(params: Cross, cfg: ArchConfig, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of ``x`` (B, S, D) over ``k``, ``v`` (B, P, H,
    hd): q, k and v widened to float32 for the scores, the softmax and the
    PV product, the result cast back to ``x``'s dtype before ``wo``."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    f32 = wide(x.dtype)
    q = (x @ params.wq).reshape(B, S, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32))
    s = s / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32)).to(x.dtype)
    return out.reshape(B, S, H * hd) @ params.wo


# ==========================================================================
# init
# ==========================================================================

class EncBlock(torch.nn.Module):
    """One encoder layer: ``attn_norm``, ``ffn_norm``, ``attn`` (GQA),
    ``ffn`` (SwiGLU)."""

    def __init__(self, cfg: ArchConfig, generator, device: torch.device):
        super().__init__()
        self.attn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.ffn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.attn = attn.GQA(cfg, generator, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.param_dtype, generator, device)

    def forward(self, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
        return remat_call(cfg, _enc_layer, cfg, x, self)


class DecBlock(torch.nn.Module):
    """One decoder layer: ``attn_norm``, ``cross_norm``, ``ffn_norm``,
    ``attn`` (causal GQA), ``cross`` (:class:`Cross`), ``ffn`` (SwiGLU)."""

    def __init__(self, cfg: ArchConfig, generator, device: torch.device):
        super().__init__()
        self.attn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.cross_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.ffn_norm = ones_param(cfg.d_model, cfg.param_dtype, device)
        self.attn = attn.GQA(cfg, generator, device)
        self.cross = Cross(cfg, generator, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.param_dtype, generator, device)

    def forward(self, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                enc_out: torch.Tensor) -> torch.Tensor:
        # the layer reads the encoder output through a view of its own, so
        # backward sums this layer's two terms (k and v) of its gradient
        # before adding them to the other layers': the order in which FSDP's
        # per-unit hooks sum them, which keeps a sharded step bit for bit
        # this one in a world of one
        return remat_call(cfg, _dec_layer, cfg, x, self, positions, enc_out.view_as(enc_out))


class EncDecLM(torch.nn.Module):
    """``embed`` (vocab_pad, D; tied head), ``pos_embed`` (learned_pos, D),
    ``enc_pos_embed`` (num_prefix, D), ``final_norm``, ``enc_final_norm``,
    ``enc_layers`` (:class:`EncBlock` each) and ``layers`` (:class:`DecBlock`
    each)."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_dtype
        self.embed = init_embed(cfg.vocab_pad, cfg.d_model, dt, generator, device)
        self.pos_embed = dense_init((cfg.learned_pos, cfg.d_model), dt, generator, device,
                                    scale=0.02)
        self.enc_pos_embed = dense_init((cfg.num_prefix, cfg.d_model), dt, generator, device,
                                        scale=0.02)
        self.final_norm = ones_param(cfg.d_model, dt, device)
        self.enc_final_norm = ones_param(cfg.d_model, dt, device)
        self.enc_layers = torch.nn.ModuleList(
            EncBlock(cfg, generator, device) for _ in range(cfg.enc_layers))
        self.layers = torch.nn.ModuleList(
            DecBlock(cfg, generator, device) for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor,
                cfg: Optional[ArchConfig] = None) -> torch.Tensor:
        """Logits (B, S, V) in float32 of ``tokens`` given the frames
        ``prefix_embeds`` under ``cfg`` (the model's own by default)."""
        cfg = self.cfg if cfg is None else cfg
        return logits_of(self, cfg, forward(self, cfg, tokens, prefix_embeds)[0])


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> EncDecLM:
    """An :class:`EncDecLM` of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), its matrices fan-in truncated normals drawn from
    ``generator`` (which must live on ``device``)."""
    return EncDecLM(cfg, generator, model_device(device))


# ==========================================================================
# forward
# ==========================================================================

def _enc_layer(cfg: ArchConfig, x: torch.Tensor, p: EncBlock) -> torch.Tensor:
    """One encoder layer, bidirectional: every query and key is given the
    last position, so the causal test passes every key (window 0)."""
    P = x.shape[1]
    h = rms_norm(x, p.attn_norm)
    last = torch.full((P,), P - 1, dtype=torch.int64, device=x.device)
    out, _ = attn.gqa_attention(p.attn, cfg, h, last, window=0, chunk=cfg.attn_chunk)
    x = x + out
    h = rms_norm(x, p.ffn_norm)
    return x + mlp(p.ffn, h)


def encode(params: EncDecLM, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, P, D) stub embeddings -> encoder output (B, P, D)."""
    B, P, D = frames.shape
    x = frames.to(cfg.param_dtype) + params.enc_pos_embed[None, :P]
    x = shard_batch_seq(x)
    for layer in params.enc_layers:
        x = layer(cfg, x)
    return rms_norm(x, params.enc_final_norm)


def _dec_layer(cfg: ArchConfig, x: torch.Tensor, p: DecBlock, positions: torch.Tensor,
               enc_out: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p.attn_norm)
    out, _ = attn.gqa_attention(p.attn, cfg, h, positions, chunk=cfg.attn_chunk)
    x = x + out
    h = rms_norm(x, p.cross_norm)
    k, v = cross_kv(p.cross, cfg, enc_out)
    x = x + cross_attention(p.cross, cfg, h, k, v)
    h = rms_norm(x, p.ffn_norm)
    return x + mlp(p.ffn, h)


def forward(
    params: EncDecLM,
    cfg: ArchConfig,
    tokens: torch.Tensor,                 # (B, S)
    prefix_embeds: torch.Tensor,          # (B, P, D) frame embeddings (stub)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (decoder hidden (B, S, D), aux = 0)."""
    enc_out = encode(params, cfg, prefix_embeds)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = embed(tokens, params.embed) + params.pos_embed[positions][None]
    x = shard_batch_seq(x)
    for layer in params.layers:
        x = layer(cfg, x, positions, enc_out)
    x = rms_norm(x, params.final_norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_of(params: EncDecLM, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    """The tied head's logits, float32, the padded vocab at -1e30."""
    return mask_pad_logits(shard_logits(unembed(hidden, params.embed, tied=True)),
                           cfg.vocab_size)


def loss_fn(params: EncDecLM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.0,
            example_weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE of the decoder given the batch's ``prefix_embeds``
    frames; runs through the model's call (see the module docstring)."""
    logits = params(batch["tokens"], batch["prefix_embeds"], cfg=cfg)
    ce = cross_entropy(logits, batch["labels"]).mean(dim=-1)
    if example_weights is not None:
        denom = torch.clamp_min(torch.sum(example_weights), 1e-6)
        loss = torch.sum(example_weights * ce) / denom
    else:
        loss = ce.mean()
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}


# ==========================================================================
# decode
# ==========================================================================

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Decode state: ``layers`` with, stacked on L, the self-attention ring
    ``k``, ``v`` (L, B, cache_len, KV, hd) and the cross-attention
    ``cross_k``, ``cross_v`` (L, B, num_prefix, H, hd) that
    :func:`prefill_cross` fills; the int32 ``kpos`` (cache_len,) and
    ``pos``; all on ``device`` (``"meta"`` allocates nothing)."""
    dev = model_device(device)
    dt = dtype or cfg.param_dtype
    L, H, KV, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    P = cfg.num_prefix
    zeros = lambda shape: torch.zeros(shape, dtype=dt, device=dev)
    return {
        "layers": {
            "k": zeros((L, batch, cache_len, KV, hd)),
            "v": zeros((L, batch, cache_len, KV, hd)),
            "cross_k": zeros((L, batch, P, H, hd)),
            "cross_v": zeros((L, batch, P, H, hd)),
        },
        "kpos": torch.full((cache_len,), KPOS_EMPTY, dtype=torch.int32, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def prefill_cross(params: EncDecLM, cfg: ArchConfig, cache: Dict[str, Any],
                  frames: torch.Tensor) -> Dict[str, Any]:
    """Run the encoder once and write each decoder layer's cross K and V
    into the cache in place; returns the cache."""
    enc_out = encode(params, cfg, frames)
    ck, cv = cache["layers"]["cross_k"], cache["layers"]["cross_v"]
    for i, layer in enumerate(params.layers):
        k, v = cross_kv(layer.cross, cfg, enc_out)
        ck[i].copy_(k)
        cv[i].copy_(v)
    return cache


@torch.no_grad()
def decode_step(params: EncDecLM, cfg: ArchConfig, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """ONE new token (B, 1) against the standing cache: its k and v written
    into the ring slot, ``kpos`` and ``pos`` + 1, all in place; the cross
    K and V read as :func:`prefill_cross` left them.  Nothing is read on
    the host."""
    pos = cache["pos"]
    positions = pos.reshape(1).clone()
    x = embed(tokens, params.embed) + params.pos_embed[positions][None]
    kpos = attn.update_kpos(cache["kpos"], positions)
    lcs = cache["layers"]
    for i, p in enumerate(params.layers):
        h = rms_norm(x, p.attn_norm)
        out, _ = attn.gqa_attention(p.attn, cfg, h, positions,
                                    kv_cache=(lcs["k"][i], lcs["v"][i]), cache_positions=kpos)
        x = x + out
        h = rms_norm(x, p.cross_norm)
        x = x + cross_attention(p.cross, cfg, h, lcs["cross_k"][i], lcs["cross_v"][i])
        h = rms_norm(x, p.ffn_norm)
        x = x + mlp(p.ffn, h)
    x = rms_norm(x, params.final_norm)
    logits = logits_of(params, cfg, x)
    pos.add_(1)
    return logits, cache
