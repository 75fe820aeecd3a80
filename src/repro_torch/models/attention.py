"""Attention mixers (port of :mod:`repro.models.attention`): full or
sliding-window grouped-query attention with optional qk-norm, and
DeepSeek-V2 MLA (multi-head latent attention), for training/prefill
(query-chunked) and decode over a ring-buffer cache.

Mixed precision as the reference: the score and the PV products take
the operands in their own dtype with float32 products and sums, the
probabilities are cast back to the query's dtype before the second
product, and its result back as well.  MLA's absorbed decode computes
every product in float32 and casts back to ``x``'s dtype before ``wo``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.layers import (
    apply_rope, dense_init, model_device, ones_param, rms_norm, wide)
from repro_torch.sharding.ctx import shard_heads

NEG_INF = -1e30


# ==========================================================================
# GQA
# ==========================================================================

class GQA(torch.nn.Module):
    """GQA projections ``wq`` (d, H*hd), ``wk``, ``wv`` (d, KV*hd), ``wo``
    (H*hd, d), and with qk-norm the gains ``q_norm``, ``k_norm`` (hd,)."""

    def __init__(self, cfg, generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = cfg.param_dtype
        self.wq = dense_init((d, H * hd), dt, generator, device)
        self.wk = dense_init((d, KV * hd), dt, generator, device)
        self.wv = dense_init((d, KV * hd), dt, generator, device)
        self.wo = dense_init((H * hd, d), dt, generator, device)
        if cfg.qk_norm:
            self.q_norm = ones_param(hd, dt, device)
            self.k_norm = ones_param(hd, dt, device)


def init_gqa(cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> GQA:
    """The GQA projections of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), drawn from ``generator`` (which must live on ``device``)."""
    return GQA(cfg, generator, model_device(device))


def _wide_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 products and sums whatever the operands'
    dtype (XLA's ``preferred_element_type=float32``; float64 in a float64
    model): a bf16 operand is exact in float32, so widening first gives the
    same result."""
    wd = wide(torch.promote_types(a.dtype, b.dtype))
    return torch.einsum(eq, a.to(wd), b.to(wd))


def _sdpa_chunked(
    q: torch.Tensor,            # (B, Sq, KV, G, hd)
    k: torch.Tensor,            # (B, Sk, KV, hd)
    v: torch.Tensor,            # (B, Sk, KV, hd)
    q_positions: torch.Tensor,  # (Sq,) global positions of queries
    k_positions: torch.Tensor,  # (Sk,) global positions of keys
    window: int,                # 0 = full causal
    chunk: int,
) -> torch.Tensor:
    """Exact causal attention, sequential over query chunks.  Sq must split
    into ``max(Sq // chunk, 1)`` equal chunks, as the reference's reshape
    requires."""
    B, Sq, KV, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nc = max(Sq // chunk, 1)
    chunk = Sq // nc
    if nc * chunk != Sq:
        raise ValueError(f"_sdpa_chunked: {Sq} queries do not split into {nc} "
                         f"chunks of {chunk}")
    outs = []
    for c in range(nc):
        qi = q[:, c * chunk:(c + 1) * chunk]                 # (B, c, KV, G, hd)
        qp = q_positions[c * chunk:(c + 1) * chunk]          # (c,)
        s = _wide_einsum("bqkgh,bskh->bkgqs", qi, k) * scale
        causal = k_positions[None, :] <= qp[:, None]         # (c, Sk)
        if window > 0:
            causal = causal & ((qp[:, None] - k_positions[None, :]) < window)
        s = torch.where(causal[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)                         # f32
        outs.append(_wide_einsum("bkgqs,bskh->bqkgh", p.to(q.dtype), v).to(q.dtype))
    out = outs[0] if nc == 1 else torch.cat(outs, dim=1)     # (B, Sq, KV, G, hd_v)
    return out.reshape(B, Sq, KV * G * v.shape[-1])


def gqa_attention(
    params: GQA,
    cfg,
    x: torch.Tensor,                       # (B, S, D)
    positions: torch.Tensor,               # (S,)
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # ((B,Sc,KV,hd) k, v)
    cache_positions: Optional[torch.Tensor] = None,                # (Sc,)
    window: Optional[int] = None,
    chunk: int = 1024,
):
    """Returns (out (B,S,D), new_kv).

    Training/prefill: kv_cache is None -> keys are this segment.
    Decode: kv_cache given, S==1 -> the token's k and v written into its
    ring slot of the cache IN PLACE, then attend over the cache ring.
    """
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    win = cfg.sliding_window if window is None else window

    q = (x @ params.wq).reshape(B, S, H, hd)
    k = (x @ params.wk).reshape(B, S, KV, hd)
    v = (x @ params.wv).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions[None, :], cfg.rope_theta)
        k = apply_rope(k, positions[None, :], cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)

    if kv_cache is None:
        out = _sdpa_chunked(q, k, v, positions, positions, win, chunk)
        new_kv = (k, v)
    else:
        # decode: the caller manages the ring buffer's kpos
        ck, cv = kv_cache
        slot = slot_of(positions, ck.shape[1]).reshape(1)
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        out = _sdpa_chunked(q, ck, cv, positions, cache_positions, win, chunk=1)
        new_kv = (ck, cv)
    return out @ params.wo, new_kv


def slot_of(positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Ring-buffer slot for a single decode token (a device tensor)."""
    return (positions[0] % cache_len).to(torch.int64)


def update_kpos(cache_positions: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Write the token's position into its ring slot of ``cache_positions``
    in place; returns it."""
    slot = slot_of(positions, cache_positions.shape[0]).reshape(1)
    return cache_positions.index_copy_(0, slot, positions.to(cache_positions.dtype))



# ==========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ==========================================================================

class MLA(torch.nn.Module):
    """MLA projections, ``(in, out)``: ``w_dq`` (d, r_q) and its norm
    ``q_ln``, ``w_uq`` (r_q, H*(dn+dr)); ``w_dkv`` (d, r_kv) and its norm
    ``kv_ln``, the shared rope key ``w_kpe`` (d, dr); ``w_uk`` (r_kv,
    H*dn), ``w_uv`` (r_kv, H*dv) and ``wo`` (H*dv, d)."""

    def __init__(self, cfg, generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        dt = cfg.param_dtype
        self.w_dq = dense_init((d, r_q), dt, generator, device)          # q down
        self.q_ln = ones_param(r_q, dt, device)
        self.w_uq = dense_init((r_q, H * (dn + dr)), dt, generator, device)
        self.w_dkv = dense_init((d, r_kv), dt, generator, device)        # kv down
        self.kv_ln = ones_param(r_kv, dt, device)
        self.w_kpe = dense_init((d, dr), dt, generator, device)          # shared rope key
        self.w_uk = dense_init((r_kv, H * dn), dt, generator, device)
        self.w_uv = dense_init((r_kv, H * dv), dt, generator, device)
        self.wo = dense_init((H * dv, d), dt, generator, device)


def init_mla(cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> MLA:
    """The MLA projections of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), drawn from ``generator`` (which must live on ``device``)."""
    return MLA(cfg, generator, model_device(device))


def _mla_qk(params: MLA, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Shared q/compressed-kv projections. Returns q_nope, q_pe, c_kv, k_pe."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = rms_norm(x @ params.w_dq, params.q_ln)
    q = (q_lat @ params.w_uq).reshape(B, S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions[None, :], cfg.rope_theta)
    c_kv = rms_norm(x @ params.w_dkv, params.kv_ln)                    # (B, S, r_kv)
    k_pe = (x @ params.w_kpe).reshape(B, S, 1, dr)
    k_pe = apply_rope(k_pe, positions[None, :], cfg.rope_theta)[:, :, 0]  # (B, S, dr)
    return q_nope, q_pe, c_kv, k_pe


def mla_attention(
    params: MLA,
    cfg,
    x: torch.Tensor,                       # (B, S, D)
    positions: torch.Tensor,               # (S,)
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B,Sc,r_kv), (B,Sc,dr)
    cache_positions: Optional[torch.Tensor] = None,                # (Sc,)
    chunk: int = 1024,
):
    """Returns (out (B,S,D), new_cache).

    Prefill/training materialises per-head K (dn+dr) and V (dv) from the
    latent and runs the chunked attention with KV = H, G = 1.  Decode uses
    the ABSORBED form: the token's ``c_kv`` and ``k_pe`` are written into
    their ring slot of the cache IN PLACE, the queries are mapped into the
    latent space through ``w_uk`` viewed (r_kv, H, dn), and attention runs
    directly over the (B, Sc, r_kv) compressed cache plus the rope part:
    r_kv + dr values a token and layer in place of 2 H hd."""
    B, S, D = x.shape
    H = cfg.num_heads
    dn, dr, dv, r_kv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)
    q_nope, q_pe, c_kv, k_pe = _mla_qk(params, cfg, x, positions)

    if kv_cache is None:
        # non-absorbed prefill: per-head K/V from the latent
        k_nope = shard_heads((c_kv @ params.w_uk).reshape(B, S, H, dn))
        v = shard_heads((c_kv @ params.w_uv).reshape(B, S, H, dv))
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        k = shard_heads(k)
        q = torch.cat([q_nope, q_pe], dim=-1).reshape(B, S, H, 1, dn + dr)
        q = shard_heads(q)
        out = _sdpa_chunked(q, k, v, positions, positions, 0, chunk)     # KV=H, G=1
        out = out.reshape(B, S, H * dv)
        new_cache = (c_kv, k_pe)
    else:
        cc, cpe = kv_cache
        slot = slot_of(positions, cc.shape[1]).reshape(1)
        cc.index_copy_(1, slot, c_kv.to(cc.dtype))
        cpe.index_copy_(1, slot, k_pe.to(cpe.dtype))
        ccf = cc.to(wide(cc.dtype))
        # absorbed: q~ (B,1,H,r_kv) = q_nope @ W_uk (viewed (r_kv, H, dn))
        q_lat = _wide_einsum("bqhd,rhd->bqhr", q_nope, params.w_uk.reshape(r_kv, H, dn))
        s = torch.einsum("bqhr,bsr->bhqs", q_lat, ccf)
        s = s + _wide_einsum("bqhd,bsd->bhqs", q_pe, cpe)
        s = s * scale
        mask = cache_positions[None, :] <= positions[:, None]          # (1, Sc)
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        lat = torch.einsum("bhqs,bsr->bqhr", p, ccf)                      # (B,1,H,r_kv)
        out = _wide_einsum("bqhr,rhv->bqhv", lat, params.w_uv.reshape(r_kv, H, dv))
        out = out.reshape(B, S, H * dv).to(x.dtype)
        new_cache = (cc, cpe)
    return out @ params.wo, new_cache
