"""Attention mixers (port of :mod:`repro.models.attention`, its GQA half):
full or sliding-window grouped-query attention with optional qk-norm, for
training/prefill (query-chunked) and decode over a ring-buffer KV cache.

Mixed precision as the reference: the score and the PV products take
the operands in their own dtype with float32 products and sums, the
probabilities are cast back to the query's dtype before the second
product, and its result back as well.  MLA (DeepSeek-V2) is not ported:
``models.lm.require_ported`` raises for it, naming ``MLA_ITEM``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.layers import apply_rope, dense_init, model_device, ones_param, rms_norm

NEG_INF = -1e30

#: What MLA waits for.
MLA_ITEM = "ROADMAP queue 1, item 18.4 (MLA)"


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


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 products and sums whatever the operands'
    dtype (XLA's ``preferred_element_type=float32``): a bf16 operand is
    exact in float32, so widening first gives the same result."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


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
        s = _f32_einsum("bqkgh,bskh->bkgqs", qi, k) * scale
        causal = k_positions[None, :] <= qp[:, None]         # (c, Sk)
        if window > 0:
            causal = causal & ((qp[:, None] - k_positions[None, :]) < window)
        s = torch.where(causal[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)                         # f32
        outs.append(_f32_einsum("bkgqs,bskh->bqkgh", p.to(q.dtype), v).to(q.dtype))
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

