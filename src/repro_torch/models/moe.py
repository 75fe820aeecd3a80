"""Mixture-of-Experts FFN (port of :mod:`repro.models.moe`): a top-k
softmax router and the Switch/GLaM grouped one-hot dispatch.

Tokens are split into groups of ``Sg`` (``_pick_group``), each group builds
(Sg, E, C) dispatch and combine masks (position-in-expert by a per-slot
cumsum), and pack, the experts' SwiGLU and unpack are einsums:

    dispatched = einsum('gsec,gsd->gecd', dispatch, x)
    out        = einsum('gsec,gecd->gsd', combine, y)

Capacity ``C = ceil(Sg*K/E * capacity_factor)``; tokens past it are
dropped.  Both of the reference's mask builds are kept: ``kloop`` (the
``ArchConfig`` default, K accumulation passes in float32, then cast to
the input's dtype) and ``einsum`` (one einsum over stacked per-slot
one-hots built in the input's dtype).  The reference's sharding
constraints sit where it has them (:func:`_constrain`; no-ops without a
:mod:`repro_torch.sharding.ctx` context).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.layers import dense_init, model_device, silu
from repro_torch.sharding import ctx as shctx


class MoE(torch.nn.Module):
    """``router`` (d, E) in float32, ``w_gate``, ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model's dtype."""

    def __init__(self, cfg, generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = dense_init((d, E), torch.float32, generator, device)
        self.w_gate = dense_init((E, d, f), cfg.param_dtype, generator, device)
        self.w_up = dense_init((E, d, f), cfg.param_dtype, generator, device)
        self.w_down = dense_init((E, f, d), cfg.param_dtype, generator, device)


def init_moe(cfg, generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> MoE:
    """The MoE layer of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), drawn from ``generator`` (which must live on ``device``)."""
    return MoE(cfg, generator, model_device(device))


def _constrain(x: torch.Tensor, *rest) -> torch.Tensor:
    """The reference's constraint (dp, *rest), divisibility-sanitized; no-op
    without a ctx."""
    return shctx.constrain_with(x, lambda c: (c.dp_axes or None, *rest))


def _pick_group(N: int, group_size: int) -> int:
    """Largest group <= group_size dividing N."""
    g = min(group_size, N)
    while N % g != 0:
        g -= 1
    return g


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params: MoE, cfg, xg: torch.Tensor):
    """(probs (G, Sg, E) f32, gate_vals (G, Sg, K) renormalised, expert_ids
    (G, Sg, K)) of the router on grouped tokens ``xg`` (G, Sg, D)."""
    logits = xg.to(torch.float32) @ params.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_ids


def moe_ffn(
    params: MoE,
    cfg,
    x: torch.Tensor,                 # (B, S, D)
    capacity_factor: float = 1.25,
    group_size: int = 256,
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (out (B,S,D), aux_loss scalar; None without ``with_aux``, as
    decode, which drops it, calls it)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    N = B * S
    Sg = _pick_group(N, getattr(cfg, "moe_group", group_size))
    G = N // Sg
    f32 = torch.float32
    xg = _constrain(x.reshape(G, Sg, D), None, None)
    probs, gate_vals, expert_ids = route(params, cfg, xg)

    # ---- switch-style load-balance aux loss: ce counts the chosen experts
    aux = None
    if with_aux:
        me = probs.reshape(N, E).mean(dim=0)                      # (E,)
        flat = expert_ids.reshape(-1)
        ce = torch.zeros((E,), dtype=f32, device=x.device).index_add_(
            0, flat, torch.ones(flat.shape, dtype=f32, device=x.device)) / (N * K)
        aux = E * torch.sum(me * ce)

    # ---- grouped one-hot dispatch
    C = int(math.ceil(Sg * K / E * capacity_factor))
    mask_spec = (None, "model", None) if E % 16 == 0 else (None, None, "model")
    tok_spec = ("model", None, None) if E % 16 == 0 else (None, "model", None)
    fill = torch.zeros((G, E), dtype=f32, device=x.device)
    if getattr(cfg, "moe_dispatch", "einsum") == "einsum":
        pos_slots, keep_slots = [], []
        for k in range(K):
            mk = _one_hot(expert_ids[..., k], E, f32)                # (G,Sg,E)
            pos = torch.cumsum(mk, dim=1) - mk + fill[:, None, :]
            pos_tok = torch.sum(pos * mk, dim=-1)                    # (G,Sg)
            keep_slots.append(pos_tok < C)
            pos_slots.append(pos_tok)
            fill = fill + mk.sum(dim=1)
        pos_all = torch.stack(pos_slots, dim=2).to(torch.int32)     # (G,Sg,K)
        keep_all = torch.stack(keep_slots, dim=2)                   # (G,Sg,K)
        oh_e = _one_hot(expert_ids, E, x.dtype) * keep_all[..., None].to(x.dtype)
        oh_c = _one_hot(pos_all, C, x.dtype)                        # (G,Sg,K,C)
        dispatch = torch.einsum("gske,gskc->gsec", oh_e, oh_c)
        combine = torch.einsum("gske,gskc->gsec",
                               oh_e * gate_vals[..., None].to(x.dtype), oh_c)
    else:
        # the Switch-style K-pass accumulation (the reference's default)
        dispatch = torch.zeros((G, Sg, E, C), dtype=f32, device=x.device)
        combine = torch.zeros((G, Sg, E, C), dtype=f32, device=x.device)
        for k in range(K):
            mk = _one_hot(expert_ids[..., k], E, f32)
            pos = torch.cumsum(mk, dim=1) - mk + fill[:, None, :]
            keep = mk * (pos < C)
            slot = _one_hot(pos.to(torch.int32), C, f32)
            dk = keep[..., None] * slot
            dispatch = dispatch + dk
            combine = combine + dk * gate_vals[..., k][:, :, None, None]
            fill = fill + mk.sum(dim=1)
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
    dispatch = _constrain(dispatch, *mask_spec)
    combine = _constrain(combine, *mask_spec)

    # ---- pack -> expert FFN -> unpack
    disp = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    disp = _constrain(disp, *tok_spec)
    g = silu(torch.einsum("gecd,edf->gecf", disp, params.w_gate))
    u = torch.einsum("gecd,edf->gecf", disp, params.w_up)
    y = torch.einsum("gecf,efd->gecd", g * u, params.w_down)
    y = _constrain(y, *tok_spec)
    out = torch.einsum("gsec,gecd->gsd", combine, y)
    out = _constrain(out, None, None)
    return out.reshape(B, S, D), aux
