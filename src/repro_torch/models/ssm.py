"""Attention-free mixers (port of :mod:`repro.models.ssm`): RWKV-6 (Finch)
and a Mamba-style selective SSM branch (for Hymba's parallel heads).

Both run in the reference's CHUNKED form: a loop over chunks carries the
recurrent state while the work inside a chunk is (C x C) / (C x d)
products, so the materialised state stays O(B H hd^2) a chunk.  The
chunked WKV keeps the reference's algebra term for term; the Mamba
chunk's linear recurrence ``h_t = a_t h_{t-1} + b_t`` is the odd/even
recursion of ``jax.lax.associative_scan``, the same products and sums in
the same order.

Numerics: per-token log-decays are clamped to [-DECAY_CLAMP, 0] so the
within-chunk exp() of cumulative decays stays in float32 range, as the
reference's.  The decay base, the bonus ``u`` and Mamba's ``dt_bias``,
``A_log`` and ``D`` are float32 in a bf16 model, as the reference's; what
the reference computes in float32 runs in ``layers.wide`` of the model's
dtype (float64 in a float64 model).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.device import DeviceLike
from repro_torch.models.layers import dense_init, model_device, ones_param, rms_norm, silu, wide
from repro_torch.sharding import ctx as shctx

DECAY_CLAMP = 2.0   # max |log w| per token; chunk 32 -> exponent <= 64 (f32-safe)


def _full(shape, value: float, dtype: torch.dtype, device: torch.device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.full(tuple(shape), value, dtype=dtype, device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` computes ``log1p(exp(x))`` with a
    linear tail past 20, and rounds otherwise)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _chunks(S: int, chunk: int, who: str) -> Tuple[int, int]:
    """(number of chunks, chunk length): ``max(S // chunk, 1)`` equal chunks,
    as the reference's reshape requires."""
    nc = max(S // chunk, 1)
    c = S // nc
    if nc * c != S:
        raise ValueError(f"{who}: {S} positions do not split into {nc} chunks of {c}")
    return nc, c


# ==========================================================================
# RWKV-6 (Finch): data-dependent decay WKV, chunked
# ==========================================================================

class RWKV6(torch.nn.Module):
    """RWKV-6 time mix: token-shift lerps ``mix_{r,k,v,w}`` (d,), the
    projections ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o`` (d, d), the
    data-dependent decay ``decay_base`` (d,) float32 plus the low-rank
    ``decay_lora_a`` (d, lora) and ``decay_lora_b`` (lora, d), the per-head
    bonus ``bonus_u`` (H, hd) float32 and the output norm ``ln_out``."""

    def __init__(self, cfg, generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        hd = d // H
        lora = max(32, hd // 2)
        dt = cfg.param_dtype
        # token-shift mixing coefficients (static lerp; data-dep part via lora)
        self.mix_r = _full((d,), 0.5, dt, device)
        self.mix_k = _full((d,), 0.5, dt, device)
        self.mix_v = _full((d,), 0.5, dt, device)
        self.mix_w = _full((d,), 0.5, dt, device)
        self.w_r = dense_init((d, d), dt, generator, device)
        self.w_k = dense_init((d, d), dt, generator, device)
        self.w_v = dense_init((d, d), dt, generator, device)
        self.w_g = dense_init((d, d), dt, generator, device)
        self.w_o = dense_init((d, d), dt, generator, device)
        # data-dependent decay: w_t = -softplus(base + lora(x)) (log-space)
        self.decay_base = _full((d,), -1.0, wide(dt), device)
        self.decay_lora_a = dense_init((d, lora), dt, generator, device)
        self.decay_lora_b = dense_init((lora, d), dt, generator, device, scale=1e-2)
        self.bonus_u = _full((H, hd), 0.0, wide(dt), device)           # per-head u
        self.ln_out = ones_param(d, dt, device)                         # group-ish norm


def init_rwkv6(cfg, generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> RWKV6:
    """The RWKV-6 parameters of ``cfg`` on ``device`` (``"meta"`` allocates
    nothing), drawn from ``generator`` (which must live on ``device``)."""
    return RWKV6(cfg, generator, model_device(device))


def _chunked_wkv(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
    state0: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6.

    r,k,v,logw: (B, S, H, hd); u: (H, hd); state0: (B, H, hd, hd).
    Recurrence: S_t = diag(w_t) S_{t-1} + k_t v_t^T
                y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    Returns (y (B,S,H,hd) float32, state (B,H,hd,hd) float32), float64
    for float64 inputs.
    """
    B, S, H, hd = r.shape
    nc, c = _chunks(S, chunk, "_chunked_wkv")

    def stack(x):
        x = x.reshape(B, nc, c, H, hd).permute(1, 0, 3, 2, 4)          # (nc,B,H,c,hd)
        # the reference's constraint: head_dim over the model axis
        return shctx.constrain_with(
            x, lambda c: (None, c.dp_axes or None, None, None, c.tp_axis))

    rc, kc, vc, wc = stack(r), stack(k), stack(v), stack(logw)
    f32 = wide(r.dtype)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    uu = u.to(f32)[None, :, None, :]
    state = state0.to(f32)
    ys = []
    for i in range(nc):
        ri, ki, vf = rc[i].to(f32), kc[i].to(f32), vc[i].to(f32)      # (B,H,c,hd)
        lwi = wc[i].to(f32)
        L = torch.cumsum(lwi, dim=2)                  # inclusive cumulative log decay
        Lprev = L - lwi                               # exclusive (decay before t)
        # inter-chunk: y_inter_t = (r_t * exp(Lprev_t))^T S0
        r_dec = ri * torch.exp(Lprev)
        y_inter = torch.einsum("bhck,bhkv->bhcv", r_dec, state)
        # intra-chunk: A_{tj} = sum_d r_td k_jd exp(Lprev_t - L_j), j < t
        k_dec = ki * torch.exp(-L)
        A = torch.einsum("bhtk,bhjk->bhtj", r_dec, k_dec)
        A = torch.where(tri, A, 0.0)
        diag = torch.einsum("bhtk,bhtk->bht", ri, ki * uu)
        ys.append(y_inter + torch.einsum("bhtj,bhjv->bhtv", A, vf) + diag[..., None] * vf)
        # state update: S_C = diag(exp(L_C)) S0 + sum_j diag(exp(L_C - L_j)) k_j v_j^T
        Lc = L[:, :, -1:, :]                          # (B,H,1,hd)
        k_carry = ki * torch.exp(Lc - L)
        state = torch.exp(Lc[:, :, 0, :])[..., None] * state + \
            torch.einsum("bhjk,bhjv->bhkv", k_carry, vf)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return y, state


def rwkv6_mixer(
    params: RWKV6,
    cfg,
    x: torch.Tensor,                                   # (B, S, D)
    state: Optional[Dict[str, torch.Tensor]] = None,   # {"wkv": (B,H,hd,hd), "shift": (B,D)}
    chunk: int = 32,
):
    """Returns (out (B,S,D), new_state {"wkv", "shift"})."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    first = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device) if state is None
             else state["shift"][:, None].to(x.dtype))
    prev = torch.cat([first, x[:, :-1]], dim=1)

    def mixed(name):
        m = getattr(params, f"mix_{name}")
        return x * m + prev * (1 - m)

    r = (mixed("r") @ params.w_r).reshape(B, S, H, hd)
    k = (mixed("k") @ params.w_k).reshape(B, S, H, hd)
    v = (mixed("v") @ params.w_v).reshape(B, S, H, hd)
    g = silu(x @ params.w_g)
    lw = params.decay_base + (mixed("w") @ params.decay_lora_a) @ params.decay_lora_b
    wd = wide(x.dtype)
    logw = -torch.clamp(softplus(lw.to(wd)), 0.0, DECAY_CLAMP)
    logw = logw.reshape(B, S, H, hd)

    s0 = (torch.zeros((B, H, hd, hd), dtype=wd, device=x.device) if state is None
          else state["wkv"])
    y, s_new = _chunked_wkv(r, k, v, logw, params.bonus_u, s0, chunk)
    y = rms_norm(y.reshape(B, S, D).to(x.dtype), params.ln_out)
    out = (y * g) @ params.w_o
    return out, {"wkv": s_new, "shift": x[:, -1]}


# ==========================================================================
# Mamba-style selective SSM branch (Hymba)
# ==========================================================================

class Mamba(torch.nn.Module):
    """Selective SSM branch: ``w_in`` (d, 2 di) for x and the gate,
    ``w_bcdt`` (di, 2N+1) for B, C and dt, the float32 ``dt_bias`` (1,),
    ``A_log`` (di, N) = log(1..N) and ``D`` (di,), ``w_out`` (di, d) and
    the norm ``ln_out`` (di,)."""

    def __init__(self, cfg, generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        d, di, N = cfg.d_model, cfg.mamba_d_inner, cfg.ssm_state
        dt = cfg.param_dtype
        f32 = wide(dt)
        self.w_in = dense_init((d, 2 * di), dt, generator, device)        # x & gate
        self.w_bcdt = dense_init((di, 2 * N + 1), dt, generator, device)  # B, C, dt
        self.dt_bias = _full((1,), 0.0, f32, device)
        # log 1..N with jnp.log's bits (made on the host: a handful of values)
        log_n = rng.log(torch.arange(1, N + 1, dtype=torch.float32)).to(device, f32)
        self.A_log = torch.nn.Parameter(
            log_n[None, :] * torch.ones((di, 1), dtype=f32, device=device))  # (di, N)
        self.D = _full((di,), 1.0, f32, device)
        self.w_out = dense_init((di, d), dt, generator, device)
        self.ln_out = ones_param(di, dt, device)


def init_mamba(cfg, generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> Mamba:
    """The Mamba branch's parameters of ``cfg`` on ``device`` (``"meta"``
    allocates nothing), drawn from ``generator`` (which must live on
    ``device``)."""
    return Mamba(cfg, generator, model_device(device))


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1) if even.shape[1] > n else both


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 under ``(al, bl) . (ar, br) = (al ar, br +
    ar bl)``: ``b``'s result is ``h_t = a_t h_{t-1} + b_t`` from ``h = 0``,
    ``a``'s the running product.  The odd/even recursion of
    ``jax.lax.associative_scan``: the same combines of the same
    elements."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the pairs, then fill in the even places
    ra = a[:, 0:-1:2] * a[:, 1::2]
    rb = b[:, 1::2] + a[:, 1::2] * b[:, 0:-1:2]
    oa, ob = _linear_scan(ra, rb)
    if n % 2 == 0:
        pa, pb = oa[:, :-1], ob[:, :-1]
    else:
        pa, pb = oa, ob
    ea = pa * a[:, 2::2]
    eb = b[:, 2::2] + a[:, 2::2] * pb
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def mamba_mixer(
    params: Mamba,
    cfg,
    x: torch.Tensor,                          # (B, S, D)
    state: Optional[torch.Tensor] = None,     # (B, di, N) float32
    chunk: int = 64,
):
    """Selective SSM: h_t = exp(A*dt_t) h_{t-1} + dt_t B_t x_t; y = C_t.h_t + D x.
    Returns (out (B,S,D), the final state (B, di, N) float32)."""
    B, S, D = x.shape
    di, N = cfg.mamba_d_inner, cfg.ssm_state
    f32 = wide(x.dtype)
    xz = x @ params.w_in
    u, z = torch.chunk(xz, 2, dim=-1)                  # (B,S,di) each
    u = silu(u)
    bcdt = u @ params.w_bcdt                           # (B,S,2N+1)
    Bm, Cm, dt = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    dt = softplus(dt.to(f32) + params.dt_bias)
    dt = torch.clamp(dt, 1e-4, 10.0)                   # (B,S,1): scalar dt per token
    A = -torch.exp(params.A_log)                       # (di, N), negative

    nc, c = _chunks(S, chunk, "mamba_mixer")
    uc = u.to(f32).reshape(B, nc, c, di)
    Bc = Bm.to(f32).reshape(B, nc, c, N)
    Cc = Cm.to(f32).reshape(B, nc, c, N)
    dtc = dt.reshape(B, nc, c, 1)
    h = torch.zeros((B, di, N), dtype=f32, device=x.device) if state is None else state
    ys = []
    for i in range(nc):
        ui, Bi, Ci, dti = uc[:, i], Bc[:, i], Cc[:, i], dtc[:, i]  # (B,c,di|N|N|1)
        a = torch.exp(dti[..., None] * A[None, None])    # (B,c,di,N)
        b = (dti * Bi)[:, :, None, :] * ui[..., None]    # (B,c,di,N)
        a_sc, b_sc = _linear_scan(a, b)
        hs = a_sc * h[:, None] + b_sc                    # (B,c,di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Ci))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]        # (B,S,di)
    y = y + params.D[None, None] * u.to(f32)
    y = rms_norm(y.to(x.dtype), params.ln_out) * silu(z)
    return y @ params.w_out, h
