"""Common transformer building blocks (port of :mod:`repro.models.layers`).

The functions take tensors and compute as the reference does: norms,
RoPE and the logits in float32, cast back to the input's dtype.
Parameters are ``(in, out)`` matrices applied as ``x @ w``, the
reference's layout, so converting weights is a copy.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device


def model_device(device: DeviceLike) -> torch.device:
    """``resolve_device``, and the ``meta`` device (shapes, no storage)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def dense_init(shape: Sequence[int], dtype: torch.dtype, generator: Optional[torch.Generator],
               device: torch.device, scale: Optional[float] = None) -> torch.nn.Parameter:
    """Truncated-normal fan-in init: std ``1/sqrt(fan_in)`` (or ``scale``),
    cut at +-3 std, drawn in float32 from ``generator`` and then cast.

    Not ``jax.random.truncated_normal``'s bits: parity with the reference
    goes through :func:`repro_torch.convert.lm_params_from_numpy`.  On the
    ``meta`` device nothing is drawn."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if device.type == "meta":
        return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -3.0 * std, 3.0 * std, generator=generator)
    return torch.nn.Parameter(w.to(dtype))


def ones_param(d: int, dtype: torch.dtype, device: torch.device) -> torch.nn.Parameter:
    """A norm's gain, ones of ``dtype`` (the reference's ``jnp.ones``)."""
    return torch.nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the steps the reference runs in float32: float32 for a
    bf16 or float32 model, float64 for a float64 one, which then rounds
    nowhere to float32 (a float64 copy is how ``chip_smoke.py`` tells
    float32 rounding from a fault in decode's algebra)."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(wide(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(xf.dtype)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(wide(x.dtype))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(xf.dtype) + beta.to(xf.dtype)).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., S, H, hd) by per-position angles. positions: (..., S).
    The split-half rotation: the first and second halves of hd are the
    pair's two coordinates."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    wd = wide(x.dtype)
    ang = positions[..., None].to(wd) * inv                     # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(wd), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

class MLP(torch.nn.Module):
    """SwiGLU feed-forward: ``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d)."""

    def __init__(self, d: int, f: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator], device: torch.device):
        super().__init__()
        self.w_gate = dense_init((d, f), dtype, generator, device)
        self.w_up = dense_init((d, f), dtype, generator, device)
        self.w_down = dense_init((f, d), dtype, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: ``x * (1 / (1 +
    exp(-x)))``, each step rounded to ``x``'s dtype.  In bf16 that is up to
    3 ulps from ``F.silu``'s single rounding, on about a third of the
    elements."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ params.w_gate)
    return (g * (x @ params.w_up)) @ params.w_down


# --------------------------------------------------------------------------
# Embeddings / head
# --------------------------------------------------------------------------

def init_embed(vocab: int, d: int, dtype: torch.dtype, generator: Optional[torch.Generator],
               device: torch.device) -> torch.nn.Parameter:
    # 1/sqrt(d): unit-RMS hidden states and O(1) tied logits at init
    return dense_init((vocab, d), dtype, generator, device, scale=1.0 / math.sqrt(d))


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.to(torch.int64)]


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool) -> torch.Tensor:
    """Logits in f32 (softmax stability; f64 in a float64 model)."""
    w = table_or_head.to(wide(x.dtype))
    xf = x.to(w.dtype)
    if tied:
        return xf @ w.T        # table (V, D)
    return xf @ w              # head (D, V)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE. logits (..., V) f32, labels (...) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return logz - gold
