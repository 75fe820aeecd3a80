"""AdamW, hand-rolled as the reference's (port of :mod:`repro.optim.adamw`;
``torch.optim.AdamW`` computes in another order and clips nowhere).

State: {"m": float32 moments, "v": float32 moments, "step": 0-d int32},
the moments keyed by the parameter's qualified name.  ``adamw_update``
writes the parameters, the moments and the step in place under
``torch.no_grad()`` and reads nothing on the host.  The arithmetic is
the reference's, op for op: gradients widened to float32, one global-norm
clip over all leaves, ``b1 ** step`` bias correction in float32, decoupled
weight decay on the float32 parameter, the result cast back to each
parameter's dtype.

Parameters held by FSDP (:mod:`repro_torch.sharding.fsdp`) are DTensors:
the moments are the rank's local shards, each step updates the local
shard of each parameter in place, and the clip's squared norm is summed
over the ranks by one all-reduce (the exact sum in a world of one).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.utils.tree import named_leaves


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing it writes the DTensor); a
    plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _f32_zeros(params: Any) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(local(p).shape, dtype=torch.float32, device=p.device)
            for name, p in named_leaves(params)}


def _step_zero(params: Any) -> torch.Tensor:
    dev = next(t for _, t in named_leaves(params)).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def clip_scale(grads: Mapping[str, torch.Tensor], grad_clip: float) -> torch.Tensor:
    """min(1, grad_clip / max(||g||, 1e-12)) over all leaves, in float32;
    with DTensor gradients over the local shards, summed over their mesh."""
    from torch.distributed.tensor import DTensor

    sq = sum(torch.sum(local(g).to(torch.float32) * local(g).to(torch.float32))
             for g in grads.values())
    mesh = next((g.device_mesh for g in grads.values() if isinstance(g, DTensor)), None)
    if mesh is not None:
        torch.distributed.all_reduce(sq, group=mesh.get_group())
    gnorm = torch.sqrt(sq)
    return torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-12), max=1.0)


def adamw_init(params: Any) -> Dict[str, Any]:
    return {"m": _f32_zeros(params), "v": _f32_zeros(params), "step": _step_zero(params)}


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Mapping[str, torch.Tensor],
    state: Dict[str, Any],
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Any, Dict[str, Any]]:
    """One step on ``params`` (a module or a dict of tensors) with
    ``grads`` keyed by the same qualified names; returns (params, state),
    both updated in place."""
    step = state["step"].add_(1)
    scale = clip_scale(grads, grad_clip)
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    for name, p in named_leaves(params):
        p, g = local(p), local(grads[name]).to(torch.float32) * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
    return params, state
