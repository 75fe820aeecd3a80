"""Activation-sharding context (port of :mod:`repro.sharding.ctx`).

Model code calls the ``shard_*`` helpers.  Outside a context (every path
of the port today) they return their input.  Under ``set_ctx`` each
computes the reference's spec, with the same divisibility checks, and
:func:`constrain` applies it: a DTensor is redistributed to the spec's
placements over its own mesh, a plain tensor is returned unchanged (the
port's FSDP gathers the weights, so its activations are plain tensors).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.sharding.specs import MESH_SIZES, Spec, canonical, placements, sanitize


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    dp_axes: Tuple[str, ...] = ("data",)   # batch axes, e.g. ("pod", "data")
    tp_axis: str = "model"
    seq_axis: Optional[str] = None          # set for sequence-parallel decode


_current: Optional[ShardingCtx] = None


@contextlib.contextmanager
def set_ctx(ctx: Optional[ShardingCtx]):
    global _current
    prev = _current
    _current = ctx
    try:
        yield
    finally:
        _current = prev


def current_ctx() -> Optional[ShardingCtx]:
    return _current


def constrain(x, spec: Spec):
    """``x`` laid out as ``spec``: a DTensor redistributed over its mesh,
    anything else unchanged."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
    return x


def constrain_with(x, spec_of: Callable[[ShardingCtx], Spec]):
    """The reference's in-model constraint: ``x`` laid out as
    ``spec_of(the current context)``, divisibility-sanitized for its shape
    (:func:`constrain`); ``x`` unchanged without a context."""
    if _current is None:
        return x
    return constrain(x, sanitize(spec_of(_current), tuple(x.shape)))


def _divisible(dim: int, ax) -> bool:
    if ax is None:
        return True
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    n = 1
    for a in axes:
        n *= MESH_SIZES[a]
    return dim % n == 0


def shard_batch_seq(x):
    """(B, S, ...) activations: batch over dp axes, seq over seq_axis
    (Megatron-style sequence parallelism)."""
    c = _current
    if c is None:
        return x
    dp = c.dp_axes if (c.dp_axes and _divisible(x.shape[0], c.dp_axes)) else None
    seq = c.seq_axis if _divisible(x.shape[1], c.seq_axis) else None
    rest = (None,) * (x.ndim - 2)
    return constrain(x, canonical((dp, seq, *rest)))


def shard_heads(x, head_axis: int = 2):
    """(B, S, H, ...) per-head tensors: heads over tp when divisible (MLA's
    materialised K/V; replicated otherwise by the divisibility check)."""
    c = _current
    if c is None or not _divisible(x.shape[head_axis], c.tp_axis):
        return x
    dp = c.dp_axes if (c.dp_axes and _divisible(x.shape[0], c.dp_axes)) else None
    spec = [None] * x.ndim
    spec[0] = dp
    spec[head_axis] = c.tp_axis
    return constrain(x, canonical(tuple(spec)))


def shard_logits(x):
    """(B, S, V) logits: batch over dp, vocab over tp."""
    c = _current
    if c is None:
        return x
    dp = c.dp_axes if (c.dp_axes and _divisible(x.shape[0], c.dp_axes)) else None
    return constrain(x, canonical((dp, None, c.tp_axis)))


def shard_expert(x):
    """(E, C, d) MoE buffers: experts over tp."""
    c = _current
    if c is None:
        return x
    rest = (None,) * (x.ndim - 1)
    return constrain(x, (c.tp_axis, *rest))
