"""Sharding (port of :mod:`repro.sharding`): the partition rules
(:mod:`~repro_torch.sharding.specs`), the activation hooks
(:mod:`~repro_torch.sharding.ctx`) and FSDP over ``torch.distributed``
(:mod:`~repro_torch.sharding.fsdp`)."""

from repro_torch.sharding.ctx import (
    ShardingCtx,
    current_ctx,
    set_ctx,
    shard_batch_seq,
    shard_expert,
    shard_logits,
)
from repro_torch.sharding.specs import cache_shardings, param_shardings

__all__ = [
    "ShardingCtx",
    "current_ctx",
    "set_ctx",
    "shard_batch_seq",
    "shard_expert",
    "shard_logits",
    "param_shardings",
    "cache_shardings",
]
