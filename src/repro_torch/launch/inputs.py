"""Stand-ins for every model input, per (arch x shape) (port of
:mod:`repro.launch.inputs`): tensors on the ``meta`` device, which carry
shape and dtype and allocate nothing.  They are what the dry run
(:mod:`repro_torch.launch.dryrun`) feeds the port's steps.

The keys and shapes are the reference's ``ShapeDtypeStruct``s', including
the encoder-decoder's and ``vision_stub``'s ``prefix_embeds`` (precomputed
frame / patch embeddings in place of raw media).  Where the port's steps
consume another dtype, the dtype is the port's:

* ``prefix_embeds`` is ``cfg.param_dtype`` (the reference's is bfloat16
  whatever the config; its reduced configs widen it in the model, the
  port's take the model's dtype);
* the PRNG key a train step takes is ``rng.PRNGKey``'s ``(2,)`` int64
  words (the reference's is ``(2,)`` uint32).

Tokens and labels are int32, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins for one step of the shape's phase."""
    B, S = shape.global_batch, shape.seq_len
    if shape.is_decode:
        return {"tokens": _meta((B, 1), torch.int32)}
    prefix = _meta((B, cfg.num_prefix, cfg.d_model), cfg.param_dtype)
    if cfg.kind == "encdec":
        # the decoder consumes S tokens; the encoder the stub frames
        return {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32),
                "prefix_embeds": prefix}
    if cfg.frontend == "vision_stub":
        s_text = S - cfg.num_prefix
        return {"tokens": _meta((B, s_text), torch.int32),
                "labels": _meta((B, s_text), torch.int32), "prefix_embeds": prefix}
    return {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}


def prefill_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    specs = input_specs(cfg, shape)
    specs.pop("labels", None)
    return specs


def key_spec() -> torch.Tensor:
    """A train step's PRNG key: ``rng.PRNGKey``'s two int64 words."""
    return _meta((2,), torch.int64)


def cache_specs(cfg: ArchConfig, shape: InputShape) -> Any:
    """The decode cache of ``shape`` on ``meta``: ``init_cache``'s tree,
    allocating nothing."""
    from repro_torch.models import api as model_api

    return model_api.init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


def state_specs(cfg: ArchConfig) -> Any:
    """The train state (parameters, AdamW's m and v, the steps) on
    ``meta``."""
    from repro_torch.train.trainer import train_state_init

    return train_state_init(cfg, device=META)
