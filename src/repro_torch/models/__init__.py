"""Language models of the port (port of :mod:`repro.models`): the dense,
VLM, MoE (with GQA or MLA), SSM and hybrid decoder families
(:mod:`repro_torch.models.moe` holds the expert layers,
:mod:`repro_torch.models.ssm` the RWKV-6 and Mamba mixers), the
encoder-decoder family (:mod:`repro_torch.models.encdec`) and the
serving engine (:mod:`repro_torch.models.lm_serve`)."""

from repro_torch.models.api import (
    active_param_count,
    decode_step,
    forward_hidden,
    init_cache,
    init_params,
    loss_fn,
    param_count,
)

__all__ = [
    "init_params",
    "loss_fn",
    "forward_hidden",
    "init_cache",
    "decode_step",
    "param_count",
    "active_param_count",
]
