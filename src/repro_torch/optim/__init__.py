"""Optimizers and LR schedules of the port (port of :mod:`repro.optim`):
plain functions on tensors that update in place."""

from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.sgd import sgd_init, sgd_update
from repro_torch.optim.schedules import constant, cosine_with_warmup

__all__ = [
    "adamw_init",
    "adamw_update",
    "sgd_init",
    "sgd_update",
    "constant",
    "cosine_with_warmup",
]
