"""SGD with momentum (port of :mod:`repro.optim.sgd`).  State: {"mom":
float32 momenta keyed by the parameter's qualified name}; ``sgd_update``
writes the parameters and momenta in place under ``torch.no_grad()``."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.optim.adamw import _f32_zeros
from repro_torch.utils.tree import named_leaves


def sgd_init(params: Any) -> Dict[str, Any]:
    return {"mom": _f32_zeros(params)}


@torch.no_grad()
def sgd_update(
    params: Any, grads: Mapping[str, torch.Tensor], state: Dict[str, Any], lr: torch.Tensor, *,
    momentum: float = 0.9
) -> Tuple[Any, Dict[str, Any]]:
    for name, p in named_leaves(params):
        mom = state["mom"][name]
        mom.mul_(momentum).add_(grads[name].to(torch.float32))
        p.copy_((p.to(torch.float32) - lr * mom).to(p.dtype))
    return params, state
