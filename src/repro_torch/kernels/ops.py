"""Dispatch over the port's kernels.

``use_kernel=True`` (what the reference's ``"pallas"`` backend selects)
means the hand-written kernel: on a CUDA tensor it launches the kernel or
raises, on a CPU tensor the wrapper takes the plain version.
``use_kernel=False`` (``backend="ref"``) runs the plain PyTorch version on
any device.  There is no environment switch: the plain version is reached
only by asking for ``"ref"`` or by placing the data on the CPU.

The DIS draw (:func:`categorical`, :func:`categorical_parties`) has no
``use_kernel``: it follows the device of the logits alone, as the
reference's ``jax.random.categorical`` has no backend switch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.categorical import categorical, categorical_parties
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_assign
from repro_torch.kernels.kmeans_assign_update import (
    kmeans_assign_update as _kmeans_assign_update,
)
from repro_torch.kernels.leverage import leverage as _leverage
from repro_torch.kernels.weighted_gram import weighted_gram as _weighted_gram

#: Every kernel wrapper, each with its ``launches`` counter.
COUNTED = (_leverage, _weighted_gram, _kmeans_assign, _kmeans_assign_update,
           categorical)


def leverage(X: torch.Tensor, M: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    return _leverage(X, M) if use_kernel else ref.leverage(X, M)


def weighted_gram(X: torch.Tensor, w: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    return _weighted_gram(X, w) if use_kernel else ref.weighted_gram(X, w)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor, use_kernel: bool = True):
    return _kmeans_assign(X, C) if use_kernel else ref.kmeans_assign(X, C)


def kmeans_assign_update(X: torch.Tensor, C: torch.Tensor,
                         w: Optional[torch.Tensor] = None,
                         use_kernel: bool = True):
    """(assign, d2, csum, wsum, ccost) in one read of X."""
    if use_kernel:
        return _kmeans_assign_update(X, C, w)
    return ref.kmeans_assign_update(X, C, w)
