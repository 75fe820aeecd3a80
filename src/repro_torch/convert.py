"""Carry data, keys, coresets and fitted parameters across from the
reference package.

This system has no model weights: what the two packages must share is the
dataset, the PRNG keys, to fit a reference-built coreset with the port the
coreset itself, to score against a reference fit its k-means centers, and
to merge the reference tree's nodes with the port the materialized
coresets.  Everything crosses as numpy — the port never sees a jax array.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coreset import Coreset, MaterializedCoreset
from repro_torch.core.vfl import VFLDataset, _as_tensor
from repro_torch.device import DeviceLike, resolve_device


def dataset_from_numpy(parts: Sequence[np.ndarray], y: Optional[np.ndarray],
                       device: DeviceLike = "cuda") -> VFLDataset:
    """A :class:`VFLDataset` from the column blocks (and labels) of a
    ``repro.core.VFLDataset``, taken as numpy arrays."""
    dev = resolve_device(device)
    return VFLDataset([_as_tensor(np.asarray(p), dev) for p in parts],
                      None if y is None else _as_tensor(np.asarray(y), dev))


def key_from_numpy(data, device: DeviceLike = "cuda") -> torch.Tensor:
    """A port key from the (2,) uint32 key data of a jax PRNG key
    (``np.asarray(key)`` or ``jax.random.key_data(key)``)."""
    words = np.asarray(data)
    if words.shape != (2,) or words.dtype != np.uint32:
        raise ValueError(f"key data must be (2,) uint32, got {words.shape} "
                         f"{words.dtype}")
    return torch.as_tensor(words.astype(np.int64), device=resolve_device(device))


def coreset_from_numpy(indices, weights, comm_units: int, comm_bits: int = 0,
                       device: DeviceLike = "cuda") -> Coreset:
    """A port :class:`Coreset` from a reference coreset's indices and
    weights (as numpy) and its bill."""
    dev = resolve_device(device)
    return Coreset(torch.as_tensor(np.array(indices, dtype=np.int64), device=dev),
                   torch.as_tensor(np.array(weights, dtype=np.float32), device=dev),
                   int(comm_units), comm_bits=int(comm_bits))


def centers_from_numpy(centers, device: DeviceLike = "cuda") -> torch.Tensor:
    """The port's k-means parameters from a reference fit's centers (k, d)
    as numpy (``np.asarray(fit.params)``): a float32 tensor on ``device``,
    ready for ``evaluate(..., baseline=)`` or a ``FitResult``."""
    c = np.asarray(centers)
    if c.ndim != 2:
        raise ValueError(f"centers must be (k, d), got shape {c.shape}")
    return torch.as_tensor(c.astype(np.float32), device=resolve_device(device))


def materialized_from_numpy(mat) -> MaterializedCoreset:
    """A port :class:`MaterializedCoreset` from a reference one (its
    ``indices``, ``weights``, ``parts`` and ``y`` are already host numpy):
    the arrays copied across unchanged, indices as int64 and weights as
    float32, with the bill."""
    return MaterializedCoreset(
        indices=np.array(mat.indices, dtype=np.int64),
        weights=np.array(mat.weights, dtype=np.float32),
        parts=[np.array(p) for p in mat.parts],
        y=None if mat.y is None else np.array(mat.y),
        comm_units=int(mat.comm_units),
        comm_bits=int(mat.comm_bits),
    )
