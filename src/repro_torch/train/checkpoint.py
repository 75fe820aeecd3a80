"""Checkpointing (port of :mod:`repro.train.checkpoint`): the state as the
reference's path-keyed arrays in one ``.npz``.

The file is the reference's: ``<dir>/step%08d.npz`` and ``<dir>/LATEST``
naming it, keys joined by ``|`` on the reference's tree
(``params|layers|attn|wq``, ``opt|m|layers|ffn|w_up``, ``opt|step``,
``step``), layers stacked on a leading L axis, bfloat16 leaves as their
raw 16-bit words (``|V2``, what ``np.savez`` writes for the reference's
bfloat16 arrays).  Either package reads the other's float32 files; the
port also reads the reference's bfloat16 ones.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.utils.tree import named_leaves

_SEP = "|"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, a in flat.items():
        *path, leaf = key.split(_SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def save_checkpoint(path: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` (``train_state_init``'s layout) as
    ``<path>/step%08d.npz`` and point ``LATEST`` at it; returns the file."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"step{step:08d}.npz")
    np.savez(fname, **_flatten(train_state_to_numpy(state, bf16_words=True)))
    with open(os.path.join(path, "LATEST"), "w") as f:
        f.write(os.path.basename(fname))
    return fname


def load_checkpoint(path: str, like: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """A new state with the structure of ``like`` (its config, device,
    shapes and dtypes) holding ``LATEST``'s arrays, and its step number."""
    with open(os.path.join(path, "LATEST")) as f:
        fname = os.path.join(path, f.read().strip())
    with np.load(fname) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    model = like["params"]
    state = train_state_from_numpy(tree, model.cfg, device=like["step"].device)
    want = {name: (t.shape, t.dtype) for name, t in named_leaves(like)}
    got = {name: (t.shape, t.dtype) for name, t in named_leaves(state)}
    if got != want:
        diff = sorted(n for n in set(want) | set(got) if want.get(n) != got.get(n))
        raise ValueError(f"{fname} does not match the state it restores into: {diff[:5]}")
    step = int(fname.rsplit("step", 1)[1].split(".")[0])
    return state, step
