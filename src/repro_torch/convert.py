"""Carry data, keys, coresets, fitted parameters and language-model
weights across from the reference package.

What the two packages must share is the dataset, the PRNG keys, to fit a
reference-built coreset with the port the coreset itself, to score against
a reference fit its k-means centers, to merge the reference tree's nodes
with the port the materialized coresets, and to compare the language
models their parameters, decode caches and train states (parameters,
AdamW moments, steps).  Everything crosses as numpy —
the port never sees a jax array.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.coreset import Coreset, MaterializedCoreset
from repro_torch.core.vfl import VFLDataset, _as_tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.specs import STACKS, port_name, stacked_tree


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


def _tensor_of(a, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of its dtype; a bfloat16 leaf (numpy has
    none of its own) goes across through its 16-bit words, whether it
    comes as ``ml_dtypes``' bfloat16 or as the raw ``|V2`` words that
    ``np.savez`` writes for it."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        words = torch.from_numpy(np.array(a).view(np.int16))
        return words.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy_of(t: torch.Tensor, bf16_words: bool) -> np.ndarray:
    """A tensor as a host numpy array; bfloat16 as float32 (exact), or with
    ``bf16_words`` as its raw 16-bit words (``|V2``, what ``np.savez``
    writes for the reference's bfloat16 arrays)."""
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view("V2") if bf16_words else a.float().numpy()
    return a.numpy()


def _flat(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _stack_sizes(cfg: ArchConfig) -> Dict[str, int]:
    """The reference's stacked subtrees and their layer counts: ``layers``
    (the decoder's), and ``enc_layers`` for the encoder-decoder."""
    sizes = {"layers": cfg.num_layers}
    if cfg.kind == "encdec":
        sizes["enc_layers"] = cfg.enc_layers
    return sizes


def _unstacked(tree: Dict[str, Any], cfg: ArchConfig, dev: torch.device):
    """(port name, tensor) of a reference tree keyed like the parameters:
    a ``layers`` (or ``enc_layers``) leaf stacked on L gives
    ``layers.{l}.<rest>`` its row l."""
    sizes = _stack_sizes(cfg)
    for name, leaf in _flat(tree):
        t = _tensor_of(leaf, dev)
        path = name.replace(".", "/")
        stack = path.split("/", 1)[0]
        if stack in STACKS and "/" in path:
            L = sizes.get(stack, 0)
            if t.shape[0] != L:
                raise ValueError(f"{name}: {t.shape[0]} stacked layers, config has {L}")
            yield from ((port_name(path, i), t[i]) for i in range(L))
        else:
            yield name, t


def _stacked(named) -> Dict[str, Any]:
    """The reference's tree of (port name, numpy array) pairs given in
    layer order: ``layers.{l}.<rest>`` (and ``enc_layers.{l}.<rest>``)
    stacked on a leading L axis under ``layers`` (``enc_layers``), dotted
    names nested."""
    return stacked_tree(named, np.stack)


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                         device: DeviceLike = "cuda"):
    """A port model (:class:`repro_torch.models.lm.DecoderLM`, or
    :class:`repro_torch.models.encdec.EncDecLM` for ``cfg.kind ==
    "encdec"``) holding the reference's parameter pytree (numpy leaves,
    ``layers`` and ``enc_layers`` stacked on a leading L axis): every leaf
    copied into the parameter of the same name and dtype, layer l's from
    row l of its stack (the MoE router, RWKV-6's
    ``decay_base`` and ``bonus_u`` and Mamba's ``dt_bias``, ``A_log`` and
    ``D`` stay float32 in a bf16 model, as in the reference)."""
    from repro_torch.models import api

    dev = resolve_device(device)
    model = api.init_params(cfg, device="meta").to_empty(device=dev)
    state = dict(model.named_parameters())
    seen = set()
    for pname, val in _unstacked(tree, cfg, dev):
        if pname not in state:
            raise ValueError(f"the reference's {pname} has no parameter in the port")
        p = state[pname]
        if p.shape != val.shape or p.dtype != val.dtype:
            raise ValueError(f"{pname}: the reference's {tuple(val.shape)} {val.dtype} "
                             f"against the port's {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(val)
        seen.add(pname)
    missing = sorted(set(state) - seen)
    if missing:
        raise ValueError(f"the reference's tree has no leaf for {missing}")
    return model


def lm_params_to_numpy(model, bf16_words: bool = False) -> Dict[str, Any]:
    """The reference's parameter pytree of a port model: numpy leaves,
    ``layers`` (and ``enc_layers``) stacked on a leading L axis.  bfloat16 leaves come back as
    float32 (exact; numpy has no bfloat16), or with ``bf16_words`` as their
    raw 16-bit words."""
    return _stacked((name, _numpy_of(p, bf16_words)) for name, p in model.named_parameters())


def train_state_to_numpy(state: Dict[str, Any], bf16_words: bool = False) -> Dict[str, Any]:
    """The reference's train state (``repro.train.train_state_init``'s
    tree) of a port one: ``params`` as :func:`lm_params_to_numpy`, the
    AdamW moments ``opt.m`` / ``opt.v`` stacked the same way, and the int32
    steps."""
    opt = state["opt"]
    step = lambda t: np.asarray(t.detach().cpu().numpy(), np.int32)
    return {"params": lm_params_to_numpy(state["params"], bf16_words),
            "opt": {"m": _stacked((n, _numpy_of(t, bf16_words)) for n, t in opt["m"].items()),
                    "v": _stacked((n, _numpy_of(t, bf16_words)) for n, t in opt["v"].items()),
                    "step": step(opt["step"])},
            "step": step(state["step"])}


def train_state_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                           device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A port train state (``repro_torch.train.train_state_init``'s
    layout) holding the reference's: the model by
    :func:`lm_params_from_numpy`, the float32 moments keyed by parameter
    name in the model's order, the steps as 0-d int32 tensors."""
    dev = resolve_device(device)
    model = lm_params_from_numpy(tree["params"], cfg, dev)
    params = dict(model.named_parameters())

    def moments(sub: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        got = {name: t.clone() for name, t in _unstacked(sub, cfg, dev)}
        if set(got) != set(params):
            raise ValueError(f"moments for {sorted(set(got) ^ set(params))} do not match the "
                             f"model's parameters")
        for name, p in params.items():
            if got[name].shape != p.shape or got[name].dtype != torch.float32:
                raise ValueError(f"{name}: a {tuple(got[name].shape)} {got[name].dtype} moment "
                                 f"for a {tuple(p.shape)} parameter (want float32)")
        return {name: got[name] for name in params}

    step = lambda a: torch.as_tensor(np.array(a, np.int32)).reshape(()).to(dev)
    opt = tree["opt"]
    return {"params": model,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]), "step": step(opt["step"])},
            "step": step(tree["step"])}


def lm_cache_from_numpy(cache: Dict[str, Any], device: DeviceLike = "cuda"):
    """A port decode cache from the reference's (``layers`` with its
    family's leaves, stacked on L, in their own dtypes — the float32
    ``wkv`` and ``mamba_h`` in a bf16 cache too, the encoder-decoder's
    ``cross_k`` / ``cross_v`` — the int32 ``pos`` and, where the cache has
    a ring, ``kpos``) as numpy."""
    dev = resolve_device(device)
    out = {"layers": {k: _tensor_of(v, dev) for k, v in cache["layers"].items()},
           "pos": _tensor_of(np.asarray(cache["pos"], np.int32), dev)}
    if "kpos" in cache:
        out["kpos"] = _tensor_of(np.asarray(cache["kpos"], np.int32), dev)
    return out
