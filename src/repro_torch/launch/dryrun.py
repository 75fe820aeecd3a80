"""Production dry-run (port of :mod:`repro.launch.dryrun`): every (arch x
input shape) against the production mesh, with nothing allocated on any
device, proving the step fits and giving its roofline terms.

The reference lowers and compiles each step for 512 fake CPU devices and
reads XLA's ``memory_analysis``, ``cost_analysis`` and HLO text.  Here the
step runs once, eagerly, on the ``meta`` device (shapes and dtypes, no
storage), under ``torch.utils.flop_counter.FlopCounterMode`` and a
:class:`~repro_torch.launch.trace.StepCounter` (the bytes every aten op
moves, the fusion-optimistic bytes, the live bytes of the storages the
step makes).  The mesh is not built: its sizes
(:data:`~repro_torch.sharding.specs.MESH_SIZES`) enter through the specs.

A record carries the reference's keys.  Per device:

* ``hlo_flops`` and ``hlo_bytes``: the counted global FLOPs and bytes over
  ``chips`` (``"flops_per_device": "global/chips"``; the reference's SPMD
  module also counts replicated work); ``hlo_bytes_opt`` the same of the
  fusion-optimistic bytes;
* ``memory["argument_size_in_bytes"]``: exact, the ceil-divided shard of
  every tensor of the state (or parameters), the cache and the batch under
  ``param_shardings`` / ``opt_shardings`` / ``batch_shardings`` /
  ``cache_shardings``; ``memory["temp_size_in_bytes"]`` the live-storage
  peak of the step over ``chips`` (the reference shards the batch over
  ``data`` and the sequence over ``model``); ``peak_bytes_per_device`` their
  sum, and ``fits`` whether it is at most 80 GB;
* ``collective_bytes``: what the port executes across cards, FSDP over the
  data axes (:mod:`repro_torch.sharding.fsdp`; :func:`fsdp_collectives`).
  Tensor parallelism over ``model`` is assigned by the specs but not
  executed (``"tp_collectives": "not executed"``), so none is counted.

``lower_s`` is the time to build the step and its ``meta`` arguments,
``compile_s`` the time of the counted ``meta`` run, which stands for XLA's
compile.  The loops the reference runs as scans are Python loops here
(``trip_counts``), and a ``meta`` run pays Python's dispatch for every
op: :func:`roofline_one` runs L = 1 and L = 2 and extrapolates (total =
outer + L x per-layer), which is exact because all layers are identical.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --roofline
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --roofline --multi-pod

Records are appended as JSON lines to ``--out`` (default
``launch_out/dryrun.jsonl``, ignored by git).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import INPUT_SHAPES, all_arch_names, get_arch
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import roofline as rf
from repro_torch.launch import trace
from repro_torch.launch.inputs import (META, cache_specs, input_specs, key_spec,
                                       prefill_specs, state_specs)
from repro_torch.sharding import specs as sp

SKIPS = {
    # (arch, shape): reason -- the reference's table
    ("whisper-medium", "long_500k"):
        "enc-dec with 1500-frame encoder context; 524k-token decode is out of scope",
}

ShapeLike = Union[str, InputShape]

#: The counts a meta run gives (global FLOPs, bytes accessed,
#: fusion-optimistic bytes, the live-storage peak).
COUNTS = ("flops", "bytes", "bytes_opt", "act_peak")


def _shape(shape: ShapeLike) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


#: One card: the mesh of a run on a single chip.
ONE_CHIP = {"pod": 1, "data": 1, "model": 1}


def mesh_sizes(multi_pod: bool) -> Dict[str, int]:
    """The production mesh's axis sizes (a single pod has ``pod`` 1)."""
    return {**sp.MESH_SIZES, "pod": sp.MESH_SIZES["pod"] if multi_pod else 1}


def mesh_name(sizes: Dict[str, int]) -> str:
    """``16x16``, ``2x16x16``, ``1x1``: the sizes of ``data`` and ``model``,
    with ``pod`` first where there is more than one."""
    dims = [sizes[a] for a in ("pod", "data", "model") if a != "pod" or sizes["pod"] > 1]
    return "x".join(map(str, dims))


# --------------------------------------------------------------------------
# the step on meta
# --------------------------------------------------------------------------

def step_args(cfg: ArchConfig, shape: InputShape) -> tuple:
    """The ``meta`` arguments of the shape's phase: (state, batch, key) to
    train, (params, batch) to prefill, (params, cache, tokens) to decode."""
    from repro_torch.models import api as model_api

    if shape.phase == "train":
        return state_specs(cfg), input_specs(cfg, shape), key_spec()
    params = model_api.init_params(cfg, device=META)
    if shape.phase == "prefill":
        return params, prefill_specs(cfg, shape)
    return params, cache_specs(cfg, shape), input_specs(cfg, shape)["tokens"]


def build_step(cfg: ArchConfig, shape: InputShape, selector=None) -> Tuple[Callable, tuple]:
    """(fn, args) of the shape's phase, every argument on ``meta``: the
    train step (``make_train_step``) on ``state_specs``; prefill, the
    hidden states and the logits (the encoder-decoder's tied head); decode,
    ``make_serve_step`` on ``cache_specs``."""
    from repro_torch.models import api as model_api

    args = step_args(cfg, shape)
    if shape.phase == "train":
        from repro_torch.optim.schedules import constant
        from repro_torch.train.trainer import make_train_step

        return make_train_step(cfg, constant(1e-4), selector=selector), args
    if shape.phase == "prefill":
        from repro_torch.models import encdec, lm

        head = encdec.logits_of if cfg.kind == "encdec" else lm.logits_of

        @torch.no_grad()
        def prefill(params, batch):
            return head(params, cfg, model_api.forward_hidden(params, cfg, batch))

        return prefill, args

    from repro_torch.models.lm_serve import make_serve_step

    return torch.no_grad()(make_serve_step(cfg)), args


def measure(cfg: ArchConfig, shape: InputShape, selector=None) -> Dict[str, Any]:
    """Run the step once on ``meta`` and count it: global FLOPs, bytes
    accessed, fusion-optimistic bytes, the live-storage peak above the
    arguments; with the arguments themselves (``args``) and the seconds
    to build (``lower_s``) and run (``compile_s``)."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    fn, args = build_step(cfg, shape, selector)
    t1 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    with flops, trace.StepCounter(exclude=_arg_tensors(args)) as counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes": float(counter.bytes_accessed),
            "bytes_opt": float(counter.heavy_bytes), "act_peak": float(counter.peak),
            "args": args, "lower_s": t1 - t0, "compile_s": time.perf_counter() - t1}


def _arg_tensors(args) -> list:
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out.extend(a.parameters())
        elif isinstance(a, dict):
            out.extend(_arg_tensors(a.values()))
        elif isinstance(a, torch.Tensor):
            out.append(a)
    return out


# --------------------------------------------------------------------------
# per-device arguments and FSDP's collectives, from the specs
# --------------------------------------------------------------------------

def shard_bytes(shape, itemsize: int, spec: sp.Spec, sizes: Dict[str, int]) -> int:
    """Bytes of one device's shard of a tensor: each dim ceil-divided by
    the size of the axes its spec entry names."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    n = itemsize
    for dim, ax in zip(shape, axes):
        n *= -(-int(dim) // sp._axis_size(ax, sizes))
    return n


def _stacked(named) -> Dict[str, Any]:
    """``{reference path: (stacked shape, itemsize)}`` of (port name,
    tensor) pairs."""
    tree = sp.stacked_tree(((n, (tuple(t.shape), t.element_size())) for n, t in named),
                           lambda v: ((len(v), *v[0][0]), v[0][1]))
    return sp.flat_specs(tree)


def _tree_bytes(flat: Dict[str, Tuple[tuple, int]], spec_flat: Dict[str, sp.Spec],
                sizes: Dict[str, int]) -> int:
    return sum(shard_bytes(shape, isz, spec_flat[path], sizes)
               for path, (shape, isz) in flat.items())


def argument_bytes_per_device(cfg: ArchConfig, shape: InputShape, args: tuple,
                              multi_pod: bool = False,
                              sizes: Dict[str, int] = sp.MESH_SIZES) -> Dict[str, int]:
    """One device's bytes of the step's arguments, by part (``params``,
    ``opt``, ``steps``, ``batch``, ``key``, ``cache``) and ``total``: each
    tensor's shard under the reference's specs at the mesh's ``sizes``
    (default :data:`MESH_SIZES`)."""
    out = {}
    if shape.phase == "train":
        state, batch, key = args
        model = state["params"]
        out["opt"] = 2 * _tree_bytes(
            _stacked(state["opt"]["m"].items()),
            sp.flat_specs(sp.opt_shardings(sp.param_shardings(
                sp.stacked_shapes(state["opt"]["m"]), cfg, multi_pod, sizes))), sizes)
        out["steps"] = state["step"].element_size() + state["opt"]["step"].element_size()
        out["key"] = key.numel() * key.element_size()
    else:
        model = args[0]
        batch = args[1] if shape.phase == "prefill" else {"tokens": args[2]}
    pflat = _stacked(model.named_parameters())
    out["params"] = _tree_bytes(pflat, sp.flat_specs(sp.param_shardings(
        sp.stacked_shapes(model), cfg, multi_pod, sizes)), sizes)
    bspec = sp.batch_shardings(cfg, shape, multi_pod)
    out["batch"] = sum(shard_bytes(t.shape, t.element_size(), bspec[k], sizes)
                       for k, t in batch.items())
    if shape.is_decode:
        cache = args[1]
        cspec = sp.flat_specs(sp.cache_shardings(cache, cfg, shape, multi_pod))
        leaves = sp.flat_specs(cache)
        out["cache"] = sum(shard_bytes(t.shape, t.element_size(), cspec[p], sizes)
                           for p, t in leaves.items())
    out["total"] = sum(out.values())
    return out


def fsdp_collectives(model: torch.nn.Module, cfg: ArchConfig, phase: str,
                     sizes: Dict[str, int], multi_pod: bool = False,
                     selector=None) -> Dict[str, Dict[str, int]]:
    """Per kind ``{count, bytes}`` (result bytes, one device) of one step
    of ``model`` held by ``fully_shard_model`` over a data world of
    ``sizes["pod"] * sizes["data"]`` ranks (the multi-pod mesh as one data
    axis of 32; the port refuses more than one pod today).

    Each layer module and the root (the rest) is one FSDP unit.  A unit's
    all-gather returns every parameter whole, its shard dim padded to a
    multiple of the world (FSDP pads uneven shards); its reduce-scatter
    returns one rank's padded shard of every gradient.  A train step
    gathers every layer unit twice (forward, and again for the backward)
    and the root once (FSDP keeps the root unsharded after the forward),
    reduce-scatters each unit once and all-reduces the gradients' squared
    norm once (AdamW's clip, float32); a coreset step also gathers the
    embedding whole for its features.  A prefill or decode step gathers
    each unit once.  A world of one runs no gather and no reduce-scatter."""
    from repro_torch.sharding.fsdp import data_dim

    world = sizes["pod"] * sizes["data"]
    flat = sp.flat_specs(sp.param_shardings(sp.stacked_shapes(model), cfg, multi_pod, sizes))
    units: Dict[str, int] = {}
    padded: Dict[str, int] = {}
    for name, p in model.named_parameters():
        path, layer = sp.ref_path(name)
        spec = flat[path][1:] if layer is not None else flat[path]
        dim = data_dim(spec)
        rest = math.prod(n for i, n in enumerate(p.shape) if i != dim)
        padded[name] = -(-p.shape[dim] // world) * world * rest * p.element_size()
        unit = "" if layer is None else f"{name.split('.')[0]}.{layer}"
        units[unit] = units.get(unit, 0) + padded[name]
    out: Dict[str, Dict[str, int]] = {}

    def add(kind, count, nbytes):
        if count:
            c = out.setdefault(kind, {"count": 0, "bytes": 0})
            c["count"] += count
            c["bytes"] += nbytes

    if world > 1:
        for unit, nbytes in units.items():
            gathers = 2 if (phase == "train" and unit) else 1
            add("all-gather", gathers, gathers * nbytes)
            if phase == "train":
                add("reduce-scatter", 1, nbytes // world)
        if phase == "train" and selector is not None and selector.mode == "coreset":
            add("all-gather", 1, padded["embed"])
    if phase == "train":
        add("all-reduce", 1, 4)
    return out


# --------------------------------------------------------------------------
# records
# --------------------------------------------------------------------------

def _cfg(arch: str, shape: InputShape, layers_override: Optional[int],
         cfg_transform) -> ArchConfig:
    """The config of a run: the arch at ``shape``, then ``cfg_transform``,
    then the depth override (the encoder's depth capped by it too)."""
    cfg = get_arch(arch).for_shape(shape)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers_override,
                                  enc_layers=min(cfg.enc_layers, layers_override))
    return cfg


def _skip(arch: str, shape: InputShape, cfg: ArchConfig, sizes: Dict[str, int]):
    reason = SKIPS.get((arch, shape.name))
    if reason is None and shape.name == "long_500k" and not cfg.supports_long_context():
        reason = "no sub-quadratic decode variant"
    if reason is None:
        return None
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name(sizes),
            "status": "skipped", "reason": reason}


def _error(arch: str, shape: InputShape, sizes: Dict[str, int], e: Exception):
    return {"arch": arch, "shape": shape.name, "mesh": mesh_name(sizes), "phase": shape.phase,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def _record(arch: str, shape: InputShape, cfg: ArchConfig, counts: Dict[str, Any],
            multi_pod: bool, sizes: Dict[str, int], selector) -> Dict[str, Any]:
    """The record of one step of ``cfg`` (its depth) from its global counts
    and its ``meta`` arguments."""
    from repro_torch.models import api as model_api

    chips = math.prod(sizes.values())
    args = counts["args"]
    model = args[0]["params"] if shape.phase == "train" else args[0]
    arg_bytes = argument_bytes_per_device(cfg, shape, args, multi_pod, sizes)
    colls = fsdp_collectives(model, cfg, shape.phase, sizes, multi_pod, selector)
    coll_bytes = int(sum(v["bytes"] for v in colls.values()))
    temp = counts["act_peak"] / chips
    peak = arg_bytes["total"] + temp
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    n_active = model_api.active_param_count(cfg, model)
    roof = rf.Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name(sizes), chips=chips,
        hlo_flops=counts["flops"] / chips, hlo_bytes=counts["bytes"] / chips,
        collective_bytes=coll_bytes, model_flops=rf.model_flops(n_active, tokens, shape.phase),
        peak_bytes_per_device=peak)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(sizes), "chips": chips,
        "phase": shape.phase, "status": "ok",
        "lower_s": round(counts["lower_s"], 1), "compile_s": round(counts["compile_s"], 1),
        "n_layers": cfg.num_layers,
        "global_flops": counts["flops"], "global_bytes": counts["bytes"],
        "hlo_flops": counts["flops"] / chips, "hlo_bytes": counts["bytes"] / chips,
        "hlo_bytes_opt": counts["bytes_opt"] / chips,
        "t_memory_opt_s": round(counts["bytes_opt"] / chips / rf.HBM_BW, 6),
        "flops_per_device": "global/chips", "bytes_per_device": "global/chips",
        "collective_bytes": coll_bytes, "collectives": colls,
        "tp_collectives": "not executed",
        "memory": {"argument_size_in_bytes": float(arg_bytes["total"]),
                   "temp_size_in_bytes": temp, "arguments": arg_bytes},
        "fits": peak <= rf.HBM_BYTES,
        "trip_counts": trace.while_trip_counts(cfg, shape),
        **roof.row(),
    }


def run_one(
    arch: str,
    shape: ShapeLike,
    multi_pod: bool = False,
    layers_override: Optional[int] = None,
    cfg_transform=None,
    selector=None,
    sizes: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Run one (arch, shape, mesh) step on ``meta`` and return its record
    (the reference's keys; ``status`` ``ok``, ``skipped`` or ``error``).
    ``shape`` is a name of ``INPUT_SHAPES`` or an ``InputShape``; ``sizes``
    (default: the production mesh) the mesh's axis sizes, e.g.
    :data:`ONE_CHIP`."""
    shape = _shape(shape)
    cfg = _cfg(arch, shape, layers_override, cfg_transform)
    sizes = sizes or mesh_sizes(multi_pod)
    skipped = _skip(arch, shape, cfg, sizes)
    if skipped is not None:
        return skipped
    t0 = time.time()
    try:
        rec = _record(arch, shape, cfg, measure(cfg, shape, selector), multi_pod, sizes,
                      selector)
    except Exception as e:   # a failed row is recorded, and the sweep goes on
        rec = _error(arch, shape, sizes, e)
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def extrapolate(c1: Dict[str, float], c2: Dict[str, float], L: int) -> Dict[str, float]:
    """outer + L x per-layer from the counts at one and two layers (the
    reference's ``max(a - b, 0) + L b``)."""
    out = {}
    for k in COUNTS:
        a, b = c1[k], c2[k] - c1[k]
        out[k] = max(a - b, 0.0) + L * b
    return out


def roofline_one(
    arch: str,
    shape: ShapeLike,
    multi_pod: bool = False,
    cfg_transform=None,
    selector=None,
    full_depth: bool = False,
    sizes: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Layer-slope roofline: the step at L = 1 and L = 2 on ``meta``; total =
    outer + L x per-layer for the FLOPs, the bytes and the activation peak,
    the arguments and collectives exact at full depth.  With
    ``full_depth`` the whole depth runs too, and ``slope_check`` holds
    the extrapolated counts against the direct ones."""
    shape = _shape(shape)
    cfg = _cfg(arch, shape, None, cfg_transform)
    sizes = sizes or mesh_sizes(multi_pod)
    skipped = _skip(arch, shape, cfg, sizes)
    if skipped is not None:
        return skipped
    t0 = time.time()
    try:
        c1 = measure(_cfg(arch, shape, 1, cfg_transform), shape, selector)
        c2 = measure(_cfg(arch, shape, 2, cfg_transform), shape, selector)
        counts = extrapolate(c1, c2, cfg.num_layers)
        t1 = time.perf_counter()
        counts.update(args=step_args(cfg, shape),
                      lower_s=c1["lower_s"] + c2["lower_s"] + time.perf_counter() - t1,
                      compile_s=c1["compile_s"] + c2["compile_s"])
        rec = _record(arch, shape, cfg, counts, multi_pod, sizes, selector)
        rec.update(method="layer_slope", slope={
            k: {"outer": max(c1[k] - (c2[k] - c1[k]), 0.0), "per_layer": c2[k] - c1[k]}
            for k in COUNTS})
        if full_depth:
            direct = measure(cfg, shape, selector)
            rec["slope_check"] = {k: {"direct": direct[k], "extrapolated": counts[k]}
                                  for k in COUNTS}
    except Exception as e:   # a failed row is recorded, and the sweep goes on
        rec = _error(arch, shape, sizes, e)
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES),
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all archs x shapes")
    ap.add_argument("--out", default="launch_out/dryrun.jsonl")
    ap.add_argument("--roofline", action="store_true",
                    help="layer-slope L=1/L=2 runs in place of the full-depth run")
    ap.add_argument("--full-depth", action="store_true",
                    help="with --roofline, also run the whole depth to check the slope")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else all_arch_names()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = 0
    with open(args.out, "a") as out:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    if args.roofline:
                        rec = roofline_one(arch, shape, mp, full_depth=args.full_depth)
                    else:
                        rec = run_one(arch, shape, mp)
                    rec.pop("trace", None)
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    status = rec["status"]
                    extra = rec.get("bottleneck", rec.get("reason", rec.get("error", "")))
                    print(f"[{status:>7s}] {arch:25s} {shape:12s} "
                          f"{rec['mesh']:7s} {rec.get('wall_s', 0.0):7.1f}s {extra}", flush=True)
                    if status == "error":
                        failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
