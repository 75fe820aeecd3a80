"""Partition rules for parameters, optimizer state, batches and serve caches
(port of :mod:`repro.sharding.specs`), and their placement on a
``torch.distributed`` device mesh.

Policy (Megatron-style TP over `model` + DP over ('pod','data'), optional
FSDP over `data` for the >=14B archs):
  * attention/FFN projections: contracting d_model dim replicated, the
    head/ffn output dim sharded over `model`; the out-projection shards its
    input dim (so the pair produces one all-reduce per block);
  * MoE expert tensors: expert axis over `model` (expert parallelism) when E
    divides the axis, else the per-expert ffn dim (granite's E=40 vs 16);
  * embeddings/unembedding: padded vocab (ArchConfig.vocab_pad) over `model`;
  * FSDP (cfg.fsdp): `data` is added to the largest still-unsharded divisible
    dim of each weight (ZeRO-3-ish; :func:`repro_torch.sharding.fsdp.fully_shard_model`
    holds it so and gathers the weights layer by layer);
  * KV caches: batch over dp axes, head_dim over `model`; the batch=1
    long-context shape shards the cache SEQUENCE over `data` instead.

Every spec passes a divisibility sanitizer: any axis that does not divide
its dim is dropped to replication.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (one dim sharded over several mesh
axes, major first); a tuple of one name is written as the name
(:func:`canonical`), as ``jax.sharding.PartitionSpec`` writes it.  The rules are pure functions of (path, shape, config,
sizes) over the reference's trees: nested dicts keyed like the reference's
pytrees, the layers STACKED on a leading L axis under ``layers`` and
``enc_layers`` (:func:`stacked_shapes` builds one from a port model), with
paths joined by ``/`` (``layers/attn/wq``).  A per-layer tensor of the
port's ``ModuleList`` takes its stacked spec without dim 0
(:func:`layer_spec`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig, InputShape

MESH_SIZES = {"pod": 2, "data": 16, "model": 16}

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

STACKS = ("layers", "enc_layers")


def _axis_size(ax: Axis, sizes: Dict[str, int]) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def canonical(spec: Spec) -> Spec:
    """``spec`` with each one-name tuple entry written as the name."""
    return tuple(ax[0] if isinstance(ax, (tuple, list)) and len(ax) == 1 else
                 (tuple(ax) if isinstance(ax, list) else ax) for ax in spec)


def sanitize(spec: Spec, shape: Sequence[int], sizes: Dict[str, int] = MESH_SIZES) -> Spec:
    """Drop any spec axis whose size does not divide the dim."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return canonical(tuple(ax if (ax is not None and dim % _axis_size(ax, sizes) == 0) else None
                           for dim, ax in zip(shape, axes)))


def _add_fsdp(spec: Spec, shape: Sequence[int], sizes: Dict[str, int],
              multi_pod: bool = False) -> Spec:
    """Add the dp axes to the largest unsharded divisible dim (ZeRO-3-ish)."""
    candidates = (("pod", "data"), ("data",)) if multi_pod else (("data",),)
    axes = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for cand in candidates:
        n = _axis_size(cand, sizes)
        for i in order:
            if axes[i] is None and shape[i] % n == 0 and shape[i] >= n:
                axes[i] = cand if len(cand) > 1 else cand[0]
                return tuple(axes)
    return tuple(axes)


def _add_axis(spec: Spec, shape: Sequence[int], sizes: Dict[str, int], axis: str) -> Spec:
    """Add one named axis to the largest unsharded divisible dim."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if axes[i] is None and shape[i] % sizes[axis] == 0 and shape[i] >= sizes[axis]:
            axes[i] = axis
            return tuple(axes)
    return tuple(axes)


def _param_rule(path: str, shape: Sequence[int], cfg: ArchConfig, tp: str) -> Spec:
    """Base (pre-sanitize, pre-FSDP) spec for one parameter leaf."""
    stacked = path.startswith(STACKS)
    lead: Spec = (None,) if stacked else ()
    body = len(shape) - len(lead)
    name = path.split("/")[-1]

    def spec(*axes) -> Spec:
        return (*lead, *axes)

    # embeddings / head / positions ---------------------------------------
    if name == "embed":
        return (tp, None)
    if name == "head":
        return (None, tp)
    if name in ("pos_embed", "enc_pos_embed"):
        return (None, None)
    # MoE ------------------------------------------------------------------
    if "moe" in path and name in ("w_gate", "w_up", "w_down"):
        E = shape[len(lead)]
        if E % MESH_SIZES["model"] == 0:
            return spec(tp, None, None)        # expert parallelism
        # fallback: shard the per-expert ffn dim
        if name == "w_down":
            return spec(None, tp, None)        # (E, f, d)
        return spec(None, None, tp)            # (E, d, f)
    if name == "router":
        return spec(None, None)                # E often non-divisible; tiny
    # attention ------------------------------------------------------------
    if name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_in"):
        return spec(None, tp)
    if name in ("wo", "w_out"):
        return spec(tp, None)
    if name in ("w_dq", "w_dkv", "w_kpe"):
        return spec(None, None)                # small latent projections
    if name == "bonus_u":
        return spec(None, None)                # (H, hd): H rarely divides
    # rwkv -----------------------------------------------------------------
    if name in ("w_r", "w_k", "w_v", "w_g"):
        return spec(None, tp)
    if name == "w_o":
        return spec(tp, None)
    if name == "decay_lora_a":
        return spec(None, None)
    if name == "decay_lora_b":
        return spec(None, tp)
    # mamba ----------------------------------------------------------------
    if name in ("w_bcdt", "A_log"):
        return spec(tp, None)                  # (di, ...)
    if name == "D":
        return spec(tp)
    if name == "ln_out" and "mamba" in path:
        return spec(tp)                        # over di
    # dense mlp ------------------------------------------------------------
    if name in ("w_gate", "w_up"):
        return spec(None, tp)                  # (D, F)
    if name == "w_down":
        return spec(tp, None)                  # (F, D)
    # norms / vectors --------------------------------------------------------
    return spec(*([None] * body))


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    return tuple(int(s) for s in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _map_with_path(fn: Callable[[str, Tuple[int, ...]], Spec], tree: Any,
                   prefix: str = "") -> Any:
    """``fn(path, shape)`` over the leaves of a nested dict (a leaf is a
    shape tuple or anything with ``.shape``), the dict's structure kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, _shape_of(tree))


def flat_specs(specs: Any, prefix: str = "") -> Dict[str, Spec]:
    """A spec tree as ``{path: spec}``, paths joined by ``/``."""
    if isinstance(specs, dict):
        out: Dict[str, Spec] = {}
        for k, v in specs.items():
            out.update(flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: specs}


def param_shardings(params_shape: Any, cfg: ArchConfig, multi_pod: bool,
                    sizes: Dict[str, int] = MESH_SIZES) -> Any:
    """Tree of specs matching a params(-shaped) tree."""
    tp = "model"

    def rule(pstr: str, shape: Tuple[int, ...]) -> Spec:
        spec = _param_rule(pstr, shape, cfg, tp)
        spec = sanitize(spec, shape, sizes)
        if getattr(cfg, "pure_fsdp", False) and pstr.startswith(STACKS):
            # weight-gathered parallelism: strip TP from layer weights and
            # all-gather the (small) weights per layer instead
            spec = tuple(None if a == tp else a for a in spec)
            spec = _add_fsdp(spec, shape, sizes, multi_pod)
            # also spread over the model axis for memory when possible
            spec = _add_axis(spec, shape, sizes, "model")
        elif cfg.fsdp:
            spec = _add_fsdp(spec, shape, sizes, multi_pod)
        return spec

    return _map_with_path(rule, params_shape)


def opt_shardings(params_specs: Any) -> Any:
    """Adam m/v follow the parameter shardings."""
    return params_specs


def batch_shardings(cfg: ArchConfig, shape: InputShape, multi_pod: bool) -> Dict[str, Spec]:
    dp = ("pod", "data") if multi_pod else ("data",)
    if shape.global_batch == 1 or (shape.global_batch % (32 if multi_pod else 16)) != 0:
        # batch must divide the dp axes; fall back to 'data' only, else replicate
        dp = ("data",) if shape.global_batch % 16 == 0 else ()
    tok = canonical((dp if dp else None,))
    if shape.is_decode:
        return {"tokens": tok}
    out = {"tokens": tok, "labels": tok}
    if cfg.frontend != "none" or cfg.kind == "encdec":
        out["prefix_embeds"] = canonical((dp if dp else None, None, None))
    return out


def cache_shardings(cache_shape: Any, cfg: ArchConfig, shape: InputShape,
                    multi_pod: bool) -> Any:
    """Specs for the serve cache tree (``models.api.init_cache``'s layout)."""
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    if shape.global_batch % (32 if multi_pod else 16) != 0:
        dp = ("data",) if shape.global_batch % 16 == 0 else ()
    seq_parallel = shape.global_batch == 1
    b_ax = None if (seq_parallel or not dp) else dp
    s_ax = "data" if seq_parallel else None
    tp = "model"

    def rule(name: str, shp: Tuple[int, ...]) -> Spec:
        nd = len(shp)
        if name.endswith("kpos"):
            return sanitize((s_ax,), shp)
        if name.endswith("pos"):
            return ()
        if name.endswith("/k") or name.endswith("/v") or "cross_" in name:
            # (L, B, Sc, KV, hd): head_dim over model (KV counts rarely divide)
            return sanitize((None, b_ax, s_ax, None, tp), shp)
        if name.endswith("c_kv"):                            # (L, B, Sc, r_kv)
            return sanitize((None, b_ax, s_ax, tp), shp)
        if name.endswith("k_pe"):                            # (L, B, Sc, dr)
            return sanitize((None, b_ax, s_ax, None), shp)
        if name.endswith("wkv"):                             # (L, B, H, hd, hd)
            return sanitize((None, b_ax, None, tp, None), shp)
        if name.endswith("shift"):                           # (L, B, D)
            return sanitize((None, b_ax, tp), shp)
        if name.endswith("mamba_h"):                         # (L, B, di, N)
            return sanitize((None, b_ax, tp, None), shp)
        if name.endswith("enc_out"):                         # (B, P, D)
            return sanitize((b_ax, None, None), shp)
        if nd >= 2:
            return sanitize((None, b_ax, *([None] * (nd - 2))), shp)
        return (None,) * nd

    return _map_with_path(rule, cache_shape)


# --------------------------------------------------------------------------
# the port's side: its modules' shapes, per-layer specs, mesh placements
# --------------------------------------------------------------------------

def ref_path(name: str) -> Tuple[str, Optional[int]]:
    """(the reference's path, the layer index) of a port parameter name:
    ``layers.3.attn.wq`` -> (``layers/attn/wq``, 3); ``embed`` -> (``embed``,
    None)."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def port_name(path: str, layer: Optional[int]) -> str:
    """The inverse of :func:`ref_path`: (``layers/attn/wq``, 3) ->
    ``layers.3.attn.wq``."""
    parts = path.split("/")
    if layer is None:
        return ".".join(parts)
    return ".".join([parts[0], str(layer)] + parts[1:])


def stacked_tree(named, stack: Callable[[list], Any]) -> Dict[str, Any]:
    """The reference's tree of (port name, value) pairs given in layer
    order: nested dicts keyed by :func:`ref_path`, the layers' values of a
    ``layers`` / ``enc_layers`` leaf combined by ``stack``."""
    tree: Dict[str, Any] = {}
    layers: Dict[str, list] = {}

    def put(path: str, value: Any) -> None:
        node = tree
        *keys, leaf = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = value

    for name, value in named:
        path, layer = ref_path(name)
        if layer is None:
            put(path, value)
        else:
            layers.setdefault(path, []).append(value)
    for path, values in layers.items():
        put(path, stack(values))
    return tree


def stacked_shapes(model: Any) -> Dict[str, Any]:
    """The reference's tree of shapes for a port model (a ``meta`` one will
    do) or a dict of tensors keyed by its parameter names (AdamW's
    moments): each ``layers`` / ``enc_layers`` leaf stacked on a leading L
    axis."""
    named = model.items() if isinstance(model, dict) else model.named_parameters()
    return stacked_tree(((name, tuple(p.shape)) for name, p in named),
                        lambda shapes: (len(shapes), *shapes[0]))


def layer_spec(path: str, spec: Spec) -> Spec:
    """The spec of one layer's tensor of a stacked leaf: ``spec`` without
    dim 0.  Raises naming the leaf when the rule put an axis on dim 0 (the
    layer axis), which a per-layer tensor cannot hold; ``path`` not under
    ``layers`` / ``enc_layers`` is returned whole."""
    if not path.startswith(STACKS):
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"{path}: the rule shards the stacked layer axis (dim 0) over "
                         f"{spec[0]!r}; a per-layer tensor cannot hold that axis")
    return tuple(spec[1:])


def module_specs(model: Any, cfg: ArchConfig, multi_pod: bool = False,
                 sizes: Dict[str, int] = MESH_SIZES) -> Dict[str, Spec]:
    """``{port parameter name: spec of that tensor}``: the reference's rule
    on the stacked shapes, each layer's tensor given :func:`layer_spec`."""
    flat = flat_specs(param_shardings(stacked_shapes(model), cfg, multi_pod, sizes))
    out: Dict[str, Spec] = {}
    for name, _ in model.named_parameters():
        path, _layer = ref_path(name)
        out[name] = layer_spec(path, flat[path])
    return out


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh`` with named dims:
    for each mesh dim, ``Shard(i)`` where tensor dim i's entry names it
    (alone or in a tuple, which shards one dim over several mesh dims in
    the tuple's order), else ``Replicate()``.  An axis the mesh does not
    have counts as size 1."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("placements needs a mesh with named dims")
    where: Dict[str, int] = {}
    for i, ax in enumerate(spec):
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            if a is not None:
                where[a] = i
    return tuple(Shard(where[n]) if n in where else Replicate() for n in names)


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """``MESH_SIZES``' axes sized by ``mesh`` (an axis it lacks is 1)."""
    names = mesh.mesh_dim_names or ()
    return {a: (mesh.size(names.index(a)) if a in names else 1) for a in MESH_SIZES}
