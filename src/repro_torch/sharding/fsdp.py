"""FSDP over ``torch.distributed``: the reference's ``data`` axis held by
``torch.distributed.fsdp.fully_shard``.

The reference shards each weight's largest divisible dim over ``data``
(``specs._add_fsdp`` under ``cfg.fsdp``) and lets GSPMD gather the weights
layer by layer inside its scan.  Here each layer module (``enc_layers``,
``layers``) is one ``fully_shard`` unit and the root holds the rest
(embeddings, positions, final norms, head); ``shard_placement_fn`` gives
each parameter ``Shard(i)`` on the dim its spec puts ``data`` on.  The
model calls each layer module and computes its loss inside the root's
call, so FSDP gathers a unit's weights as plain tensors just before it
runs, frees them after, and reduce-scatters the gradients to the owning
rank.  A parameter whose spec leaves ``data`` out (a dim it does not
divide) is held as ``Shard(0)``: FSDP shards every parameter of a unit,
padding an uneven dim, and gathers it to the same tensor.

The mesh must name a ``data`` dim; only that dim is sharded over (a
``model`` axis is assigned by the rules and placed by
:func:`~repro_torch.sharding.specs.placements`, but tensor parallelism is
not run here; a ``pod`` dim must have size 1).  The train step then
updates each rank's own shards (``optim.adamw``) after one all-reduce of
the gradients' squared norm.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.specs import Spec, mesh_sizes, module_specs


def data_dim(spec: Spec) -> int:
    """The tensor dim ``spec`` shards over ``data`` (alone or in a tuple);
    0 when it has none."""
    for i, ax in enumerate(spec):
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            return i
    return 0


def fully_shard_model(model: Any, cfg: ArchConfig, mesh: Any, multi_pod: bool = False) -> Any:
    """Shard ``model`` (a :class:`~repro_torch.models.lm.DecoderLM` or
    :class:`~repro_torch.models.encdec.EncDecLM`) over ``mesh``'s ``data``
    dim per the reference's rules at ``mesh``'s sizes: one ``fully_shard``
    per layer module, then the root.  Returns the model, sharded in place;
    its parameters are DTensors from then on."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names or ()
    if "data" not in names:
        raise ValueError(f"fully_shard_model needs a mesh with a 'data' dim, got {names}")
    sizes = mesh_sizes(mesh)
    if sizes["pod"] != 1:
        raise ValueError(f"fully_shard_model shards over 'data' only; the mesh has "
                         f"{sizes['pod']} pods")
    specs = module_specs(model, cfg, multi_pod, sizes)
    dim_of = {p: data_dim(specs[name]) for name, p in model.named_parameters()}
    dp_mesh = mesh["data"] if len(names) > 1 else mesh

    def place(p):
        return Shard(dim_of[p])

    for stack in ("enc_layers", "layers"):
        for layer in getattr(model, stack, ()):
            fully_shard(layer, mesh=dp_mesh, shard_placement_fn=place)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=place)
    return model
