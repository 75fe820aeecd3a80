"""The production meshes (port of :mod:`repro.launch.mesh`) over
``torch.distributed.device_mesh``.

The reference's production mesh is 16 x 16 chips a pod (``("data",
"model")``), or 2 x 16 x 16 over two pods (``("pod", "data", "model")``).
Here it is a :class:`~torch.distributed.device_mesh.DeviceMesh` of the same
shape and names, built over the current process group, which must have
exactly that many ranks.  Functions, not module constants: importing this
module touches no device and no process group.  The card is the default;
the CPU is used only when the caller passes ``device_type="cpu"``.
"""

from __future__ import annotations

import math
from typing import Tuple


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: 256 chips a pod, 512
    over two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _init_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str, what: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        have = "no process group" if world is None else f"a world of {world}"
        raise RuntimeError(f"{what} {'x'.join(map(str, shape))} {names} needs a world of "
                           f"{need} ranks; this process has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 (or 2 x 16 x 16) ``DeviceMesh``; raises, naming the world
    it needs, in a world of any other size."""
    shape, names = production_mesh_shape(multi_pod)
    return _init_mesh(shape, names, device_type, "the production mesh")


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh of ``n_data x n_model`` over the current
    world, which must have that many ranks (tests: a gloo world of one)."""
    return _init_mesh((n_data, n_model), ("data", "model"), device_type, "the debug mesh")


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
