"""Trace analysis: the op census and collective traffic of a step (the
port's counterpart of :mod:`repro.launch.hlo`).

The reference reads XLA's compiled HLO text.  Eager torch compiles no
module, so this module reads the two things that stand for it:

* a ``torch.profiler`` trace of a step on the card
  (:func:`op_census`, :func:`device_busy_us`, :func:`collective_stats`,
  :func:`total_collective_bytes`): the device kernels by name and the c10d
  collectives with their recorded shapes (``record_shapes=True``);
* the aten ops of a step run on the ``meta`` device under a
  ``TorchDispatchMode`` (:class:`StepCounter`): the bytes every op moves,
  the fusion-optimistic bytes of the ops no fusion removes
  (:func:`fusion_optimistic_bytes`) and the live bytes of the storages
  the step makes.

``while_trip_counts`` gives the trip counts of the Python loops that the
reference runs as scans (XLA annotates those).
"""

from __future__ import annotations

import re
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ArchConfig, InputShape

#: c10d op -> (kind, index of the argument that holds the result).
_C10D_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "broadcast_": ("broadcast", 0),
}

#: The profiler's dtype strings -> bytes an element.
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4, "long int": 8,
    "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "unsigned int": 4, "unsigned long": 8, "c10::complex<float>": 8,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
}


# --------------------------------------------------------------------------
# a profiler trace: device kernels and collectives
# --------------------------------------------------------------------------

def kernel_base_name(name: str) -> str:
    """A device kernel's identifier, without its namespaces, template
    arguments and parameters: ``void (anonymous
    namespace)::kau_partial_kernel<4>(float const*, ...)`` ->
    ``kau_partial_kernel``."""
    name = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


class Event:
    """One event of a trace: ``name``, ``start`` / ``end`` in microseconds,
    whether it ran on the device, and its recorded input ``shapes`` and
    ``dtypes`` (``record_shapes=True``)."""

    __slots__ = ("name", "start", "end", "on_device", "shapes", "dtypes")

    def __init__(self, name, start, end, on_device, shapes=(), dtypes=()):
        self.name, self.start, self.end, self.on_device = name, start, end, on_device
        self.shapes, self.dtypes = list(shapes), list(dtypes)


def events(prof) -> List[Event]:
    """The trace's events in start order, read from the profiler's own
    (kineto) records, the ones ``export_chrome_trace`` writes; the device's
    user annotations are left out (they are spans, not work)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), start, start + e.duration_ns() / 1e3, on_device,
                         e.shapes(), e.dtypes()))
    return sorted(out, key=lambda e: e.start)


def op_census(prof, top: Optional[int] = 15) -> Dict[str, Dict[str, float]]:
    """Device kernels (and copies) by name: ``{name: {"count",
    "device_us"}}``, the most launched first (the ``top`` of them; all with
    ``top=None``)."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "device_us": 0.0})
    for e in events(prof):
        if e.on_device:
            out[e.name]["count"] += 1
            out[e.name]["device_us"] += e.end - e.start
    ranked = sorted(out.items(), key=lambda kv: (-kv[1]["count"], -kv[1]["device_us"]))
    return dict(ranked if top is None else ranked[:top])


def device_busy_us(prof) -> float:
    """Microseconds in which at least one device event ran: the union of
    the device events' intervals."""
    busy, end = 0.0, float("-inf")
    for e in events(prof):
        if not e.on_device or e.end <= end:
            continue
        busy += e.end - max(e.start, end)
        end = e.end
    return busy


def _numel(shape: Any) -> int:
    n = 1
    for d in shape or ():
        n *= int(d)
    return n


def collective_stats(prof) -> Dict[str, Dict[str, float]]:
    """Per collective kind ``{count, bytes}`` over the trace's c10d ops.

    Bytes are the result bytes of each op, as the reference's
    ``hlo.collective_stats`` counts them: the reduced tensor of an
    all-reduce, the gathered tensor of an all-gather, the rank's shard of a
    reduce-scatter, from the op's recorded result argument.  A tensor list
    records neither shape nor dtype; such an op's bytes are then those of
    the tensor the backend's own event (``nccl:*`` / ``gloo:*``) that next
    starts records, times the default group's size for an all-gather."""
    evs = events(prof)
    backend = [e for e in evs if e.name.startswith(("nccl:", "gloo:")) and e.dtypes
               and e.dtypes[0] in _DTYPE_BYTES]
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for e in evs:
        op = e.name.split("::", 1)[1] if e.name.startswith("c10d::") else None
        if op not in _C10D_OPS:
            continue
        kind, arg = _C10D_OPS[op]
        if arg < len(e.dtypes) and e.dtypes[arg] in _DTYPE_BYTES:
            nbytes = _numel(e.shapes[arg]) * _DTYPE_BYTES[e.dtypes[arg]]
        else:
            b = next((b for b in backend if b.start >= e.start), None)
            if b is None:
                raise ValueError(f"{e.name}: the trace records no shape for its result")
            nbytes = _numel(b.shapes[0]) * _DTYPE_BYTES[b.dtypes[0]]
            if kind == "all-gather":
                import torch.distributed as dist

                nbytes *= dist.get_world_size()
        out[kind]["count"] += 1
        out[kind]["bytes"] += nbytes
    return dict(out)


def total_collective_bytes(prof) -> int:
    return int(sum(v["bytes"] for v in collective_stats(prof).values()))


# --------------------------------------------------------------------------
# the aten ops of a step on meta
# --------------------------------------------------------------------------

#: Ops a TPU pipeline cannot fuse away (the reference's ``_HEAVY_OPS``):
#: matmuls, gathers and scatters, cache updates.
HEAVY_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution", "convolution_backward",
    "embedding", "embedding_dense_backward", "index_select", "gather", "index",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "index_copy", "index_put",
    "_index_put_impl",
})

#: Ops that move no bytes: allocation and aliasing.
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided", "_unsafe_view", "alias", "lift_fresh"})


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts, over the aten ops run under it:

    * ``bytes_accessed``: each op's input and output bytes (views and
      allocations move none) -- the traffic of eager execution, where
      every op reads its inputs from memory and writes its outputs back;
    * ``heavy_bytes``: twice the result bytes of the :data:`HEAVY_OPS`
      (the reference's ``fusion_optimistic_bytes``);
    * ``live`` and ``peak``: the bytes of the storages the ops made that
      are still alive, and their largest value.  A storage is keyed by
      ``untyped_storage()._cdata`` (``meta`` tensors all have
      ``data_ptr() == 0``; two views of one storage share ``_cdata``) and
      freed when the last tensor seen on it dies.  The storages of
      ``exclude`` (the step's arguments) are never counted.
    """

    def __init__(self, exclude: Iterable[Any] = ()):
        super().__init__()
        self.bytes_accessed = 0
        self.heavy_bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        self._excluded = {t.untyped_storage()._cdata for t in _tensors(list(exclude))}

    def _drop(self, cd: int) -> None:
        self._refs[cd] -= 1
        if self._refs[cd] == 0:
            del self._refs[cd]
            self.live -= self._size.pop(cd)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        outs = _tensors(out)
        if not (func.is_view or name in _NO_TRAFFIC):
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs)))) + \
                sum(map(_nbytes, outs))
        if name in HEAVY_OPS:
            self.heavy_bytes += 2 * sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            cd = st._cdata
            if cd in self._excluded:
                continue
            if cd not in self._refs:
                self._refs[cd] = 0
                self._size[cd] = st.nbytes()
                self.live += self._size[cd]
                self.peak = max(self.peak, self.live)
            self._refs[cd] += 1
            weakref.finalize(t, self._drop, cd)
        return out


def fusion_optimistic_bytes(fn: Callable, *args, **kwargs) -> int:
    """Fusion-optimistic HBM-traffic lower bound of ``fn(*args, **kwargs)``:
    twice the result bytes of the ops no fusion removes (matmuls, gathers
    and scatters, cache updates), ignoring elementwise chains -- the
    reference's definition, over the aten ops the call runs."""
    with StepCounter() as counter:
        fn(*args, **kwargs)
    return counter.heavy_bytes


def while_trip_counts(cfg: ArchConfig, shape: InputShape) -> Dict[str, int]:
    """Trip counts of the Python loops the reference runs as scans, for one
    step of ``cfg`` at ``shape``: the layers, the encoder's layers, the
    attention query chunks and the SSM chunks of one layer (each loop
    splits ``S`` positions into ``max(S // chunk, 1)`` chunks; a decode
    step's one token is one chunk)."""
    S = 1 if shape.is_decode else shape.seq_len
    out = {"layers": cfg.num_layers}
    if cfg.kind == "encdec":
        out["enc_layers"] = cfg.enc_layers
        if not shape.is_decode:
            out["enc_attn_chunks"] = max(cfg.num_prefix // cfg.attn_chunk, 1)
    if cfg.mixer in ("attention", "hymba"):
        out["attn_chunks"] = 1 if shape.is_decode else max(S // cfg.attn_chunk, 1)
    if cfg.mixer == "rwkv6":
        out["ssm_chunks"] = 1 if shape.is_decode else max(S // cfg.ssm_chunk, 1)
    if cfg.mixer == "hymba":
        out["ssm_chunks"] = 1 if shape.is_decode else max(S // max(cfg.ssm_chunk, 4), 1)
    return out
