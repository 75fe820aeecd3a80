"""CoresetSpec -> ExecutionPlan for the ported engines (the part of
:mod:`repro.core.plan` the materialized, batched and streaming engines
need).

A :class:`CoresetSpec` validates the fields the port reads; the names
and values match the reference's, so a spec carries over.
:func:`compile_plan` resolves it against a dataset: one budget and one
seed run on the materialized engine, a (seeds x budgets) grid on the
batched one, a forced ``streamed`` engine runs block at a time
(``chunk_blocks`` 1, no prefetch) and ``pipelined`` over superchunks of
``chunk_blocks`` blocks (clamped to the block count), prefetched or not;
``pipelined`` at ``chunk_blocks=1`` without prefetch is lowered to
``streamed``, which draws the same coreset.  ``jit=True`` selects the
materialized engine's fused path (one CUDA graph per shape on the card);
the batched engine accepts it and runs as without it.
``sharded_masses`` computes the streaming engines' block-mass table over
the ranks of a ``torch.distributed`` process group
(:func:`repro_torch.core.streaming.vrlr_block_masses_sharded`).
``fault_policy`` and ``codec`` set how a build delivered through a
:class:`~repro_torch.core.faults.Transport` reacts to faults and what its
round-1 table crosses the wire as.  ``engine="auto"`` picks the
materialized engine: the memory model, ``codec="auto"``,
``comm_budget_bits`` and the plan cache wait for ROADMAP.md queue 1,
item 15.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.comm import CommSchedule
from repro_torch.core.faults import FAULT_POLICIES
from repro_torch.core.vfl import VFLDataset, block_geometry
from repro_torch.core.wire import CODEC_LADDER
from repro_torch.device import DeviceLike, resolve_device

#: Score backends, named as in the reference so specs carry over: in the
#: port ``"pallas"`` means the hand-written CUDA kernels.
SCORE_BACKENDS = ("pallas", "ref", "norm")

ENGINES = ("materialized", "batched", "streamed", "pipelined")

# superchunk width when chunk_blocks is not given (the reference's)
DEFAULT_CHUNK_BLOCKS = 8

#: Prefetch default per device type when ``prefetch`` is not given.  The
#: CPU value is the reference's measured winner (the staging thread competes
#: with the compute it overlaps).  The CUDA value is the winner of
#: ``chip_smoke.py``'s prefetch ablation on an NVIDIA H100 80GB HBM3 at a
#: 700 W power limit: a ``vrlr`` build at m = 1000 from host memory, blocks
#: of 4,096 rows in 15 superchunks of 8, took a median 0.7460-0.8732 s
#: with prefetch and 0.8593-1.0440 s without (three calls of three runs
#: each way).
PREFETCH_DEFAULT = {"cpu": False, "cuda": True}


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class CoresetSpec:
    """Frozen declarative description of one coreset construction.

    ``budgets`` accepts a single int or an iterable of ints; a grid
    (``num_seeds > 1`` or several budgets) compiles to the batched engine,
    whose draw capacity ``m_cap`` defaults to ``max(budgets)``.
    ``params`` carries task-specific score knobs verbatim.  All validation
    happens here, at construction.
    """

    task: Union[str, Any] = "vrlr"
    budgets: Union[int, Tuple[int, ...]] = (512,)
    num_seeds: int = 1
    engine: str = "auto"
    backend: str = "auto"
    jit: bool = False                     # materialized fast path: one fused dispatch
    block_size: int = 65536
    chunk_blocks: Optional[int] = None    # None -> DEFAULT_CHUNK_BLOCKS (planner)
    prefetch: Optional[bool] = None       # None -> PREFETCH_DEFAULT (planner)
    sharded_masses: bool = False          # block-mass table over the process group
    m_cap: Optional[int] = None           # batched draw capacity override
    fault_policy: str = "fail"            # fail | retry | degrade | quarantine
    codec: str = "raw_fp32"               # the round-1 table's wire codec (CODEC_LADDER)
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not (isinstance(self.task, str) or hasattr(self.task, "score_fn")):
            raise ValueError(
                f"task must be a registry name or CoresetTask, got {self.task!r}"
            )
        budgets = self.budgets
        budgets = (budgets,) if _is_int(budgets) else tuple(budgets)
        if not budgets:
            raise ValueError("budgets must be a non-empty tuple of positive ints")
        bad = [b for b in budgets if not _is_int(b) or b < 1]
        if bad:
            raise ValueError(
                f"budgets must be positive ints, got {bad} in {budgets}"
            )
        object.__setattr__(self, "budgets", tuple(int(b) for b in budgets))
        if not _is_int(self.num_seeds) or self.num_seeds < 1:
            raise ValueError(
                f"num_seeds must be a positive int, got {self.num_seeds!r}"
            )
        if self.engine not in ("auto",) + ENGINES:
            raise ValueError(
                f"engine must be 'auto' or one of {ENGINES}, got {self.engine!r}"
            )
        if self.backend not in ("auto",) + SCORE_BACKENDS:
            raise ValueError(
                f"backend must be 'auto' or one of {SCORE_BACKENDS}, "
                f"got {self.backend!r}"
            )
        if not isinstance(self.jit, bool):
            raise ValueError(f"jit must be a bool, got {self.jit!r}")
        if self.jit and self.engine not in ("auto", "materialized", "batched"):
            raise ValueError(
                f"jit=True is the materialized/batched fused path; it cannot "
                f"combine with engine={self.engine!r}"
            )
        if not _is_int(self.block_size) or self.block_size < 1:
            raise ValueError(
                f"block_size must be a positive int, got {self.block_size!r}"
            )
        if self.chunk_blocks is not None and (
                not _is_int(self.chunk_blocks) or self.chunk_blocks < 1):
            raise ValueError(
                f"chunk_blocks must be a positive int, got {self.chunk_blocks!r}"
            )
        if self.prefetch is not None and not isinstance(self.prefetch, bool):
            raise ValueError(f"prefetch must be a bool, got {self.prefetch!r}")
        if not isinstance(self.sharded_masses, bool):
            raise ValueError(
                f"sharded_masses must be a bool, got {self.sharded_masses!r}"
            )
        if self.sharded_masses and self.engine in ("materialized", "batched"):
            raise ValueError(
                f"sharded_masses computes the streaming block-mass table; it "
                f"cannot combine with engine={self.engine!r}"
            )
        if self.m_cap is not None:
            if not _is_int(self.m_cap) or self.m_cap < 1:
                raise ValueError(
                    f"m_cap must be a positive int, got {self.m_cap!r}"
                )
            over = [b for b in budgets if b > self.m_cap]
            if over:
                raise ValueError(
                    f"budgets {over} outside [1, m_cap={self.m_cap}]; every "
                    f"budget must be >= 1 and <= the draw capacity"
                )
        if self.fault_policy not in FAULT_POLICIES:
            raise ValueError(
                f"fault_policy must be one of {FAULT_POLICIES}, "
                f"got {self.fault_policy!r}"
            )
        if self.fault_policy != "fail" and self.engine == "batched":
            raise ValueError(
                f"fault_policy={self.fault_policy!r} delivers per-round "
                f"schedules through a transport; the batched engine bills "
                f"its cells lazily and cannot combine with it"
            )
        if self.codec == "auto":
            raise ValueError(
                "codec='auto' picks the codec from the planner's comm-budget "
                "walk, which the port does not have yet (ROADMAP.md queue 1, "
                f"item 15); name one of {CODEC_LADDER}"
            )
        if self.codec not in CODEC_LADDER:
            raise ValueError(
                f"codec must be one of {CODEC_LADDER}, got {self.codec!r}"
            )
        lossy = self.codec != "raw_fp32"
        if lossy and self.jit:
            raise ValueError(
                f"codec={self.codec!r} quantizes the wire; the jit fused "
                f"path never leaves the device and cannot combine with it"
            )
        if lossy and self.engine == "batched":
            raise ValueError(
                f"codec={self.codec!r} quantizes per-round payloads; the "
                f"batched engine bills its cells lazily and cannot combine "
                f"with it"
            )
        object.__setattr__(self, "params", dict(self.params))

    @property
    def is_grid(self) -> bool:
        return self.num_seeds > 1 or len(self.budgets) > 1

    @property
    def budget(self) -> int:
        """The single budget of a non-grid spec."""
        if self.is_grid:
            raise ValueError(
                f"spec is a {self.num_seeds}x{len(self.budgets)} grid; "
                f"use .budgets"
            )
        return self.budgets[0]

    def replace(self, **kw) -> "CoresetSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compiled execution of a :class:`CoresetSpec` on one dataset:
    one concrete engine, the device the build computes on and the backend
    resolved from it, the (num_seeds, num_budgets) grid with its draw capacity,
    the streaming knobs (``chunk_blocks`` clamped to the block count),
    the exact predicted bill of every cell together (Algorithm 1's total
    does not depend on the realised round-2 counts), and ``notes``, the
    planner's decisions (lowerings, clamps)."""

    spec: CoresetSpec
    engine: str
    backend: str
    task_name: str
    n: int
    T: int
    dims: Tuple[int, ...]
    grid: Tuple[int, int]          # (num_seeds, num_budgets)
    m_cap: int
    predicted_comm_units: int
    device: torch.device           # where the build computes
    block_size: int = 65536
    chunk_blocks: int = 1
    prefetch: bool = False
    notes: Tuple[str, ...] = ()

    @property
    def is_grid(self) -> bool:
        return self.grid[0] > 1 or self.grid[1] > 1

    def describe(self) -> str:
        """Human-readable plan: engine, task, backend, grid, budgets, draw
        capacity, fault policy, the data's geometry, the integrity seam and
        the predicted bill."""
        spec = self.spec
        nb, bs = block_geometry(self.n, self.block_size)
        lines = [
            f"ExecutionPlan: engine={self.engine}"
            + (" (jit)" if spec.jit and self.engine == "materialized" else "")
            + (" +sharded_masses" if spec.sharded_masses else ""),
            f"  task={self.task_name} backend={self.backend} "
            f"grid={self.grid[0]}x{self.grid[1]} budgets={spec.budgets} "
            f"m_cap={self.m_cap} fault_policy={spec.fault_policy}",
            f"  data: n={self.n} T={self.T} dims={self.dims} "
            f"blocks: {nb} x {bs} rows (block_size={self.block_size})",
        ]
        if self.engine in ("streamed", "pipelined"):
            lines.append(
                f"  streaming knobs: chunk_blocks={self.chunk_blocks} "
                f"prefetch={'on' if self.prefetch else 'off'}"
            )
        validators = ("on" if spec.fault_policy in ("fail", "quarantine")
                      else "off")
        lines.append(
            f"  integrity: wire envelopes on transported rounds 1-2; "
            f"value validators {validators} "
            f"(policy={spec.fault_policy})"
        )
        lines.append(f"  predicted comm: {self.predicted_comm_units} units "
                     f"(codec={spec.codec})")
        for note in self.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)


def compile_plan(spec: CoresetSpec, ds: VFLDataset,
                 device: Optional[DeviceLike] = None) -> ExecutionPlan:
    """Compile ``spec`` against ``ds`` — pure planning, no scoring work.
    ``device`` is where the build computes (default: where ``ds`` lives);
    ``backend="auto"`` and the prefetch default resolve from it."""
    from repro_torch.core.api import get_task, resolve_backend

    dev = ds.device if device is None else resolve_device(device)
    task = get_task(spec.task)
    backend = resolve_backend(spec.backend, dev)
    if task.needs_labels and ds.y is None:
        raise ValueError(f"{task.name} requires labels at party T")
    R, M = spec.num_seeds, len(spec.budgets)
    nb, bs = block_geometry(ds.n, spec.block_size)
    notes = []
    chunk_req = (DEFAULT_CHUNK_BLOCKS if spec.chunk_blocks is None
                 else int(spec.chunk_blocks))
    chunk = min(chunk_req, nb)
    prefetch = (PREFETCH_DEFAULT.get(dev.type, True) if spec.prefetch is None
                else spec.prefetch)
    if spec.is_grid:
        if spec.engine not in ("auto", "batched"):
            raise ValueError(
                f"engine={spec.engine!r} builds one coreset per call; a "
                f"{R}x{M} grid requires engine='batched' (or 'auto')"
            )
        engine = "batched"
    else:
        engine = "materialized" if spec.engine == "auto" else spec.engine
    # the streamed engine IS the pipelined engine at C=1 without prefetch —
    # normalize both directions so dispatch is unambiguous
    lowered_from_pipelined = False
    if engine == "streamed":
        chunk, prefetch = 1, False
    elif engine == "pipelined" and chunk == 1 and not prefetch:
        engine = "streamed"
        lowered_from_pipelined = True
        notes.append(
            "pipelined at chunk_blocks=1 without prefetch IS the "
            "block-at-a-time engine -> lowered to streamed"
        )
    if chunk_req > nb and (engine == "pipelined" or lowered_from_pipelined):
        notes.append(
            f"chunk_blocks clamped {chunk_req} -> {nb}: n={ds.n} at "
            f"block_size={spec.block_size} has only {nb} blocks "
            f"(one full-span superchunk)"
        )
    if spec.sharded_masses:
        _check_sharded(engine, backend, task.name, ds.n, bs)
    m_cap = max(spec.budgets) if spec.m_cap is None else spec.m_cap
    comm = R * sum(CommSchedule.uniform(ds.T, m).total if task.score_fn is None
                   else CommSchedule.dis_total(ds.T, m) for m in spec.budgets)
    return ExecutionPlan(spec=spec, engine=engine, backend=backend,
                         task_name=task.name, n=ds.n, T=ds.T, dims=ds.dims,
                         grid=(R, M), m_cap=m_cap, predicted_comm_units=comm,
                         device=dev,
                         block_size=spec.block_size, chunk_blocks=chunk,
                         prefetch=prefetch, notes=tuple(notes))


def _shard_world_size() -> int:
    """D of the sharded mass table: the world size of the default
    ``torch.distributed`` process group when one is initialised, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _check_sharded(engine: str, backend: str, task_name: str, n: int,
                   bs: int) -> None:
    """The planner's checks on ``sharded_masses`` (the spec has already
    refused a forced materialized or batched engine)."""
    if engine not in ("streamed", "pipelined"):
        raise ValueError(
            f"sharded_masses computes the streaming block-mass table, "
            f"but the planner selected engine {engine!r} — force a "
            f"streaming engine or drop the toggle"
        )
    if backend == "norm":
        raise ValueError(
            "sharded_masses computes the task's real score masses; it "
            "cannot combine with backend='norm'"
        )
    if task_name not in ("vrlr", "vkmc"):
        raise ValueError(
            f"sharded_masses supports tasks ('vrlr', 'vkmc'), got "
            f"{task_name!r}"
        )
    D = _shard_world_size()
    if n % D != 0 or (n // D) % bs != 0:
        # the shard-grid requirement _check_shard_grid enforces at run
        # time, surfaced at plan time so a bad spec fails before work
        raise ValueError(
            f"sharded_masses needs n divisible by the device count and "
            f"the per-device shard divisible by the block size: n={n}, "
            f"devices={D}, bs={bs}"
        )
