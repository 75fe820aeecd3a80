"""CoresetSpec -> ExecutionPlan for the ported engines (the part of
:mod:`repro.core.plan` the materialized and batched engines need).

A :class:`CoresetSpec` validates the fields the port reads; the names
and values match the reference's, so a spec carries over.
:func:`compile_plan` resolves it against a dataset: one budget and one
seed run on the materialized engine, a (seeds x budgets) grid on the
batched one, and the streamed and pipelined engines raise
``NotImplementedError`` naming the ROADMAP item that ports them.
``jit=True`` selects the materialized engine's fused path (one CUDA graph
per shape on the card); the batched engine accepts it and runs as
without it.  The memory model, codec axis, fault policies and plan cache
wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.comm import CommSchedule
from repro_torch.core.vfl import VFLDataset

#: Score backends, named as in the reference so specs carry over: in the
#: port ``"pallas"`` means the hand-written CUDA kernels.
SCORE_BACKENDS = ("pallas", "ref", "norm")

ENGINES = ("materialized", "batched", "streamed", "pipelined")

#: Where each engine the port lacks is scheduled (ROADMAP.md, queue 1).
_NOT_PORTED = {
    "streamed": "queue 1, item 12 (streamed and pipelined engines)",
    "pipelined": "queue 1, item 12 (streamed and pipelined engines)",
}


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
    m_cap: Optional[int] = None           # batched draw capacity override
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
    one concrete engine, the backend resolved from the dataset's device,
    the (num_seeds, num_budgets) grid with its draw capacity, and the
    exact predicted bill of every cell together (Algorithm 1's total does
    not depend on the realised round-2 counts)."""

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

    @property
    def is_grid(self) -> bool:
        return self.grid[0] > 1 or self.grid[1] > 1

    def describe(self) -> str:
        """Human-readable plan: engine, task, backend, grid, budgets, draw
        capacity, the data's geometry and the predicted bill."""
        spec = self.spec
        return "\n".join([
            f"ExecutionPlan: engine={self.engine}"
            + (" (jit)" if spec.jit and self.engine == "materialized" else ""),
            f"  task={self.task_name} backend={self.backend} "
            f"grid={self.grid[0]}x{self.grid[1]} budgets={spec.budgets} "
            f"m_cap={self.m_cap}",
            f"  data: n={self.n} T={self.T} dims={self.dims}",
            f"  predicted comm: {self.predicted_comm_units} units",
        ])


def compile_plan(spec: CoresetSpec, ds: VFLDataset) -> ExecutionPlan:
    """Compile ``spec`` against ``ds`` — pure planning, no scoring work."""
    from repro_torch.core.api import get_task, resolve_backend

    task = get_task(spec.task)
    backend = resolve_backend(spec.backend, ds.device)
    if task.needs_labels and ds.y is None:
        raise ValueError(f"{task.name} requires labels at party T")
    R, M = spec.num_seeds, len(spec.budgets)
    if spec.is_grid:
        if spec.engine not in ("auto", "batched"):
            raise ValueError(
                f"engine={spec.engine!r} builds one coreset per call; a "
                f"{R}x{M} grid requires engine='batched' (or 'auto')"
            )
        engine = "batched"
    else:
        engine = "materialized" if spec.engine == "auto" else spec.engine
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"the {engine} engine is not ported to PyTorch yet (ROADMAP.md "
            f"{_NOT_PORTED[engine]}); use engine='materialized' or "
            f"'batched'"
        )
    m_cap = max(spec.budgets) if spec.m_cap is None else spec.m_cap
    comm = R * sum(CommSchedule.uniform(ds.T, m).total if task.score_fn is None
                   else CommSchedule.dis_total(ds.T, m) for m in spec.budgets)
    return ExecutionPlan(spec=spec, engine=engine, backend=backend,
                         task_name=task.name, n=ds.n, T=ds.T, dims=ds.dims,
                         grid=(R, M), m_cap=m_cap, predicted_comm_units=comm)
