"""CoresetSpec -> ExecutionPlan for the ported slice (the part of
:mod:`repro.core.plan` the materialized engine needs).

A :class:`CoresetSpec` validates the fields this slice reads; the names
and values match the reference's, so a spec carries over.
:func:`compile_plan` resolves it against a dataset: the materialized
engine is the only one ported, and every other engine raises
``NotImplementedError`` naming the ROADMAP item that ports it.  The
memory model, codec axis, fault policies and plan cache wait for their
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple, Union

import numpy as np

from repro_torch.core.comm import CommSchedule
from repro_torch.core.vfl import VFLDataset

#: Score backends, named as in the reference so specs carry over: in the
#: port ``"pallas"`` means the hand-written CUDA kernels.
SCORE_BACKENDS = ("pallas", "ref", "norm")

ENGINES = ("materialized", "batched", "streamed", "pipelined")

#: Where each engine the port lacks is scheduled (ROADMAP.md, queue 1).
_NOT_PORTED = {
    "batched": "queue 1, item 11 (batched and fused engines)",
    "streamed": "queue 1, item 12 (streamed and pipelined engines)",
    "pipelined": "queue 1, item 12 (streamed and pipelined engines)",
}


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class CoresetSpec:
    """Frozen declarative description of one coreset construction.

    ``budgets`` accepts a single int or an iterable of ints; a grid
    (``num_seeds > 1`` or several budgets) needs the batched engine, which
    is not ported yet.  ``params`` carries task-specific score knobs
    verbatim.  All validation happens here, at construction.
    """

    task: Union[str, Any] = "vrlr"
    budgets: Union[int, Tuple[int, ...]] = (512,)
    num_seeds: int = 1
    engine: str = "auto"
    backend: str = "auto"
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


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compiled execution of a :class:`CoresetSpec` on one dataset:
    one concrete engine, the backend resolved from the dataset's device,
    and the exact predicted bill (Algorithm 1's total does not depend on
    the realised round-2 counts)."""

    spec: CoresetSpec
    engine: str
    backend: str
    task_name: str
    n: int
    T: int
    dims: Tuple[int, ...]
    predicted_comm_units: int


def compile_plan(spec: CoresetSpec, ds: VFLDataset) -> ExecutionPlan:
    """Compile ``spec`` against ``ds`` — pure planning, no scoring work."""
    from repro_torch.core.api import get_task, resolve_backend

    task = get_task(spec.task)
    backend = resolve_backend(spec.backend, ds.device)
    if task.needs_labels and ds.y is None:
        raise ValueError(f"{task.name} requires labels at party T")
    engine = "batched" if spec.is_grid else spec.engine
    if engine == "auto":
        engine = "materialized"
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"the {engine} engine is not ported to PyTorch yet (ROADMAP.md "
            f"{_NOT_PORTED[engine]}); use engine='materialized' with one "
            f"budget and one seed"
        )
    m = spec.budget
    comm = (CommSchedule.uniform(ds.T, m).total if task.score_fn is None
            else CommSchedule.dis_total(ds.T, m))
    return ExecutionPlan(spec=spec, engine=engine, backend=backend,
                         task_name=task.name, n=ds.n, T=ds.T, dims=ds.dims,
                         predicted_comm_units=comm)
