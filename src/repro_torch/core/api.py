"""The CoresetPipeline API for the ported slice (port of
:mod:`repro.core.api`).

Party-local scores -> DIS sampling -> importance weights, on the
materialized engine with the DIS rounds recorded on a ledger (the
reference's ``transport is None`` branch of ``_exec_materialized``):

  * :class:`CoresetTask` + :func:`register_task` — the task registry
    (``CORESET_TASKS``); shipped here: ``vrlr`` (Algorithm 2) and
    ``uniform`` (the U-* baseline).  ``vkmc`` waits for the k-means kernels.
  * :class:`CoresetPipeline` — ``build(spec)`` compiles a
    :class:`~repro_torch.core.plan.CoresetSpec` and runs it.
  * :func:`build_coreset` — the shim over a forced materialized spec.

Key choreography matches the reference: the ``vrlr`` score function
passes its key through untouched, and DIS consumes it as
:func:`repro_torch.core.dis.dis_plan_full` describes.  Builds run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch import rng
from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.coreset import Coreset
from repro_torch.core.dis import dis_plan_full, uniform_plan
from repro_torch.core.integrity import health_from_masses
from repro_torch.core.plan import (
    SCORE_BACKENDS,
    CoresetSpec,
    ExecutionPlan,
    compile_plan,
)
from repro_torch.core.sensitivity import norm_scores, vrlr_scores_stacked
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.wire import WirePayload
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.registry import Registry

CORESET_TASKS = Registry("coreset_task")


def resolve_backend(backend: str, device: DeviceLike) -> str:
    """Resolve ``"auto"`` from the device the data lives on: ``pallas``
    (the hand-written kernels) for CUDA, ``ref`` for the CPU.  Explicit
    names pass through (and are validated)."""
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "ref"
    if backend not in SCORE_BACKENDS:
        raise ValueError(
            f"unknown score backend {backend!r}; expected 'auto' or one of "
            f"{SCORE_BACKENDS}"
        )
    return backend


def _use_kernel(backend: str) -> bool:
    if backend not in SCORE_BACKENDS:
        raise ValueError(
            f"unknown score backend {backend!r}; expected one of {SCORE_BACKENDS}"
        )
    return backend == "pallas"


# ScoreFn(key, ds, backend=..., **params) -> (scores (T, n), dis_key).
ScoreFn = Callable[..., Tuple[torch.Tensor, rng.Key]]


@dataclasses.dataclass(frozen=True)
class CoresetTask:
    """Declarative spec of one coreset-construction task.

    ``score_fn is None`` marks the uniform baseline: no scores travel, the
    schedule is broadcast-only.
    """

    name: str
    score_fn: Optional[ScoreFn]
    needs_labels: bool = False
    description: str = ""


def register_task(name: str, **spec_kwargs):
    """Decorator: register a score function as task ``name``."""

    def deco(score_fn: ScoreFn) -> ScoreFn:
        CORESET_TASKS.register(name)(
            CoresetTask(name=name, score_fn=score_fn, **spec_kwargs)
        )
        return score_fn

    return deco


def get_task(task: Union[str, CoresetTask]) -> CoresetTask:
    if isinstance(task, CoresetTask):
        return task
    return CORESET_TASKS.get(task)


@register_task("vrlr", needs_labels=True,
               description="Algorithm 2: per-party ridge-leverage scores + DIS")
def vrlr_scores(key, ds: VFLDataset, backend: str = "pallas"):
    """Algorithm 2 lines 2-3: g_i^(j) = ||u_i^(j)||^2 + 1/n per party, with
    party T scoring [X^(T), y].  Deterministic — the key passes through to
    DIS untouched.  All T parties are scored at once over the padded
    stacked view: batched Gram + eigh, then ONE party-batched ``leverage``
    kernel launch.
    """
    st = ds.stacked(with_labels=True)
    if backend == "norm":
        return norm_scores(st.blocks) + 1.0 / ds.n, key
    return vrlr_scores_stacked(st.blocks, use_kernel=_use_kernel(backend)), key


CORESET_TASKS.register("uniform")(
    CoresetTask(name="uniform", score_fn=None,
                description="U-* baseline: uniform indices, weight n/m")
)


def _exec_materialized(
    spec: CoresetTask, ds: VFLDataset, m: int, key, backend: str,
    ledger: Optional[CommLedger], params: dict,
) -> Coreset:
    """The eager engine: scores computed at once, DIS on the full (T, n)
    matrix, the exact per-round bill derived from the realised plan and
    recorded on ``ledger``."""
    if spec.needs_labels and ds.y is None:
        raise ValueError(f"{spec.name} requires labels at party T")
    if spec.score_fn is None:
        S, w = uniform_plan(key, ds.n, m, device=ds.device)
        schedule = CommSchedule.uniform(ds.T, m)
        schedule.record(ledger)
        return Coreset(S, w, schedule.total, comm_bits=schedule.total_bits)

    # the round-1 G_j upload physically carries the per-row mass table —
    # one float32 entry per row on this engine
    r1_payload = WirePayload.of((ds.n,), "float32", "raw_fp32")
    scores, dis_key = spec.score_fn(key, ds, backend=backend, **params)
    plan = dis_plan_full(dis_key, scores, m)
    if not bool(plan.totals.sum() > 0):
        raise ValueError("DIS requires a positive total score")
    schedule = CommSchedule.dis(ds.T, m, counts=plan.counts.tolist(),
                                round1_payload=r1_payload)
    schedule.record(ledger)
    return Coreset(plan.indices, plan.weights, schedule.total,
                   comm_bits=schedule.total_bits,
                   health=health_from_masses(scores.cpu().numpy()))


@dataclasses.dataclass
class CoresetPipeline:
    """The declarative entry point: ``build(spec)`` compiles the spec into
    an :class:`~repro_torch.core.plan.ExecutionPlan` and runs its engine.
    ``build`` also accepts a pre-compiled plan."""

    ds: VFLDataset

    def plan(self, spec: CoresetSpec) -> ExecutionPlan:
        return compile_plan(spec, self.ds)

    def build(
        self,
        spec: Union[CoresetSpec, ExecutionPlan],
        *,
        key: rng.Key,
        ledger: Optional[CommLedger] = None,
        device: DeviceLike = "cuda",
    ) -> Coreset:
        """Build per the (compiled) spec on ``device`` — the card unless
        the caller asks for the CPU; the dataset must live there."""
        dev = resolve_device(device)
        if self.ds.device != dev:
            raise ValueError(
                f"the dataset lives on {self.ds.device}, the build was asked "
                f"to run on {dev}; build the dataset with device={str(dev)!r}"
            )
        if isinstance(spec, ExecutionPlan):
            ep = spec
            if (ep.n, ep.dims) != (self.ds.n, self.ds.dims):
                raise ValueError(
                    f"plan was compiled for a dataset with n={ep.n}, "
                    f"dims={ep.dims}; this pipeline's dataset has "
                    f"n={self.ds.n}, dims={self.ds.dims} — recompile with "
                    f"plan(spec)"
                )
        else:
            ep = self.plan(spec)
        cspec = ep.spec
        return _exec_materialized(get_task(cspec.task), self.ds, cspec.budget,
                                  key.to(dev), ep.backend, ledger,
                                  cspec.params)


def build_coreset(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    budget: int,
    *,
    key: rng.Key,
    backend: str = "auto",
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = "cuda",
    **params,
) -> Coreset:
    """Build one coreset of ``budget`` rows for ``task`` on ``ds`` — the
    materialized engine (shim over ``CoresetSpec(engine="materialized")``).
    ``backend="auto"`` takes the kernels on the card and the plain
    versions on the CPU."""
    spec = CoresetSpec(task=task, budgets=int(budget),
                       engine="materialized", backend=backend, params=params)
    return CoresetPipeline(ds).build(spec, key=key, ledger=ledger,
                                     device=device)
