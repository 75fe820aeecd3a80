"""The CoresetPipeline API for the ported engines (port of
:mod:`repro.core.api`).

Party-local scores -> DIS sampling -> importance weights, on two engines:
the materialized engine with the DIS rounds recorded on a ledger (the
reference's ``transport is None`` branch of ``_exec_materialized``), and
the batched engine over a (seeds x budgets) grid, billed lazily per cell:

  * :class:`CoresetTask` + :func:`register_task` — the task registry
    (``CORESET_TASKS``); shipped here: ``vrlr`` (Algorithm 2), ``vkmc``
    (Algorithm 3) and ``uniform`` (the U-* baseline).
  * :class:`CoresetPipeline` — ``build(spec)`` compiles a
    :class:`~repro_torch.core.plan.CoresetSpec` and runs it.
  * :func:`build_coreset` — the shim over a forced materialized spec;
    :func:`build_coresets_batched` — the shim over a batched one, which
    returns a :class:`BatchedCoresets` grid.

Key choreography matches the reference: the ``vrlr`` score function
passes its key through untouched; ``vkmc`` splits it once per party (the
local k-means++ seeds) and once more for DIS; DIS consumes its key as
:func:`repro_torch.core.dis.dis_plan_full` describes.  Builds run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

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
from repro_torch.core.sensitivity import (
    norm_scores,
    vkmc_local_scores,
    vrlr_scores_stacked,
)
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vkmc import kmeans_plusplus, lloyd
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
    schedule is broadcast-only.  ``deterministic_scores`` says the scores
    do not depend on the key (``vrlr``); ``vkmc`` draws its local seeds.
    The batched engine scores once for all seeds only when it is true.
    """

    name: str
    score_fn: Optional[ScoreFn]
    needs_labels: bool = False
    deterministic_scores: bool = True
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


@register_task("vkmc", deterministic_scores=False,
               description="Algorithm 3: local alpha-approx k-means sensitivities + DIS")
def vkmc_scores(key, ds: VFLDataset, backend: str = "pallas",
                k: int = 10, alpha: float = 2.0, local_iters: int = 15):
    """Algorithm 3: party j runs local k-means (alpha-approximate) and
    scores its block; the key is split once per party and once more for
    DIS — the reference's chain.

    k-means++ runs party by party (each pick draws from 1-D logits); then
    every Lloyd iteration, and the scoring pass, is ONE
    ``kmeans_assign_update`` launch over the (T, n, s) stacked view.  Zero
    column padding is distance-transparent, so the padded blocks give the
    per-party values.
    """
    subs = []
    for _ in range(ds.T):                     # the reference's per-party chain
        key, sub = rng.split(key)
        subs.append(sub)
    key, dis_key = rng.split(key)
    st = ds.stacked()
    if backend == "norm":
        return norm_scores(st.blocks) + 1.0 / ds.n, dis_key
    use_kernel = _use_kernel(backend)
    init = torch.stack([kmeans_plusplus(sub, Xb, k)
                        for sub, Xb in zip(subs, st.blocks)])
    local_c = lloyd(st.blocks, init, iters=local_iters, use_kernel=use_kernel)
    return vkmc_local_scores(st.blocks, local_c, alpha, use_kernel), dis_key


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


@dataclasses.dataclass(frozen=True)
class BatchedCoresets:
    """A (num_seeds, num_budgets) grid of coresets from one batched build.

    ``indices``/``weights`` are ``(R, M, m_cap)`` with the valid-prefix
    convention: cell (r, i) holds ``ms[i]`` real samples; the padded tail
    has index 0 and weight 0.  ``counts`` carries the realised round-2 a_j
    per cell, so each cell's exact :class:`CommSchedule` is derived after
    the fact.
    """

    indices: torch.Tensor            # (R, M, m_cap) int64
    weights: torch.Tensor            # (R, M, m_cap) float32
    counts: Optional[torch.Tensor]   # (R, M, T) int64; None for the uniform task
    ms: Tuple[int, ...]
    T: int
    cells: int                       # round-1 mass-table entries per party (n)

    @property
    def num_seeds(self) -> int:
        return int(self.indices.shape[0])

    def schedule(self, seed_idx: int, m_idx: int) -> CommSchedule:
        m = self.ms[m_idx]
        if self.counts is None:
            return CommSchedule.uniform(self.T, m)
        return CommSchedule.dis(
            self.T, m, counts=self.counts[seed_idx, m_idx].tolist(),
            round1_payload=WirePayload.of((self.cells,), "float32", "raw_fp32"),
        )

    def coreset(self, seed_idx: int, m_idx: int = 0,
                ledger: Optional[CommLedger] = None) -> Coreset:
        """Extract cell (seed_idx, m_idx) as a plain :class:`Coreset`."""
        m = self.ms[m_idx]
        schedule = self.schedule(seed_idx, m_idx).record(ledger)
        return Coreset(
            self.indices[seed_idx, m_idx, :m],
            self.weights[seed_idx, m_idx, :m],
            schedule.total,
            comm_bits=schedule.total_bits,
        )


def _exec_batched(
    spec: CoresetTask, ds: VFLDataset, ms: Tuple[int, ...], keys: torch.Tensor,
    backend: str, m_cap: int, params: dict,
) -> BatchedCoresets:
    """The batched engine: every (seed, budget) cell of the grid, each a
    :func:`dis_plan_full` at draw capacity ``m_cap`` (the prefix-masking
    convention).  A cell at ``m == m_cap`` is exactly the eager
    :func:`_exec_materialized` result for that key.

    A ``deterministic_scores`` task is scored once for the whole grid, if
    its score function hands the key back unchanged (the contract that
    lets every seed sample from the same scores); the cells then share
    the eager per-party totals.  Any other task is scored once per seed.
    """
    if spec.needs_labels and ds.y is None:
        raise ValueError(f"{spec.name} requires labels at party T")
    if spec.score_fn is None:
        cells = [[uniform_plan(k, ds.n, m, m_cap=m_cap) for m in ms] for k in keys]
        return BatchedCoresets(
            indices=torch.stack([torch.stack([S for S, _ in row]) for row in cells]),
            weights=torch.stack([torch.stack([w for _, w in row]) for row in cells]),
            counts=None, ms=ms, T=ds.T, cells=ds.n)

    hoisted = totals = None
    if spec.deterministic_scores:
        sc0, dk0 = spec.score_fn(keys[0], ds, backend=backend, **params)
        if torch.equal(dk0, keys[0]):
            hoisted = sc0
    if hoisted is not None:
        if not bool(hoisted.sum() > 0):
            raise ValueError("DIS requires a positive total score")
        # the eager per-party totals, the reduction the materialized engine
        # runs, so w = G/(m g) matches its builds bit for bit
        totals = torch.sum(hoisted.to(torch.float32), dim=1)
    plans = []
    for k in keys:
        if hoisted is None:
            sc, dis_key = spec.score_fn(k, ds, backend=backend, **params)
        else:
            sc, dis_key = hoisted, k
        plans.append([dis_plan_full(dis_key, sc, m, m_cap=m_cap, totals=totals)
                      for m in ms])
    S, w, counts = (torch.stack([torch.stack([p[f] for p in row]) for row in plans])
                    for f in (0, 1, 2))
    if not bool(torch.all(w[..., 0] > 0)):
        # w[r, i, 0] = G / (m * g) is positive iff the realised total score G was
        raise ValueError("DIS requires a positive total score")
    return BatchedCoresets(indices=S, weights=w, counts=counts, ms=ms,
                           T=ds.T, cells=ds.n)


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
        key: Optional[rng.Key] = None,
        keys: Optional[torch.Tensor] = None,
        ledger: Optional[CommLedger] = None,
        device: DeviceLike = "cuda",
    ) -> Union[Coreset, BatchedCoresets]:
        """Build per the (compiled) spec on ``device`` — the card unless
        the caller asks for the CPU; the dataset must live there.

        Returns a :class:`Coreset` for single-cell plans and a
        :class:`BatchedCoresets` grid for the batched engine.  ``keys`` (a
        ``(R, 2)`` key stack) overrides ``key`` + ``spec.num_seeds`` for
        the batched engine, which bills its cells lazily
        (``grid.coreset(..., ledger=...)``), so ``ledger`` applies to
        single-cell engines only."""
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
        task = get_task(cspec.task)
        if ep.engine == "batched":
            if keys is None:
                if key is None:
                    raise ValueError("pass either `key` (+ num_seeds) or `keys`")
                keys = rng.split(key, cspec.num_seeds)
            return _exec_batched(task, self.ds, cspec.budgets, keys.to(dev),
                                 ep.backend, ep.m_cap, cspec.params)
        if key is None:
            raise ValueError(f"the {ep.engine} engine requires `key`")
        return _exec_materialized(task, self.ds, cspec.budget, key.to(dev),
                                  ep.backend, ledger, cspec.params)


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


def build_coresets_batched(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    ms: Sequence[int],
    *,
    key: Optional[rng.Key] = None,
    num_seeds: int = 1,
    keys: Optional[torch.Tensor] = None,
    backend: str = "auto",
    m_cap: Optional[int] = None,
    device: DeviceLike = "cuda",
    **params,
) -> BatchedCoresets:
    """Construct coresets for every (seed, budget) pair — the batched
    engine (shim over ``CoresetSpec(engine="batched")``).

    ``ms`` is the budget grid; seeds come either from ``keys`` (a ``(R, 2)``
    key stack) or ``rng.split(key, num_seeds)``.  Budgets below
    ``max(ms)`` use the prefix-masking convention (draws are iid, so a
    prefix of the capacity draw is a valid m-sample); for ``m == max(ms)``
    each cell is exactly the :func:`build_coreset` result for that key.
    ``m_cap`` overrides the draw capacity; every budget must lie in
    [1, m_cap].

    Unlike the reference, whose default is ``backend="ref"`` (its plain
    scores are cheapest on a CPU), ``backend`` defaults to ``"auto"``: on
    the card the grid runs the hand-written kernels, on the CPU the plain
    versions.
    """
    ms = tuple(int(m) for m in ms)
    if keys is not None:
        num_seeds = int(keys.shape[0])
    spec = CoresetSpec(task=task, budgets=ms, num_seeds=num_seeds,
                       engine="batched", backend=backend, m_cap=m_cap,
                       params=params)
    return CoresetPipeline(ds).build(spec, key=key, keys=keys, device=device)
