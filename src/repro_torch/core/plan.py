"""CoresetSpec -> ExecutionPlan for the ported engines (port of
:mod:`repro.core.plan`).

A :class:`CoresetSpec` validates every knob; the names and values match
the reference's, so a spec carries over.  :func:`compile_plan` resolves it
against a dataset and the device the build computes on:

  * **Engines.**  A (seeds x budgets) grid runs on the batched engine.  A
    forced ``streamed`` engine runs block at a time (``chunk_blocks`` 1,
    no prefetch) and ``pipelined`` over superchunks of ``chunk_blocks``
    blocks (clamped to the block count), prefetched or not; ``pipelined``
    at ``chunk_blocks=1`` without prefetch is lowered to ``streamed``,
    which draws the same coreset.  ``jit=True`` selects the materialized
    engine's fused path (one CUDA graph per shape on the card).
    ``engine="auto"`` picks the fastest engine whose predicted peak fits
    ``memory_budget_bytes`` (:func:`memory_model`, fitted to the card):
    materialized, then pipelined, then streamed (flagged
    ``budget_exceeded`` when even that does not fit).  The budget counts
    the build's own bytes, above what was allocated when it began, here
    and in the :class:`MemoryWatchdog` that ``build_failover`` arms.  One
    adaptation of the reference: only the streaming engines read a dataset
    from the CPU, so for a host-resident dataset bound for the card
    ``auto`` chooses between pipelined and streamed alone, and says so in
    ``notes``.
  * **Wire.**  ``codec`` sets what the round-1 table crosses the wire as;
    ``codec="auto"`` walks :data:`~repro_torch.core.wire.CODEC_LADDER`
    against ``comm_budget_bits`` (:func:`~repro_torch.core.wire.choose_codec`),
    and the plan carries its predicted bits.
  * **Failover.**  ``fallback_chain`` is the cheaper tail of
    :data:`FAILOVER_LADDER` that ``CoresetPipeline.build_failover`` walks
    when an engine crashes or its :class:`MemoryWatchdog` trips.

``sharded_masses`` computes the streaming engines' block-mass table over
the ranks of a ``torch.distributed`` process group; ``fault_policy`` sets
how a build delivered through a :class:`~repro_torch.core.faults.Transport`
reacts to faults.  :class:`PlanCache` memoizes plans by (task, geometry,
devices, knobs).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from collections import OrderedDict
from typing import Any, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.comm import CommSchedule
from repro_torch.core.faults import FAULT_POLICIES
from repro_torch.core.vfl import VFLDataset, block_geometry
from repro_torch.core.wire import (
    CODEC_LADDER,
    SPEC_CODECS,
    choose_codec,
    fmt_bits,
    predict_dis_bits,
    predict_uniform_bits,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kmeans_assign_update import row_split
from repro_torch.kernels.weighted_gram import gram_split

#: Score backends, named as in the reference so specs carry over: in the
#: port ``"pallas"`` means the hand-written CUDA kernels.
SCORE_BACKENDS = ("pallas", "ref", "norm")

ENGINES = ("materialized", "batched", "streamed", "pipelined")

#: Failover order, most capable to minimum footprint.  A build that crashes
#: or breaches its runtime memory budget retries on the next engine in this
#: ladder (pipelined -> streamed draws the same coreset bit for bit).
FAILOVER_LADDER = ("materialized", "pipelined", "streamed")

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

#: Superchunks a prefetched pipelined build holds staged at its peak: the
#: one being scored and the next, copied meanwhile (two staging slots).
PIPELINED_PEAK_FACTOR = 2
#: (rows,)-sized float32 vectors per party live beside the staged data in
#: a scoring pass: the kernels' outputs, the row-valid weights, and the
#: score arithmetic (vkmc's gathers and quotients are the most).
SCORE_ROWS = 16
#: (rows,)-sized float32 vectors per party live while the draw takes the
#: log of a score table: ``rng.log``'s float64 fused-multiply-add
#: emulation, the table and its clamped copy.
DRAW_ROWS = 32

_FLOAT_BYTES = 4        # every engine scores in float32
_SAMPLE_BYTES = 8 + 4 + 4   # a drawn row: int64 index, float32 weight and score


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class CoresetSpec:
    """Frozen declarative description of one coreset construction.

    ``budgets`` accepts a single int or an iterable of ints; a grid
    (``num_seeds > 1`` or several budgets) compiles to the batched engine,
    whose draw capacity ``m_cap`` defaults to ``max(budgets)``.
    ``engine="auto"`` lets the planner choose from the memory model under
    ``memory_budget_bytes``; ``codec="auto"`` lets it choose the wire codec
    under ``comm_budget_bits``.  ``params`` carries task-specific score
    knobs verbatim.  All validation happens here, at construction; the one
    knob the planner coerces, ``chunk_blocks`` above the block count, is
    clamped with a note.
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
    memory_budget_bytes: Optional[int] = None
    sharded_masses: bool = False          # block-mass table over the process group
    m_cap: Optional[int] = None           # batched draw capacity override
    fault_policy: str = "fail"            # fail | retry | degrade | quarantine
    codec: str = "raw_fp32"               # wire codec, or "auto" (planner)
    comm_budget_bits: Optional[int] = None
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
        if self.memory_budget_bytes is not None and (
                not _is_int(self.memory_budget_bytes)
                or self.memory_budget_bytes < 1):
            raise ValueError(
                f"memory_budget_bytes must be a positive int, "
                f"got {self.memory_budget_bytes!r}"
            )
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
        if self.codec not in SPEC_CODECS:
            raise ValueError(
                f"codec must be one of {SPEC_CODECS}, got {self.codec!r}"
            )
        lossy = self.codec not in ("auto", "raw_fp32")
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
        if self.comm_budget_bits is not None and (
                not _is_int(self.comm_budget_bits)
                or self.comm_budget_bits < 1):
            raise ValueError(
                f"comm_budget_bits must be a positive int, "
                f"got {self.comm_budget_bits!r}"
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


# --------------------------------------------------------------------------
# Memory model (bytes): the build's own peak device memory, fitted to the
# card (chip_smoke.py phase 12)
# --------------------------------------------------------------------------

def block_bytes(T: int, bs: int, s: int) -> int:
    """One (T, bs, s) float32 stacked row block."""
    return T * bs * s * _FLOAT_BYTES


def partial_bytes(T: int, rows: int, s: int, k: int = 0) -> int:
    """The per-range partial sums one kernel launch over a (T, rows, s)
    batch allocates: K3 ``weighted_gram``'s P (s, s) triangles a party
    (``vrlr``'s Gram pass, ``k == 0``), or K2 ``kmeans_assign_update``'s P
    rows of k s + 2 k sums (``vkmc``'s stats pass and Lloyd); P is the
    kernel's own row split of ``rows``."""
    if k:
        return T * row_split(rows)[1] * (k * s + 2 * k) * _FLOAT_BYTES
    return T * gram_split(rows)[1] * s * s * _FLOAT_BYTES


def memory_model(
    T: int, n: int, s: int, bs: int, chunk_blocks: int,
    num_seeds: int = 1, num_budgets: int = 1, m_cap: int = 512,
    scored: bool = True, prefetch: bool = True, k: int = 0,
    center_sample: int = 0,
) -> dict:
    """Predicted peak device bytes of a build, per engine: what the build
    allocates above what was allocated when it began (the dataset's own
    residency is not part of it).  Each term is a buffer the port's code
    holds at the moment it peaks, with ``row`` = T x rows x 4 bytes, one
    float32 per row and party:

    materialized: the larger of the scoring phase — the (T, n, s) stacked
                  design, ``vkmc``'s K2 partials over n rows and
                  :data:`SCORE_ROWS` rows of n — and the draw phase,
                  :data:`DRAW_ROWS` rows of n (``rng.log`` over the (T, n)
                  scores, float64 temporaries included).
    batched:      materialized + the (R, M, m_cap) result grid, twice
                  (the cells' lists and their stack).
    streamed:     the pipelined engine at C = 1 without prefetch.
    pipelined:    the largest of three phases.  Scan: the staged
                  superchunk (the C = min(chunk_blocks, nb) blocks that
                  exist) once, or :data:`PIPELINED_PEAK_FACTOR` times
                  with prefetch when there is a next superchunk to stage,
                  plus per block the kernel partials
                  (:func:`partial_bytes`) and SCORE_ROWS rows of bs.
                  Redraw: DRAW_ROWS rows of bs per block of a group of C
                  (the log of the group's occupied cells).  ``vkmc``'s
                  local centers: a ``center_sample``-row subsample and
                  DRAW_ROWS rows of it for k-means++.

    Every engine adds m_cap drawn rows.  ``scored=False`` (the uniform
    task: no scores, no design on the device) leaves the sample buffers
    alone.  ``k`` is ``vkmc``'s cluster count (0 for ``vrlr``).

    Fitted on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 12;
    PERF.md section 5): the own peaks of ``vrlr`` and ``vkmc`` builds at
    n = 463,715, T = 3 (s = 31 / 30) on the materialized engine, streamed
    at blocks of 65,536 and 16,384, and pipelined at 65,536 (one
    superchunk of 8) and 16,384 (four, prefetch on and off), each at or
    below its prediction.
    """
    f = _FLOAT_BYTES
    samples = 2 * num_seeds * num_budgets * m_cap * _SAMPLE_BYTES
    if not scored:
        return {e: samples for e in ENGINES}
    nb = -(-n // bs)
    row_n = T * n * f
    materialized = samples + max(
        T * n * s * f + (partial_bytes(T, n, s, k) if k else 0)
        + SCORE_ROWS * row_n,
        DRAW_ROWS * row_n)
    row = T * bs * f
    centers = (min(center_sample, n) * (s + DRAW_ROWS) * f) if k else 0

    def streaming(C: int, slots: int) -> int:
        scan = (slots * C * block_bytes(T, bs, s)
                + C * (partial_bytes(T, bs, s, k) + SCORE_ROWS * row))
        return samples + max(scan, DRAW_ROWS * C * row, centers)

    C = max(1, min(int(chunk_blocks), nb))
    slots = PIPELINED_PEAK_FACTOR if (prefetch and nb > C) else 1
    return {
        "materialized": materialized,
        "batched": materialized + 2 * num_seeds * num_budgets * m_cap * 12,
        "streamed": streaming(1, 1),
        "pipelined": streaming(C, slots),
    }


def _fmt_bytes(b: int) -> str:
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f}MB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f}KB"
    return f"{b}B"


# --------------------------------------------------------------------------
# Runtime memory watchdog: the planner predicts a build's peak, the
# watchdog measures the device while it runs, and the failover ladder
# reacts when the budget is breached
# --------------------------------------------------------------------------

def live_bytes(device: DeviceLike = "cuda") -> int:
    """Bytes of live tensors on ``device`` right now, process-wide, views
    counted once.  On CUDA the caching allocator's
    ``torch.cuda.memory_allocated``; on the CPU a census of the tensors the
    garbage collector tracks, counted once per storage (as the reference
    dedups ``jax.live_arrays()`` by buffer).  This is the whole device's
    residency; a :class:`MemoryWatchdog` with a ``baseline`` subtracts what
    was resident before its build, which leaves the build's own bytes, the
    quantity :func:`memory_model` predicts."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.memory_allocated(dev))
    seen, total = set(), 0
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor) or obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):   # sparse, meta, ...
            continue
        if st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        total += st.nbytes()
    return total


class MemoryBudgetExceeded(RuntimeError):
    """The watchdog's census breached the build's ``memory_budget_bytes``.

    Raised by :class:`MemoryWatchdog` at a probe (after a superchunk or a
    redraw group, or after a build); the failover ladder catches it and
    retries on the next cheaper engine.  ``observed`` is the number held
    against ``budget``: live device bytes less ``baseline`` (the bytes
    resident before the build; 0 for an absolute census)."""

    def __init__(self, observed: int, budget: int, baseline: int = 0) -> None:
        if baseline:
            what = (f"the build's own device bytes {observed} (live "
                    f"{observed + baseline} less a baseline of {baseline} "
                    f"resident before it)")
        else:
            what = f"live device bytes {observed}"
        super().__init__(
            f"{what} exceed memory_budget_bytes="
            f"{budget} ({_fmt_bytes(observed)} > {_fmt_bytes(budget)})"
        )
        self.observed = int(observed)
        self.budget = int(budget)
        self.baseline = int(baseline)


class MemoryWatchdog:
    """Runtime guard: compare :func:`live_bytes` of ``device``, less
    ``baseline``, against a budget at every check.  Callable, so it plugs
    into the streaming engines' ``probe`` hook.

    With the default ``baseline=0`` the check is absolute: the whole
    device, process-wide, as in the reference.  ``build_failover`` sets
    the baseline to the bytes resident when its build starts, so the
    watchdog counts the build's own bytes, the quantity the planner's
    :func:`memory_model` predicts, and bytes resident before the build (a
    card-resident dataset, another tenant's tensors) count against
    neither.  ``peak`` keeps the absolute census, ``own_peak`` the bytes
    above the baseline, and ``checks`` the number of checks."""

    def __init__(self, budget_bytes: int, device: DeviceLike = "cuda",
                 baseline: int = 0) -> None:
        if not _is_int(budget_bytes) or budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be a positive int, got {budget_bytes!r}"
            )
        if not _is_int(baseline) or baseline < 0:
            raise ValueError(
                f"baseline must be a non-negative int, got {baseline!r}"
            )
        self.budget_bytes = int(budget_bytes)
        self.device = resolve_device(device)
        self.baseline = int(baseline)
        self.checks = 0
        self.peak = 0
        self.own_peak = 0

    def check(self) -> int:
        """One census; returns the bytes held against the budget (live
        bytes less the baseline)."""
        b = live_bytes(self.device)
        own = b - self.baseline
        self.checks += 1
        self.peak = max(self.peak, b)
        self.own_peak = max(self.own_peak, own)
        if own > self.budget_bytes:
            raise MemoryBudgetExceeded(own, self.budget_bytes, self.baseline)
        return own

    __call__ = check


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The compiled execution of a :class:`CoresetSpec` on one dataset:
    one concrete engine, the device the build computes on and the backend
    resolved from it, the (num_seeds, num_budgets) grid with its draw
    capacity, the streaming knobs (``chunk_blocks`` clamped to the block
    count), the exact predicted bill of every cell together (Algorithm 1's
    total does not depend on the realised round-2 counts), and ``notes``,
    the planner's decisions (lowerings, clamps, the budget verdicts).

    ``memory_model`` keeps every engine's predicted peak and
    ``predicted_peak_bytes`` the chosen engine's.  ``codec`` is the
    resolved wire codec (never ``"auto"``) and ``predicted_wire_bits`` its
    bill in bits: exact for ``raw_fp32``, an upper bound for codecs with
    varint index uploads.  ``comm_budget_exceeded`` and ``budget_exceeded``
    flag a plan whose cheapest codec or engine still overshoots its
    budget.  ``fallback_chain`` is the cheaper tail of
    :data:`FAILOVER_LADDER`: empty for the batched engine, for streamed,
    and for ``jit`` or ``sharded_masses`` plans, which pin their engine."""

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
    memory_model: Mapping[str, int]
    predicted_peak_bytes: int
    block_size: int = 65536
    chunk_blocks: int = 1
    prefetch: bool = False
    codec: str = "raw_fp32"
    predicted_wire_bits: int = 0
    comm_budget_exceeded: bool = False
    budget_exceeded: bool = False
    notes: Tuple[str, ...] = ()
    fallback_chain: Tuple[str, ...] = ()

    @property
    def is_grid(self) -> bool:
        return self.grid[0] > 1 or self.grid[1] > 1

    def describe(self) -> str:
        """Human-readable plan: engine, task, backend, grid, budgets, draw
        capacity, fault policy, the data's geometry, the integrity seam,
        the memory table and budget verdict, and the predicted bill in
        units and bits."""
        spec = self.spec
        nb, bs = block_geometry(self.n, self.block_size)
        lines = [
            f"ExecutionPlan: engine={self.engine}"
            + (" (jit)" if spec.jit and self.engine == "materialized" else "")
            + (" +sharded_masses" if spec.sharded_masses else "")
            + f" device={self.device}",
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
        mm = ", ".join(f"{e}={_fmt_bytes(self.memory_model[e])}"
                       for e in ENGINES)
        lines.append(f"  memory model: {mm}")
        if spec.memory_budget_bytes is None:
            lines.append(
                f"  budget: none -> {self.engine} "
                f"(predicted peak {_fmt_bytes(self.predicted_peak_bytes)})"
            )
        else:
            verdict = ("EXCEEDS budget — streamed is the minimum-footprint "
                       "engine" if self.budget_exceeded else "fits")
            lines.append(
                f"  budget: {_fmt_bytes(spec.memory_budget_bytes)} -> "
                f"{self.engine} (predicted peak "
                f"{_fmt_bytes(self.predicted_peak_bytes)}, {verdict})"
            )
        lines.append(
            f"  predicted comm: {self.predicted_comm_units} units "
            f"({fmt_bits(self.predicted_wire_bits)} on the wire, "
            f"codec={self.codec})"
        )
        if spec.comm_budget_bits is not None:
            verdict = ("EXCEEDS budget — no admissible codec fits"
                       if self.comm_budget_exceeded else "fits")
            lines.append(
                f"  comm budget: {fmt_bits(spec.comm_budget_bits)} -> "
                f"{self.codec} ({fmt_bits(self.predicted_wire_bits)}, "
                f"{verdict})"
            )
        for note in self.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Plan cache: the serving layer's compile-once seam
# --------------------------------------------------------------------------

#: CoresetSpec fields folded verbatim into the plan-cache key, in key
#: order.  ``task`` and ``params`` are encoded specially (registry name;
#: sorted item tuple).  The key audit asserts that every CoresetSpec field
#: is here, in that pair, or in PLAN_KEY_EXEMPT, so a new knob can never
#: silently alias cached plans.
PLAN_KEY_FIELDS = (
    "engine", "backend", "jit", "budgets", "num_seeds", "block_size",
    "chunk_blocks", "prefetch", "memory_budget_bytes", "sharded_masses",
    "m_cap", "fault_policy", "codec", "comm_budget_bits",
)

#: Spec fields deliberately left out of the key, each with the reason it
#: cannot alias a cached plan.  Empty: every knob shapes the plan.
PLAN_KEY_EXEMPT: Tuple[str, ...] = ()


class PlanCache:
    """Memoized :func:`compile_plan`, keyed by ``(task, dataset geometry,
    the build's device, the dataset's device, knobs)``.

    A long-lived service compiles the same plan over and over: every
    tenant streaming fixed-size superchunks presents the same signature.
    The port's plan depends on its devices (the backend, the prefetch
    default, the host-dataset rule of ``engine="auto"``), so both are in
    the key: a plan made for a CPU build is never served to a card build,
    which would refuse it.  A cached plan is geometry-checked at dispatch
    (``CoresetPipeline.build`` rejects a plan whose ``(n, dims)`` or
    device do not match), so one cache may serve many datasets.
    ``spec.params`` values must be hashable.

    ``max_entries`` bounds the cache LRU-style; ``prune`` sheds entries
    idle longer than a given age (``time_fn`` is injectable for
    deterministic tests); ``hits``, ``misses``, ``evictions`` and
    :meth:`stats` are the census a service reports.
    """

    DEFAULT_MAX_ENTRIES = 256

    def __init__(self, max_entries: Optional[int] = None, *,
                 time_fn=None) -> None:
        if max_entries is None:
            max_entries = self.DEFAULT_MAX_ENTRIES
        if not _is_int(max_entries) or max_entries < 1:
            raise ValueError(
                f"max_entries must be a positive int, got {max_entries!r}"
            )
        self.max_entries = int(max_entries)
        self._plans: "OrderedDict[tuple, ExecutionPlan]" = OrderedDict()
        self._time_fn = time.monotonic if time_fn is None else time_fn
        self._last_used: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def key(spec: CoresetSpec, ds: VFLDataset,
            device: Optional[DeviceLike] = None) -> tuple:
        dev = ds.device if device is None else resolve_device(device)
        task = spec.task if isinstance(spec.task, str) else spec.task.name
        return (
            (task, ds.n, ds.dims, ds.y is not None, str(dev), str(ds.device))
            + tuple(getattr(spec, f) for f in PLAN_KEY_FIELDS)
            + (tuple(sorted(spec.params.items())),)
        )

    def get(self, spec: CoresetSpec, ds: VFLDataset,
            device: Optional[DeviceLike] = None) -> ExecutionPlan:
        """The plan of ``spec`` on ``ds`` for a build on ``device``
        (default: where ``ds`` lives), compiled on a miss."""
        k = self.key(spec, ds, device)
        plan = self._plans.get(k)
        if plan is None:
            self.misses += 1
            plan = compile_plan(spec, ds, device)
            self._plans[k] = plan
            if len(self._plans) > self.max_entries:
                old, _ = self._plans.popitem(last=False)   # least recently used
                self._last_used.pop(old, None)
                self.evictions += 1
        else:
            self.hits += 1
            self._plans.move_to_end(k)
        self._last_used[k] = self._time_fn()
        return plan

    def __len__(self) -> int:
        return len(self._plans)

    def clear(self) -> None:
        self._plans.clear()
        self._last_used.clear()

    def prune(self, max_idle_s: float) -> int:
        """Evict every entry unused for more than ``max_idle_s`` seconds;
        returns how many (also added to ``evictions``)."""
        if not (isinstance(max_idle_s, (int, float)) and max_idle_s >= 0):
            raise ValueError(
                f"max_idle_s must be a non-negative number, got {max_idle_s!r}"
            )
        now = self._time_fn()
        stale = [k for k, t in self._last_used.items() if now - t > max_idle_s]
        for k in stale:
            self._plans.pop(k, None)
            self._last_used.pop(k, None)
        self.evictions += len(stale)
        return len(stale)

    def stats(self) -> dict:
        now = self._time_fn()
        ages = [now - t for t in self._last_used.values()]
        return {
            "size": len(self._plans),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "oldest_idle_s": max(ages) if ages else 0.0,
            "newest_idle_s": min(ages) if ages else 0.0,
        }


# --------------------------------------------------------------------------
# The planner
# --------------------------------------------------------------------------

def compile_plan(spec: CoresetSpec, ds: VFLDataset,
                 device: Optional[DeviceLike] = None) -> ExecutionPlan:
    """Compile ``spec`` against ``ds`` — pure planning, no scoring work.
    ``device`` is where the build computes (default: where ``ds`` lives);
    ``backend="auto"``, the prefetch default and the host-dataset rule of
    ``engine="auto"`` resolve from it.  ``memory_budget_bytes`` is held
    against :func:`memory_model`, the build's own bytes above what was
    allocated when it began (the dataset's residency and any other
    tensor resident before it are not part of it); ``build_failover``'s
    watchdog counts the same bytes.  Raises the task's label
    requirement and every invalid combination before any engine runs."""
    from repro_torch.core.api import get_task, resolve_backend

    dev = ds.device if device is None else resolve_device(device)
    task = get_task(spec.task)
    backend = resolve_backend(spec.backend, dev)
    if task.needs_labels and ds.y is None:
        raise ValueError(f"{task.name} requires labels at party T")
    uniform = task.score_fn is None
    s = 0 if uniform else ds.stacked_widths(with_labels=task.needs_labels)[1]
    n, T = ds.n, ds.T
    R, M = spec.num_seeds, len(spec.budgets)
    nb, bs = block_geometry(n, spec.block_size)
    m_cap = max(spec.budgets) if spec.m_cap is None else spec.m_cap
    notes = []
    chunk_req = (DEFAULT_CHUNK_BLOCKS if spec.chunk_blocks is None
                 else int(spec.chunk_blocks))
    chunk = min(chunk_req, nb)
    prefetch = (PREFETCH_DEFAULT.get(dev.type, True) if spec.prefetch is None
                else spec.prefetch)
    k = int(spec.params.get("k", 10)) if task.name == "vkmc" else 0
    mm = memory_model(T, n, s, bs, chunk, R, M, m_cap, scored=not uniform,
                      prefetch=prefetch, k=k,
                      center_sample=int(spec.params.get("center_sample", 16384)))

    # -- engine selection ----------------------------------------------------
    # the port's adaptation: only the streaming engines read a dataset that
    # lives on the CPU from a build on another device
    host_data = ds.device.type == "cpu" and dev.type != "cpu"
    B = spec.memory_budget_bytes
    budget_exceeded = False
    if spec.is_grid:
        if spec.engine not in ("auto", "batched"):
            raise ValueError(
                f"engine={spec.engine!r} builds one coreset per call; a "
                f"{R}x{M} grid requires engine='batched' (or 'auto')"
            )
        engine = "batched"
        if spec.engine == "auto":
            notes.append(f"{R}x{M} grid -> batched (one call)")
    elif spec.engine != "auto":
        engine = spec.engine
    else:
        candidates = (("pipelined",) if host_data
                      else ("materialized", "pipelined"))
        if B is None:
            engine = candidates[0]
        else:
            engine = next((e for e in candidates if mm[e] <= B), "streamed")
            budget_exceeded = engine == "streamed" and mm["streamed"] > B
            notes.append(
                f"auto-selected {engine} for memory_budget_bytes={B} ("
                + ", ".join(f"{e} needs {mm[e]}"
                            for e in candidates + ("streamed",)) + ")"
            )
        if host_data:
            notes.append(
                f"the dataset lives on {ds.device}, the build on {dev}: only "
                f"the streamed and pipelined engines read it from there, so "
                f"auto chooses between them"
            )

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
            f"chunk_blocks clamped {chunk_req} -> {nb}: n={n} at "
            f"block_size={spec.block_size} has only {nb} blocks "
            f"(one full-span superchunk)"
        )
    # spec flags that only some engines take must not be dropped silently
    # when the auto-planner picks another one
    if spec.jit and engine not in ("materialized", "batched"):
        raise ValueError(
            f"jit=True is the materialized/batched fused path, but the "
            f"auto-planner selected engine {engine!r} — drop jit or force "
            f"a compatible engine"
        )
    if spec.sharded_masses:
        _check_sharded(engine, backend, task.name, n, bs)
    comm = R * sum(CommSchedule.uniform(T, m).total if uniform
                   else CommSchedule.dis_total(T, m) for m in spec.budgets)

    # -- wire codec (the comm-budget axis) -----------------------------------
    # the round-1 table has one entry per scoring cell: n rows on the
    # materialized and batched engines, nb blocks on the streaming ones
    cells = n if engine in ("materialized", "batched") else nb
    lossless_only = spec.jit or engine == "batched"
    if spec.codec not in ("auto", "raw_fp32") and lossless_only:
        raise ValueError(
            f"codec={spec.codec!r} quantizes per-round payloads, but the "
            f"planner selected the "
            f"{'jit fused' if spec.jit else 'batched'} path — use "
            f"codec='raw_fp32' or a transported engine"
        )

    def _predict(name: str) -> int:
        if uniform:
            return R * sum(predict_uniform_bits(T, m) for m in spec.budgets)
        return R * sum(predict_dis_bits(T, m, cells, name) for m in spec.budgets)

    if spec.codec == "auto" and lossless_only:
        # the only admissible codec on a path that never leaves the device
        codec, wire_bits = "raw_fp32", _predict("raw_fp32")
        comm_budget_exceeded = (spec.comm_budget_bits is not None
                                and wire_bits > spec.comm_budget_bits)
        if comm_budget_exceeded:
            notes.append(
                f"comm budget {spec.comm_budget_bits}b unmeetable: the "
                f"{'jit' if spec.jit else 'batched'} path admits only "
                f"raw_fp32 ({wire_bits}b predicted)"
            )
    else:
        bits_by_codec = {name: _predict(name) for name in CODEC_LADDER}
        codec, comm_budget_exceeded, codec_note = choose_codec(
            spec.codec, spec.comm_budget_bits, bits_by_codec)
        wire_bits = bits_by_codec[codec]
        if codec_note:
            notes.append(codec_note)

    # failover: the cheaper engines after the chosen one; jit and
    # sharded_masses bind the spec to its engine
    if engine in FAILOVER_LADDER and not spec.jit and not spec.sharded_masses:
        fallback = FAILOVER_LADDER[FAILOVER_LADDER.index(engine) + 1:]
    else:
        fallback = ()
    return ExecutionPlan(spec=spec, engine=engine, backend=backend,
                         task_name=task.name, n=n, T=T, dims=ds.dims,
                         grid=(R, M), m_cap=m_cap, predicted_comm_units=comm,
                         device=dev, memory_model=mm,
                         predicted_peak_bytes=mm[engine],
                         block_size=spec.block_size, chunk_blocks=chunk,
                         prefetch=prefetch, codec=codec,
                         predicted_wire_bits=wire_bits,
                         comm_budget_exceeded=comm_budget_exceeded,
                         budget_exceeded=budget_exceeded, notes=tuple(notes),
                         fallback_chain=fallback)


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
