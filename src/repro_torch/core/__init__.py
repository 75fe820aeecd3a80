"""repro_torch.core — the coreset/VFL core of the port: the ``vrlr`` and
``vkmc`` tasks on the materialized engine (eager or fused), the batched
engine and the streamed and pipelined engines (block masses optionally
sharded over a ``torch.distributed`` process group; checkpointed resume),
the planner (memory model, codec axis, plan cache, engine failover),
Algorithm 1 (flat and hierarchical) and its seed API, the party fault and
integrity seam, the regression and k-means solvers, the materialized
coresets the serving tree keeps, the seed-era builders as deprecation
shims over ``build_coreset``, and the score and draw primitives of the LM
batch selector (``core.selector``: ``ridge_leverage_scores``,
``norm_scores``, ``server_plan``)."""

import warnings
from typing import Optional

from repro_torch import rng as _rng
from repro_torch.device import DeviceLike as _DeviceLike

from repro_torch.core.api import (
    CORESET_TASKS,
    SCORE_BACKENDS,
    BatchedCoresets,
    CoresetPipeline,
    CoresetTask,
    FailoverAttempt,
    FailoverOutcome,
    build_coreset,
    build_coreset_jit,
    build_coreset_streaming,
    build_coresets_batched,
    get_task,
    register_task,
    resolve_backend,
)
from repro_torch.core.comm import (
    CommLedger,
    CommSchedule,
    null_ledger,
    theoretical_dis_cost,
)
from repro_torch.core.coreset import (
    Coreset,
    MaterializedCoreset,
    vkmc_coreset_ratio,
    vrlr_coreset_ratio,
)
from repro_torch.core.faults import (
    FAULT_POLICIES,
    SILENT_KINDS,
    Clock,
    Deadline,
    DeadlineExceeded,
    DegradedBuild,
    DroppedParty,
    FaultPlan,
    PartyUnavailable,
    SimClock,
    StreamCheckpoint,
    Transport,
    TransportStats,
    WallClock,
    deliver_or_record,
    perturb_payload,
)
from repro_torch.core.integrity import (
    GRAM_COND_WARN,
    Finding,
    HealthReport,
    IntegrityError,
    WireEnvelope,
    check_mass_table,
    check_merge_children,
    check_weights,
    health_from_masses,
    payload_digest,
    require_valid_masses,
)
from repro_torch.core.dis import (
    blocked_geometry,
    dis_blocked_marginals,
    dis_marginals,
    dis_plan,
    dis_plan_blocked,
    dis_plan_full,
    dis_sample,
    server_plan,
    uniform_plan,
    uniform_sample,
)
from repro_torch.core.plan import (
    DEFAULT_CHUNK_BLOCKS,
    ENGINES,
    FAILOVER_LADDER,
    CoresetSpec,
    ExecutionPlan,
    MemoryBudgetExceeded,
    MemoryWatchdog,
    PlanCache,
    compile_plan,
    live_bytes,
    memory_model,
)
from repro_torch.core.streaming import (
    StreamScorer,
    dis_plan_streamed,
    dis_plan_streamed_batched,
    make_stream_scorer,
    register_stream_scorer,
    vkmc_block_masses_sharded,
    vkmc_local_centers,
    vrlr_block_masses_sharded,
    with_masses,
)
from repro_torch.core.sensitivity import (
    norm_scores,
    ridge_leverage_scores,
    total_sensitivity_bound_vkmc,
    total_sensitivity_bound_vrlr,
)
from repro_torch.core.solve import (
    DEFAULT_SOLVER,
    EvalReport,
    FitResult,
    end_to_end,
    evaluate,
    fit_kmeans,
    fit_ridge,
    full_data_coreset,
    solver_for,
)
from repro_torch.core.vfl import VFLDataset, as_numpy, split_columns, standardize
from repro_torch.core.vkmc import (
    distdim,
    kmeans,
    kmeans_central_comm_cost,
    kmeans_cost,
    kmeans_plusplus,
    lloyd,
)
from repro_torch.core.vrlr import (
    central_comm_cost,
    elastic_cost,
    fista,
    lasso_cost,
    ridge_closed_form,
    ridge_cost,
    saga_ridge,
    solve,
    sq_loss,
)


# --------------------------------------------------------------------------
# Deprecated seed-era builders — thin shims over build_coreset.
# Same PRNG key => bit-identical (S, w) and identical ledger totals.
# --------------------------------------------------------------------------

def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


def build_vrlr_coreset(
    key: _rng.Key,
    ds: VFLDataset,
    m: int,
    ledger: Optional[CommLedger] = None,
    use_kernel: bool = True,
    device: _DeviceLike = "cuda",
) -> Coreset:
    """Deprecated: use ``build_coreset("vrlr", ds, m, key=key, ...)``."""
    _deprecated("build_vrlr_coreset", 'build_coreset("vrlr", ...)')
    # use_kernel=True maps to "auto" (the kernels on the card, the plain
    # versions on the CPU), so the shim resolves to build_coreset's default
    # backend and stays draw-identical to it on every device.
    return build_coreset("vrlr", ds, m, key=key,
                         backend="auto" if use_kernel else "ref",
                         ledger=ledger, device=device)


def build_vkmc_coreset(
    key: _rng.Key,
    ds: VFLDataset,
    k: int,
    m: int,
    alpha: float = 2.0,
    local_iters: int = 15,
    ledger: Optional[CommLedger] = None,
    use_kernel: bool = True,
    device: _DeviceLike = "cuda",
) -> Coreset:
    """Deprecated: use ``build_coreset("vkmc", ds, m, key=key, k=k, ...)``."""
    _deprecated("build_vkmc_coreset", 'build_coreset("vkmc", ...)')
    return build_coreset("vkmc", ds, m, key=key,
                         backend="auto" if use_kernel else "ref",
                         ledger=ledger, device=device, k=k, alpha=alpha,
                         local_iters=local_iters)


def build_uniform_coreset(
    key: _rng.Key,
    ds: VFLDataset,
    m: int,
    ledger: Optional[CommLedger] = None,
    device: _DeviceLike = "cuda",
) -> Coreset:
    """Deprecated: use ``build_coreset("uniform", ds, m, key=key, ...)``."""
    _deprecated("build_uniform_coreset", 'build_coreset("uniform", ...)')
    return build_coreset("uniform", ds, m, key=key, ledger=ledger,
                         device=device)


__all__ = [
    "as_numpy",
    "BatchedCoresets",
    "blocked_geometry",
    "build_coreset",
    "build_coreset_jit",
    "build_coreset_streaming",
    "build_coresets_batched",
    "build_uniform_coreset",
    "build_vkmc_coreset",
    "build_vrlr_coreset",
    "central_comm_cost",
    "check_mass_table",
    "check_merge_children",
    "check_weights",
    "Clock",
    "CommLedger",
    "CommSchedule",
    "compile_plan",
    "Coreset",
    "CORESET_TASKS",
    "CoresetPipeline",
    "CoresetSpec",
    "CoresetTask",
    "Deadline",
    "DeadlineExceeded",
    "DEFAULT_CHUNK_BLOCKS",
    "DEFAULT_SOLVER",
    "DegradedBuild",
    "deliver_or_record",
    "dis_blocked_marginals",
    "dis_marginals",
    "dis_plan",
    "dis_plan_blocked",
    "dis_plan_full",
    "dis_plan_streamed",
    "dis_plan_streamed_batched",
    "dis_sample",
    "distdim",
    "DroppedParty",
    "elastic_cost",
    "end_to_end",
    "ENGINES",
    "EvalReport",
    "evaluate",
    "ExecutionPlan",
    "FAILOVER_LADDER",
    "FailoverAttempt",
    "FailoverOutcome",
    "FAULT_POLICIES",
    "FaultPlan",
    "Finding",
    "fista",
    "fit_kmeans",
    "fit_ridge",
    "FitResult",
    "full_data_coreset",
    "get_task",
    "GRAM_COND_WARN",
    "health_from_masses",
    "HealthReport",
    "IntegrityError",
    "kmeans",
    "kmeans_central_comm_cost",
    "kmeans_cost",
    "kmeans_plusplus",
    "lasso_cost",
    "live_bytes",
    "lloyd",
    "make_stream_scorer",
    "MaterializedCoreset",
    "memory_model",
    "MemoryBudgetExceeded",
    "MemoryWatchdog",
    "norm_scores",
    "null_ledger",
    "PartyUnavailable",
    "payload_digest",
    "perturb_payload",
    "PlanCache",
    "register_stream_scorer",
    "register_task",
    "require_valid_masses",
    "resolve_backend",
    "ridge_closed_form",
    "ridge_leverage_scores",
    "ridge_cost",
    "saga_ridge",
    "server_plan",
    "SCORE_BACKENDS",
    "SILENT_KINDS",
    "SimClock",
    "solve",
    "solver_for",
    "split_columns",
    "sq_loss",
    "standardize",
    "StreamCheckpoint",
    "StreamScorer",
    "theoretical_dis_cost",
    "total_sensitivity_bound_vkmc",
    "total_sensitivity_bound_vrlr",
    "Transport",
    "TransportStats",
    "uniform_plan",
    "uniform_sample",
    "VFLDataset",
    "vkmc_block_masses_sharded",
    "vkmc_coreset_ratio",
    "vkmc_local_centers",
    "vrlr_block_masses_sharded",
    "vrlr_coreset_ratio",
    "WallClock",
    "WireEnvelope",
    "with_masses",
]
