"""repro_torch.core — the coreset/VFL core of the port (the ``vrlr`` and
``vkmc`` slices on the materialized engine)."""

from repro_torch.core.api import (
    CORESET_TASKS,
    CoresetPipeline,
    CoresetTask,
    build_coreset,
    get_task,
    register_task,
    resolve_backend,
)
from repro_torch.core.comm import CommLedger, CommSchedule, null_ledger
from repro_torch.core.coreset import Coreset
from repro_torch.core.plan import CoresetSpec, ExecutionPlan, compile_plan
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
from repro_torch.core.vfl import VFLDataset, split_columns
from repro_torch.core.vkmc import (
    distdim,
    kmeans,
    kmeans_central_comm_cost,
    kmeans_cost,
    kmeans_plusplus,
    lloyd,
)

__all__ = [
    "CORESET_TASKS",
    "DEFAULT_SOLVER",
    "CommLedger",
    "CommSchedule",
    "Coreset",
    "CoresetPipeline",
    "CoresetSpec",
    "CoresetTask",
    "EvalReport",
    "ExecutionPlan",
    "FitResult",
    "VFLDataset",
    "build_coreset",
    "compile_plan",
    "distdim",
    "end_to_end",
    "evaluate",
    "fit_kmeans",
    "fit_ridge",
    "full_data_coreset",
    "get_task",
    "kmeans",
    "kmeans_central_comm_cost",
    "kmeans_cost",
    "kmeans_plusplus",
    "lloyd",
    "null_ledger",
    "register_task",
    "resolve_backend",
    "solver_for",
    "split_columns",
]
