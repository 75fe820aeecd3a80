"""repro_torch.core — the coreset/VFL core of the port (the ``vrlr`` slice
on the materialized engine)."""

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
    EvalReport,
    FitResult,
    end_to_end,
    evaluate,
    fit_ridge,
    full_data_coreset,
)
from repro_torch.core.vfl import VFLDataset, split_columns

__all__ = [
    "CORESET_TASKS",
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
    "end_to_end",
    "evaluate",
    "fit_ridge",
    "full_data_coreset",
    "get_task",
    "null_ledger",
    "register_task",
    "resolve_backend",
    "split_columns",
]
