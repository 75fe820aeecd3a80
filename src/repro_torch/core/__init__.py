"""repro_torch.core — the coreset/VFL core of the port: the ``vrlr`` and
``vkmc`` tasks on the materialized engine (eager or fused) and the batched
engine, Algorithm 1 and its seed API, and the regression and k-means
solvers."""

from repro_torch.core.api import (
    CORESET_TASKS,
    BatchedCoresets,
    CoresetPipeline,
    CoresetTask,
    build_coreset,
    build_coreset_jit,
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
from repro_torch.core.coreset import Coreset, vkmc_coreset_ratio, vrlr_coreset_ratio
from repro_torch.core.dis import (
    dis_marginals,
    dis_plan,
    dis_plan_full,
    dis_sample,
    uniform_plan,
    uniform_sample,
)
from repro_torch.core.plan import ENGINES, CoresetSpec, ExecutionPlan, compile_plan
from repro_torch.core.sensitivity import (
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

__all__ = [
    "as_numpy",
    "BatchedCoresets",
    "build_coreset",
    "build_coreset_jit",
    "build_coresets_batched",
    "central_comm_cost",
    "CommLedger",
    "CommSchedule",
    "compile_plan",
    "Coreset",
    "CORESET_TASKS",
    "CoresetPipeline",
    "CoresetSpec",
    "CoresetTask",
    "DEFAULT_SOLVER",
    "dis_marginals",
    "dis_plan",
    "dis_plan_full",
    "dis_sample",
    "distdim",
    "elastic_cost",
    "end_to_end",
    "ENGINES",
    "EvalReport",
    "evaluate",
    "ExecutionPlan",
    "fista",
    "fit_kmeans",
    "fit_ridge",
    "FitResult",
    "full_data_coreset",
    "get_task",
    "kmeans",
    "kmeans_central_comm_cost",
    "kmeans_cost",
    "kmeans_plusplus",
    "lasso_cost",
    "lloyd",
    "null_ledger",
    "register_task",
    "resolve_backend",
    "ridge_closed_form",
    "ridge_cost",
    "saga_ridge",
    "solve",
    "solver_for",
    "split_columns",
    "sq_loss",
    "standardize",
    "theoretical_dis_cost",
    "total_sensitivity_bound_vkmc",
    "total_sensitivity_bound_vrlr",
    "uniform_plan",
    "uniform_sample",
    "VFLDataset",
    "vkmc_coreset_ratio",
    "vrlr_coreset_ratio",
]
