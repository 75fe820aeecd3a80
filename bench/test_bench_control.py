"""``correct`` fails where it must: the control (the plain reference in
TF32 in the program's place) on three seeds, and a run whose timed path is
broken underneath, at a size the CPU holds."""

import importlib
import time

import pytest
import torch

import repro_torch.kernels.ops as kops
from benchlib import check, runner, tiny, traffic
from reference import algorithms as ref

# the module: ``repro_torch.core`` exports a function of the same name
solve = importlib.import_module("repro_torch.core.solve")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: the intra-op pool costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", ["vrlr-sweep", "vkmc-fused"])
def test_control_is_not_correct(workload):
    cell = tiny.cell(workload, n=600, budgets=(20, 40))
    cfg, mix = cell.config, cell.mix
    for seed in (11, 12, 13):
        inputs = cell.inputs.make(cfg, seed, torch.device("cpu"))
        req = next(traffic.requests(mix, seed, 0))
        done = [(req, cell.judge.reference_serve(cfg, mix, cell.engine, inputs, req, ref.TF32))]
        nums = cell.judge.judge(cfg, inputs, done, seed, 0)
        assert not check.verdict(nums, check.limits_of(cfg)), (seed, nums)


def _drawn_one_row_off(keys, logits, cap, counts, total=None):
    out = _categorical_parties(keys, logits, cap, counts, total)
    return (out + 1) % logits.shape[1]


def _theta_off(X, y, lam, w=None):
    return _ridge(X, y, lam, w) * 1.01


def _centers_off(key, X, k, w=None, iters=25, use_kernel=True):
    return _kmeans(key, X, k, w, iters=iters, use_kernel=use_kernel) + 0.05


_categorical_parties = kops.categorical_parties
_ridge, _kmeans = solve.ridge_closed_form, solve.kmeans


@pytest.mark.parametrize("fault", ["draw", "fit"])
@pytest.mark.parametrize("workload", ["vrlr-sweep", "vkmc-fused", "vrlr-fused"])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    """An answer altered where it is produced: every drawn index moved to
    the next row (the categorical kernel's output), or the fit's
    parameters off (the ridge solve, the k-means solver)."""
    if fault == "draw":
        monkeypatch.setattr(kops, "categorical_parties", _drawn_one_row_off)
    else:
        monkeypatch.setattr(solve, "ridge_closed_form", _theta_off)
        monkeypatch.setattr(solve, "kmeans", _centers_off)
    cell = tiny.cell(workload)
    out = runner.run_cell(cell, 5, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"] is False, out["checks"]
