"""The batched engine (``build_coresets_batched``, ``BatchedCoresets``,
``CoresetPipeline.build`` on a grid): the port against the reference on
the CPU, from the same numpy data and keys, on an R = 3 seeds x M = 2
budgets grid.

Exact: the counts, each cell's bill (units, bits and per-tag ledger), the
``vrlr`` and ``uniform`` indices, and the ``vkmc`` indices when both
engines draw from the reference's own scores (the port's own ``vkmc``
scores come from iterated Lloyd and agree only to fp tolerance).  Weights
at ``rtol=1e-5``.  Within the port, every cell at ``m == m_cap`` equals
the eager ``build_coreset`` for its key bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import VFLDataset as JDataset
from repro.core import build_coresets_batched as j_batched
from repro.core.api import vkmc_scores as j_vkmc_scores
from repro_torch import rng
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    BatchedCoresets, CommLedger, CommSchedule, CoresetPipeline, CoresetSpec,
    CoresetTask, build_coreset, build_coresets_batched)
from repro_torch.kernels import ops as kops

MS = (40, 96)
R = 3
VKMC = dict(k=4, local_iters=3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _both(seed=3, n=900, d=10, T=3, device="cpu"):
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((6, d)).astype(np.float32)
    X = centers[r.integers(0, 6, n)] + r.standard_normal((n, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + 0.1 * r.standard_normal(n)).astype(np.float32)
    jds = JDataset.from_dense(X, y, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts], np.asarray(jds.y),
                             device)
    return jds, tds


def _ref_vkmc_task(jds):
    """``vkmc`` as the port's engine sees it, scored by the reference: the
    same key choreography (the score function returns its DIS key), the
    reference's own scores."""

    def score_fn(key, ds, backend="ref", **params):
        sc, dk = j_vkmc_scores(jnp.asarray(key.cpu().numpy().astype(np.uint32)),
                               jds, backend="ref", **params)
        return (torch.from_numpy(np.array(sc)),
                key_from_numpy(np.asarray(dk), "cpu"))

    return CoresetTask(name="vkmc", score_fn=score_fn, deterministic_scores=False)


def _check_against_reference(jg, tg, exact_indices=True):
    assert isinstance(tg, BatchedCoresets)
    assert tg.indices.shape == tg.weights.shape == (R, len(MS), max(MS))
    assert (tg.ms, tg.T, tg.cells, tg.num_seeds) == (jg.ms, jg.T, jg.cells, jg.num_seeds)
    if jg.counts is None:
        assert tg.counts is None
    else:
        np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    if exact_indices:
        np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_allclose(tg.weights.numpy(), np.asarray(jg.weights), rtol=1e-5)
    for r in range(R):
        for i, m in enumerate(MS):
            js, ts = jg.schedule(r, i), tg.schedule(r, i)
            assert (ts.total, ts.total_bits) == (js.total, js.total_bits)
            jl, tl = JLedger(), CommLedger()
            jcs, tcs = jg.coreset(r, i, ledger=jl), tg.coreset(r, i, ledger=tl)
            assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits,
                                                               jl.by_tag())
            assert (tcs.m, tcs.comm_units, tcs.comm_bits) == (jcs.m, jcs.comm_units,
                                                              jcs.comm_bits)
            # the prefix convention: m real entries, a zero-weight tail
            assert bool((tg.weights[r, i, :m] > 0).all())
            assert not tg.weights[r, i, m:].any() and not tg.indices[r, i, m:].any()
            if tg.counts is not None:
                assert int(tg.counts[r, i].sum()) == m
                assert ts.total == CommSchedule.dis_total(tg.T, m)


def _check_cap_cells_are_eager(task, tds, tg, keys, **params):
    """Cells at m == m_cap are the eager materialized builds, bit for bit."""
    for r in range(R):
        eager = build_coreset(task, tds, max(MS), key=keys[r], device="cpu", **params)
        cell = tg.coreset(r, len(MS) - 1)
        assert torch.equal(cell.indices, eager.indices)
        assert torch.equal(cell.weights, eager.weights)
        assert (cell.comm_units, cell.comm_bits) == (eager.comm_units, eager.comm_bits)


@pytest.mark.parametrize("task", ["vrlr", "uniform"])
def test_grid_matches_reference_and_eager_builds(task):
    jds, tds = _both(4)
    kj = jax.random.PRNGKey(11)
    jg = j_batched(task, jds, MS, key=kj, num_seeds=R, backend="ref")
    tg = build_coresets_batched(task, tds, MS, key=key_from_numpy(np.asarray(kj), "cpu"),
                                num_seeds=R, device="cpu")
    _check_against_reference(jg, tg)
    keys = rng.split(key_from_numpy(np.asarray(kj), "cpu"), R)
    _check_cap_cells_are_eager(task, tds, tg, keys)


def test_vkmc_grid_matches_reference_on_its_scores_and_eager_builds():
    jds, tds = _both(5)
    kj = jax.random.PRNGKey(12)
    tkey = key_from_numpy(np.asarray(kj), "cpu")
    jg = j_batched("vkmc", jds, MS, key=kj, num_seeds=R, backend="ref", **VKMC)
    # the engine on the reference's own scores: every draw is the reference's
    tg = build_coresets_batched(_ref_vkmc_task(jds), tds, MS, key=tkey, num_seeds=R,
                                device="cpu", **VKMC)
    _check_against_reference(jg, tg)
    # on the port's own scores: the bills and the prefix convention hold,
    # and the m_cap cells are the eager builds
    own = build_coresets_batched("vkmc", tds, MS, key=tkey, num_seeds=R,
                                 device="cpu", **VKMC)
    _check_against_reference(jg, own, exact_indices=False)
    _check_cap_cells_are_eager("vkmc", tds, own, rng.split(tkey, R), **VKMC)


def test_deterministic_scores_are_scored_once_per_grid(monkeypatch):
    """``vrlr`` declares key-independent scores and hands its key back, so
    the grid scores once: one K1 call for all R x M cells.  ``vkmc`` scores
    once per seed."""
    _, tds = _both(6, n=300)
    calls = []
    real = kops.leverage
    monkeypatch.setattr(kops, "leverage", lambda *a, **k: calls.append(1) or real(*a, **k))
    build_coresets_batched("vrlr", tds, MS, key=rng.PRNGKey(1), num_seeds=R,
                           device="cpu")
    assert len(calls) == 1
    real_kau = kops.kmeans_assign_update
    kau_calls = []
    monkeypatch.setattr(kops, "kmeans_assign_update",
                        lambda *a, **k: kau_calls.append(1) or real_kau(*a, **k))
    build_coresets_batched("vkmc", tds, MS, key=rng.PRNGKey(1), num_seeds=R,
                           device="cpu", **VKMC)
    # per seed: local_iters Lloyd passes and one scoring pass
    assert len(kau_calls) == R * (VKMC["local_iters"] + 1)


def test_a_score_function_that_moves_its_key_is_scored_per_seed():
    """``deterministic_scores`` alone does not hoist: the score function must
    also return its key unchanged, else each seed samples with its own DIS
    key, as its eager build does."""
    _, tds = _both(7, n=300)
    calls = []

    def score_fn(key, ds, backend="ref"):
        calls.append(1)
        return torch.ones((ds.T, ds.n)) + torch.arange(ds.n) / ds.n, rng.fold_in(key, 5)

    task = CoresetTask(name="moves_key", score_fn=score_fn)
    assert task.deterministic_scores
    keys = rng.split(rng.PRNGKey(2), R)
    tg = build_coresets_batched(task, tds, MS, keys=keys, device="cpu")
    assert len(calls) == 1 + R
    _check_cap_cells_are_eager(task, tds, tg, keys)

    def zeros(key, ds, backend="ref"):
        return torch.zeros((ds.T, ds.n)), key

    for det in (True, False):
        with pytest.raises(ValueError, match="positive total"):
            build_coresets_batched(CoresetTask(name="zero", score_fn=zeros,
                                               deterministic_scores=det),
                                   tds, MS, keys=keys, device="cpu")


def test_pipeline_dispatches_grids_to_the_batched_engine():
    _, tds = _both(8, n=200)
    pipe = CoresetPipeline(tds)
    spec = CoresetSpec(task="vrlr", budgets=MS, num_seeds=R)
    key = rng.PRNGKey(3)
    tg = pipe.build(spec, key=key, device="cpu")
    keys = rng.split(key, R)
    again = pipe.build(pipe.plan(spec), keys=keys, device="cpu")
    assert torch.equal(tg.indices, again.indices) and torch.equal(tg.weights, again.weights)
    # an explicit m_cap draws every budget at that capacity
    capped = pipe.build(spec.replace(m_cap=128), key=key, device="cpu")
    assert capped.indices.shape == (R, len(MS), 128)
    one = pipe.build(CoresetSpec(task="vrlr", budgets=MS[0], engine="batched"), key=key,
                     device="cpu")
    assert one.indices.shape == (1, 1, MS[0])
    with pytest.raises(ValueError, match="key"):
        pipe.build(spec, device="cpu")
    with pytest.raises(ValueError, match="key"):
        pipe.build(CoresetSpec(task="vrlr", budgets=MS[0]), device="cpu")
