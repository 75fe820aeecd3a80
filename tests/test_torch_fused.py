"""The fused engine: ``build_coreset_jit`` / ``CoresetSpec(jit=True)``
against the reference's ``build_coreset_jit(backend="ref")`` and the
port's eager ``build_coreset``, both on the CPU, from the same numpy data
and key; its builder cache and the spec's validation.

Tolerances: indices and bills (units and bits) are exact.  Weights are
held to the reference at ``rtol=1e-5`` (the scores are two fp32 ``eigh``
or Lloyd computations, summed in another order); against the port's own
eager build they are equal bit for bit, since on the CPU the fused body
is the eager one.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import VFLDataset as JDataset
from repro.core.api import build_coreset_jit as j_build_coreset_jit
from repro_torch import rng
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    CommLedger, CoresetPipeline, CoresetSpec, VFLDataset, build_coreset,
    build_coreset_jit)
from repro_torch.core import api as tapi

TASKS = [("vrlr", {}), ("vkmc", {"k": 4, "local_iters": 3}), ("uniform", {})]


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


def _key(i):
    return rng.PRNGKey(i)


def _both(seed, n=1500, d=12, T=3):
    """benchmarks/e2e.py's clustered regression data, small, in both
    packages."""
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((8, d)).astype(np.float32)
    X = centers[r.integers(0, 8, n)] + r.standard_normal((n, d)).astype(np.float32)
    y = X @ r.standard_normal(d).astype(np.float32) + 0.1 * r.standard_normal(n).astype(np.float32)
    jds = JDataset.from_dense(X, y, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts], np.asarray(jds.y), "cpu")
    return jds, tds


@pytest.mark.parametrize("task,kw", TASKS)
@pytest.mark.parametrize("seed,m", [(3, 64), (4, 211)])
def test_build_coreset_jit_matches_reference_and_eager(task, kw, seed, m):
    jds, tds = _both(seed)
    key = jax.random.PRNGKey(seed + 20)
    tkey = key_from_numpy(np.asarray(key), "cpu")
    jcs = j_build_coreset_jit(task, jds, m, key=key, backend="ref", **kw)
    led = CommLedger()
    tcs = build_coreset_jit(task, tds, m, key=tkey, ledger=led, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(jcs.indices), tcs.indices.numpy())
    np.testing.assert_allclose(tcs.weights.numpy(), np.asarray(jcs.weights), rtol=1e-5)
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert led.total == tcs.comm_units
    assert tcs.health is None                       # none on this path, as in the reference
    eager = build_coreset(task, tds, m, key=tkey, device="cpu", **kw)
    assert torch.equal(eager.indices, tcs.indices)
    assert torch.equal(eager.weights, tcs.weights)
    assert (eager.comm_units, eager.comm_bits) == (tcs.comm_units, tcs.comm_bits)


def test_build_coreset_jit_caches_per_shape():
    """One entry for two keys of the same shapes, a new one for a new m
    (``tests/test_fused.py::test_build_coreset_jit_caches_compilation``)."""
    _, tds = _both(12)
    build_coreset_jit("vrlr", tds, 30, key=_key(0), device="cpu")
    size0 = len(tapi._JIT_BUILDERS)
    build_coreset_jit("vrlr", tds, 30, key=_key(1), device="cpu")
    assert len(tapi._JIT_BUILDERS) == size0          # same geometry: a hit
    build_coreset_jit("vrlr", tds, 31, key=_key(2), device="cpu")
    assert len(tapi._JIT_BUILDERS) == size0 + 1      # new budget: a new entry


def test_cached_builder_serves_another_dataset_of_the_same_shapes():
    _, a = _both(13)
    _, b = _both(14)
    key = _key(5)
    build_coreset_jit("vkmc", a, 40, key=key, device="cpu", k=3, local_iters=2)
    size0 = len(tapi._JIT_BUILDERS)
    got = build_coreset_jit("vkmc", b, 40, key=key, device="cpu", k=3, local_iters=2)
    assert len(tapi._JIT_BUILDERS) == size0
    want = build_coreset("vkmc", b, 40, key=key, device="cpu", k=3, local_iters=2)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.weights, want.weights)


def test_jit_spec_validation_and_plan():
    with pytest.raises(ValueError, match="jit"):
        CoresetSpec(jit=True, engine="streamed")
    with pytest.raises(ValueError, match="jit"):
        CoresetSpec(jit=1)
    _, tds = _both(15, n=300)
    pipe = CoresetPipeline(tds)
    assert "(jit)" in pipe.plan(CoresetSpec(budgets=8, jit=True)).describe()
    assert "(jit)" not in pipe.plan(CoresetSpec(budgets=8)).describe()
    # the batched engine accepts jit=True and runs as without it
    key = _key(9)
    grid = pipe.build(CoresetSpec(budgets=(5, 8), jit=True, backend="ref"), key=key,
                      device="cpu")
    plain = pipe.build(CoresetSpec(budgets=(5, 8), backend="ref"), key=key, device="cpu")
    assert torch.equal(grid.indices, plain.indices) and torch.equal(grid.weights, plain.weights)


def test_fused_build_requires_labels_for_vrlr():
    _, tds = _both(16, n=300)
    unlabeled = VFLDataset(tds.parts)
    with pytest.raises(ValueError, match="labels"):
        build_coreset_jit("vrlr", unlabeled, 8, key=_key(1), device="cpu")
