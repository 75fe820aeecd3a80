"""The regression objectives and solvers (``core/vrlr.py``): the port
against the reference on the CPU, from the same numpy data and keys.

Tolerances: the objectives and ``_soft`` at ``rtol=1e-6`` (one fp32 sum in
another order).  FISTA: 500 iterations of fp32 products taken in another
order, so theta is held within 1e-5 of max|theta| and the objective at
``rtol=1e-5``.  SAGA: the row stream is exact (``rng.randint_each`` is
held bit for bit to ``jax.vmap(jax.random.randint)``), theta within 1e-5
of max|theta| after 20,000 steps, and the ledger exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import vrlr as jv
from repro_torch import rng
from repro_torch.convert import key_from_numpy
from repro_torch.core import CommLedger
from repro_torch.core import vrlr as tv


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


def _data(seed, n=3000, d=12):
    r = np.random.default_rng(seed)
    X = (r.standard_normal((n, d)) + r.uniform(-1, 1, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + 0.1 * r.standard_normal(n)).astype(np.float32)
    w = r.uniform(0.5, 2.0, n).astype(np.float32)
    return X, y, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close_theta(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_objectives_and_soft_threshold(weighted):
    X, y, w = _data(1, n=500)
    w = w if weighted else None
    theta = np.random.default_rng(2).standard_normal(X.shape[1]).astype(np.float32)
    args_j = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(theta))
    args_t = (_t(X), _t(y), _t(theta))
    pairs = [
        (jv.sq_loss(*args_j, _j(w)), tv.sq_loss(*args_t, _t(w))),
        (jv.ridge_cost(*args_j, 30.0, _j(w)), tv.ridge_cost(*args_t, 30.0, _t(w))),
        (jv.lasso_cost(*args_j, 1000.0, _j(w)), tv.lasso_cost(*args_t, 1000.0, _t(w))),
        (jv.elastic_cost(*args_j, 1000.0, 500.0, _j(w)),
         tv.elastic_cost(*args_t, 1000.0, 500.0, _t(w))),
    ]
    for want, got in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    x = np.array([-3.0, -0.5, -0.0, 0.0, 0.25, 0.5, 2.0], np.float32)
    np.testing.assert_allclose(tv._soft(_t(x), 0.5).numpy(),
                               np.asarray(jv._soft(jnp.asarray(x), 0.5)), rtol=1e-6)


@pytest.mark.parametrize("lam2", [0.0, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_fista_matches_reference(weighted, lam2):
    X, y, w = _data(3)
    n = X.shape[0]
    w = w if weighted else None
    lam1, lam2 = 2.0 * n, lam2 * n                  # benchmarks/common.py's scale
    tj = jv.fista(jnp.asarray(X), jnp.asarray(y), lam1, lam2, _j(w))
    tt = tv.fista(_t(X), _t(y), lam1, lam2, _t(w))
    assert tt.dtype == torch.float32 and tt.shape == (X.shape[1],)
    _close_theta(tt.numpy(), tj)
    cost = jv.elastic_cost if lam2 else (lambda *a: jv.lasso_cost(*a[:4], a[5]))
    tcost = tv.elastic_cost if lam2 else (lambda *a: tv.lasso_cost(*a[:4], a[5]))
    want = float(cost(jnp.asarray(X), jnp.asarray(y), tj, lam1, lam2, _j(w)))
    got = float(tcost(_t(X), _t(y), tt, lam1, lam2, _t(w)))
    assert got == pytest.approx(want, rel=1e-5)


def test_randint_each_matches_vmapped_jax():
    kj = jax.random.PRNGKey(17)
    keys_j = jax.random.split(kj, 2000)
    keys_t = rng.split(key_from_numpy(np.asarray(kj), "cpu"), 2000)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j).astype(np.int64))
    for lo, hi in ((0, 3000), (0, 463_715), (5, 6), (7, 2 ** 31 - 1)):
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(keys_j))
        got = rng.randint_each(keys_t, lo, hi)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="num, 2"):
        rng.randint_each(keys_t[0], 0, 10)


@pytest.mark.parametrize("weighted", [False, True])
def test_saga_ridge_matches_reference(weighted):
    X, y, w = _data(5)
    n = X.shape[0]
    w = w if weighted else None
    kj = jax.random.PRNGKey(21)
    jl, tl = JLedger(), CommLedger()
    tj = jv.saga_ridge(kj, jnp.asarray(X), jnp.asarray(y), 0.1 * n, _j(w),
                       steps=20_000, dims=(4, 4, 4), ledger=jl)
    tt = tv.saga_ridge(key_from_numpy(np.asarray(kj), "cpu"), _t(X), _t(y),
                       0.1 * n, _t(w), steps=20_000, dims=(4, 4, 4), ledger=tl)
    _close_theta(tt.numpy(), tj)
    assert tl.by_tag() == jl.by_tag() == {"saga/partials": 60_000,
                                          "saga/residuals": 60_000}
    assert (tl.total, tl.total_bits) == (jl.total, jl.total_bits)


def test_saga_with_a_given_lr_matches_reference():
    """The fixed-``lr`` branch (``solve("saga")``'s), on few rows so that
    rows repeat often in the stream and the table's old gradients count."""
    X, y, w = _data(4, n=7, d=3)
    kj = jax.random.PRNGKey(3)
    tj = jv.saga_ridge(kj, jnp.asarray(X), jnp.asarray(y), 0.7, jnp.asarray(w),
                       steps=500, lr=0.01)
    tt = tv.saga_ridge(key_from_numpy(np.asarray(kj), "cpu"), _t(X), _t(y), 0.7,
                       _t(w), steps=500, lr=0.01)
    _close_theta(tt.numpy(), tj)


@pytest.mark.parametrize("kind", ["ridge", "linear", "lasso", "elastic", "saga"])
def test_solve_matches_reference(kind):
    X, y, w = _data(7, n=1500, d=8)
    n = X.shape[0]
    kw = dict(lam=0.1 * n, lam1=2.0 * n, lam2=1.0 * n, saga_steps=3000)
    kj = jax.random.PRNGKey(8)
    tj = jv.solve(kind, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), key=kj, **kw)
    tt = tv.solve(kind, _t(X), _t(y), _t(w), key=key_from_numpy(np.asarray(kj), "cpu"),
                  **kw)
    assert np.isfinite(tt.numpy()).all()
    _close_theta(tt.numpy(), tj)


def test_solve_rejects_unknown_kind_and_missing_key():
    X, y, _ = _data(9, n=50, d=3)
    with pytest.raises(ValueError, match="unknown solver"):
        tv.solve("newton", _t(X), _t(y))
    with pytest.raises(ValueError, match="key"):
        tv.solve("saga", _t(X), _t(y), lam=1.0)
