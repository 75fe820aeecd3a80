"""Algorithm 3's solvers and scores in the port against the reference, on
the CPU (the reference's plain ``use_kernel=False`` branches, the port's
plain versions), from the same numpy data and keys.

Tolerances:

- k-means++ picks are exact: the same rows (so the same seed centers, bit
  for bit) for the same key.  The draws are bit-exact (``rng``), and the
  logits ``log(max(w d2, 1e-30))`` differ only where two fp32 distance sums
  round apart; a flip needs two gumbel-max candidates within about 1e-6,
  which these inputs never bring.
- ``lloyd`` centers, ``kmeans_cost`` and the vkmc scores are fp32 results
  of sums taken in another order (XLA's and torch's), iterated: they are
  held at ``rtol=1e-4`` (centers at ``1e-4`` of their largest entry).
- Each party's scores sum to Lemma F.2's 2(k+1)alpha at ``rtol=1e-5``
  when no local cluster is empty.
- Ledgers (units, bits, tags) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import VFLDataset as JDataset
from repro.core import sensitivity as jsens
from repro.core import vkmc as jv
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import CommLedger
from repro_torch.core import sensitivity as tsens
from repro_torch.core import vkmc as tv

TOL = dict(rtol=1e-4)


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


def _clustered(seed, n, d, k=6):
    r = np.random.default_rng(seed)
    centers = 3.0 * r.standard_normal((k, d)).astype(np.float32)
    return (centers[r.integers(0, k, n)]
            + r.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _key(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


def _close_centers(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed,n,d,k", [(0, 1500, 13, 8), (1, 257, 4, 5),
                                        (2, 64, 1, 3), (3, 40, 6, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_plusplus_picks_the_reference_rows(seed, n, d, k, weighted):
    X = _clustered(seed, n, d)
    w = (np.random.default_rng(seed + 1).uniform(0.0, 3.0, n).astype(np.float32)
         if weighted else None)
    kj, kt = _key(seed + 20)
    cj = np.asarray(jv.kmeans_plusplus(kj, jnp.asarray(X), k,
                                       None if w is None else jnp.asarray(w)))
    ct = tv.kmeans_plusplus(kt, torch.from_numpy(X), k,
                            None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_and_kmeans_cost_match_reference(weighted):
    X = _clustered(4, 2000, 13)
    w = (np.random.default_rng(5).uniform(0.0, 3.0, 2000).astype(np.float32)
         if weighted else None)
    init = X[[3, 500, 900, 1200, 1700, 1999]]
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    for iters in (1, 4, 25):
        cj = jv.lloyd(jnp.asarray(X), jnp.asarray(init), jw, iters=iters,
                      use_kernel=False)
        ct = tv.lloyd(torch.from_numpy(X), torch.from_numpy(init), tw,
                      iters=iters, use_kernel=False)
        _close_centers(ct.numpy(), cj)
        for use_kernel in (False, True):    # on the CPU both take the plain path
            got = float(tv.kmeans_cost(torch.from_numpy(X), ct, tw,
                                       use_kernel=use_kernel))
            want = float(jv.kmeans_cost(jnp.asarray(X), cj, jw, use_kernel=False))
            assert got == pytest.approx(want, rel=TOL["rtol"])


def test_lloyd_keeps_empty_clusters_and_batches_over_parties():
    X = _clustered(6, 300, 5)
    far = np.full((1, 5), 1e3, np.float32)                 # attracts no row
    init = np.concatenate([X[:3], far])
    ct = tv.lloyd(torch.from_numpy(X), torch.from_numpy(init), iters=3,
                  use_kernel=False).numpy()
    np.testing.assert_array_equal(ct[3], far[0])
    cj = np.asarray(jv.lloyd(jnp.asarray(X), jnp.asarray(init), iters=3,
                             use_kernel=False))
    _close_centers(ct, cj)
    # the party stack in one call equals each party alone
    Xs = np.stack([X, X[::-1].copy(), 2.0 * X])
    inits = np.stack([X[:4], X[10:14], 2.0 * X[20:24]])
    stacked = tv.lloyd(torch.from_numpy(Xs), torch.from_numpy(inits), iters=5,
                       use_kernel=False)
    for j in range(3):
        alone = tv.lloyd(torch.from_numpy(Xs[j]), torch.from_numpy(inits[j]),
                         iters=5, use_kernel=False)
        torch.testing.assert_close(stacked[j], alone, rtol=1e-5, atol=1e-5)


def test_kmeans_assignment_branches_agree_with_reference():
    X = _clustered(7, 700, 9)
    C = X[:7].copy()
    C[3] = C[1]                                             # a tie: first index wins
    aj, dj = jsens.kmeans_assignment(jnp.asarray(X), jnp.asarray(C), use_kernel=False)
    for use_kernel in (False, True):
        at, dt = tsens.kmeans_assignment(torch.from_numpy(X), torch.from_numpy(C),
                                         use_kernel=use_kernel)
        assert at.dtype == torch.int32
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        scale = float((X ** 2).sum(1).max() + (C ** 2).sum(1).max())
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5 * scale)
    assert not (at.numpy() == 3).any()


@pytest.mark.parametrize("alpha,k", [(2.0, 5), (1.5, 3)])
def test_vkmc_local_scores_match_reference_and_lemma_f2(alpha, k):
    X = _clustered(8, 1200, 10)
    centers = X[[0, 300, 600, 900, 1100][:k]]
    gj = np.asarray(jsens.vkmc_local_scores(jnp.asarray(X), jnp.asarray(centers),
                                            alpha, use_kernel=False))
    gt = tsens.vkmc_local_scores(torch.from_numpy(X), torch.from_numpy(centers),
                                 alpha, use_kernel=False)
    np.testing.assert_allclose(gt.numpy(), gj, **TOL)
    lemma = tsens.total_sensitivity_bound_vkmc(k, 1, alpha)
    assert lemma == jsens.total_sensitivity_bound_vkmc(k, 1, alpha) == 2 * (k + 1) * alpha
    assert float(gt.sum()) == pytest.approx(lemma, rel=1e-5)
    # the party stack in one call: each party's scores and its Lemma F.2 sum
    Xs = np.stack([X, X[::-1].copy()])
    Cs = np.stack([centers, centers[::-1].copy()])
    gs = tsens.vkmc_local_scores(torch.from_numpy(Xs), torch.from_numpy(Cs), alpha,
                                 use_kernel=True)
    torch.testing.assert_close(gs[0], gt, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gs.sum(1).numpy(), [lemma, lemma], rtol=1e-5)


def test_distdim_and_central_comm_cost_match_reference():
    X = _clustered(9, 1000, 13)
    jds = JDataset.from_dense(X, None, T=3)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts], None, "cpu")
    kj, kt = _key(30)
    jl, tl = JLedger(), CommLedger()
    cj = jv.distdim(kj, jds, 4, local_iters=5, global_iters=8, ledger=jl,
                    use_kernel=False)
    ct = tv.distdim(kt, tds, 4, local_iters=5, global_iters=8, ledger=tl,
                    use_kernel=False)
    _close_centers(ct.numpy(), cj)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    assert tl.total == 3 * 1000 + 4 * 13
    jl, tl = JLedger(), CommLedger()
    assert (tv.kmeans_central_comm_cost(1000, tds.dims, tl)
            == jv.kmeans_central_comm_cost(1000, jds.dims, jl) == 13_000)
    assert (tl.total_bits, tl.by_tag()) == (jl.total_bits, jl.by_tag())
