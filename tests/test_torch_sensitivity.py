"""Algorithm 2's scoring in the port against the reference (``backend="ref"``
on the JAX side, the plain path on the CPU here).

Tolerance: both sides are fp32, but ``jnp.linalg.eigh`` and
``torch.linalg.eigh`` are different LAPACK paths, so the pseudo-inverse
agrees only to about 1e-4 of its largest entry on these Grams; it enters
the scores through a quadratic form, where the observed gap is at most
3.1e-5 relative (on small leverages).  Scores (leverage in [0, 1] plus
1/n) are held at ``rtol=1e-4, atol=1e-7``, the pinv at ``1e-3`` of its
largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import VFLDataset as JDataset
from repro.core import sensitivity as jsens
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import sensitivity as tsens

SCORE_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n, d, T=3):
    r = np.random.default_rng(seed)
    X = r.standard_normal((n, d)).astype(np.float32) * r.uniform(0.5, 3.0, d).astype(np.float32)
    y = (X @ r.standard_normal(d).astype(np.float32)
         + 0.3 * r.standard_normal(n).astype(np.float32))
    return X, y


@pytest.mark.parametrize("n,d,T", [(300, 12, 3), (501, 9, 2), (257, 10, 4), (64, 3, 3)])
def test_vrlr_scores_stacked_matches_reference(n, d, T):
    X, y = _data(n + d, n, d, T)
    jds = JDataset.from_dense(X, y, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts], np.asarray(jds.y), "cpu")
    jb = jds.stacked(with_labels=True)
    tb = tds.stacked(with_labels=True)
    np.testing.assert_array_equal(np.asarray(jb.blocks), tb.blocks.numpy())
    np.testing.assert_array_equal(np.asarray(jb.mask), tb.mask.numpy())
    assert jb.dims == tb.dims
    want = np.asarray(jsens.vrlr_scores_stacked(jb.blocks, use_kernel=False))
    for use_kernel in (False, True):   # on the CPU both take the plain path
        got = tsens.vrlr_scores_stacked(tb.blocks, use_kernel=use_kernel).numpy()
        np.testing.assert_allclose(got, want, **SCORE_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_gram_pinv_and_conditioning(seed):
    r = np.random.default_rng(seed)
    B = r.standard_normal((3, 200, 6)).astype(np.float32)
    B[1, :, 4:] = 0.0                        # padded columns: width 4
    B[2, :, 2] = B[2, :, 1]                  # duplicated feature: rank deficit
    G = np.einsum("tns,tnu->tsu", B, B)
    jM, jc = jsens.batched_gram_pinv(jnp.asarray(G), return_cond=True,
                                     expected_rank=[6, 4, 6])
    tM, tc = tsens.batched_gram_pinv(torch.from_numpy(G), return_cond=True,
                                     expected_rank=[6, 4, 6])
    scale = np.abs(np.asarray(jM)).max()
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=1e-3, atol=1e-3 * scale)
    jc, tc = np.asarray(jc), tc.numpy()
    assert np.isinf(jc[2]) and np.isinf(tc[2])
    np.testing.assert_allclose(tc[:2], jc[:2], rtol=1e-3)
    M_only = tsens.batched_gram_pinv(torch.from_numpy(G))
    assert torch.equal(M_only, tM)


def test_batched_gram_pinv_all_zero_gram_inverts_to_zero():
    G = np.zeros((2, 3, 3), np.float32)
    G[0] = np.eye(3)
    M, cond = tsens.batched_gram_pinv(torch.from_numpy(G), return_cond=True)
    assert torch.equal(M[1], torch.zeros(3, 3))
    assert np.isinf(cond[1].item()) and cond[0].item() == pytest.approx(1.0)


@pytest.mark.parametrize("n,d", [(120, 5), (333, 8), (50, 1)])
def test_leverage_and_local_scores_match_reference(n, d):
    X, y = _data(7 * n + d, n, d)
    want = np.asarray(jsens.leverage_scores(X, use_kernel=False))
    got = tsens.leverage_scores(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    want = np.asarray(jsens.vrlr_local_scores(jnp.asarray(X), jnp.asarray(y),
                                              use_kernel=False))
    got = tsens.vrlr_local_scores(torch.from_numpy(X), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, **SCORE_TOL)
    np.testing.assert_allclose(tsens.norm_scores(torch.from_numpy(X)).numpy(),
                               np.asarray(jsens.norm_scores(X)), rtol=1e-6)


def test_leverage_scores_sum_to_rank_when_rank_deficient():
    X, _ = _data(3, 80, 4)
    X = np.concatenate([X, X[:, :2]], axis=1)             # rank 4, d = 6
    lev = tsens.leverage_scores(torch.from_numpy(X)).numpy()
    assert np.all(lev >= 0) and np.all(lev <= 1)
    np.testing.assert_allclose(lev.sum(), 4.0, rtol=1e-2)
