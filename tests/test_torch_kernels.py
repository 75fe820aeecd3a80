"""The port's kernels: plain versions against the reference's oracles and
its Pallas kernels (interpret mode on the CPU), and — on a CUDA card only —
the hand-written kernels against their plain versions.

Tolerances: every comparison is fp32 against fp32 with another summation
order, so ``rtol=1e-5`` with an ``atol`` per case, scaled to the largest
magnitude the sum can reach (a few fp32 ulps of it).

The module imports no JAX at the top, so the ``gpu`` tests run on a card
machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``.  The reference tests import it inside.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import leverage as klev
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_gram as kwg

# (batch dims of X, batch dims of the second operand, n, d)
LEV_CASES = [((), (), 1, 1), ((), (), 7, 1), ((), (), 37, 5), ((), (), 513, 16),
             ((3,), (), 129, 8), ((), (2,), 65, 9), ((3,), (3,), 301, 31),
             ((2,), (2,), 1, 4)]
GRAM_CASES = [((), (), 1, 1), ((), (), 7, 1), ((), (), 37, 5), ((), (), 600, 12),
              ((3,), (), 129, 8), ((), (2,), 65, 9), ((3,), (3,), 301, 31),
              ((2,), (2,), 1, 3)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name):
    """A module of the JAX reference package (needs JAX, which the CPU
    test environment has)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"repro.kernels.{name}")


def _psd(r, batch, d):
    A = r.standard_normal(batch + (d, d)).astype(np.float32)
    return (A @ np.swapaxes(A, -1, -2) / d).astype(np.float32)


def _lev_inputs(seed, xb, mb, n, d):
    r = np.random.default_rng(seed)
    return r.standard_normal(xb + (n, d)).astype(np.float32), _psd(r, mb, d)


def _gram_inputs(seed, xb, wb, n, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal(xb + (n, d)).astype(np.float32),
            r.uniform(0.0, 3.0, wb + (n,)).astype(np.float32))


@pytest.mark.parametrize("xb,mb,n,d", LEV_CASES)
def test_leverage_plain_matches_reference(xb, mb, n, d):
    jref, jlev = _reference("ref"), _reference("leverage")
    X, M = _lev_inputs(n + d, xb, mb, n, d)
    got = ref.leverage(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    atol = 1e-6 * (np.abs(X) ** 2).sum(-1).max() * np.abs(M).max()
    np.testing.assert_allclose(got, np.asarray(jref.leverage(X, M)),
                               rtol=1e-5, atol=atol)
    pallas = np.asarray(jlev.leverage(X, M, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("xb,wb,n,d", GRAM_CASES)
def test_weighted_gram_plain_matches_reference(xb, wb, n, d):
    jref, jwg = _reference("ref"), _reference("weighted_gram")
    X, w = _gram_inputs(n * 3 + d, xb, wb, n, d)
    got = ref.weighted_gram(torch.from_numpy(X), torch.from_numpy(w)).numpy()
    scale = np.asarray(jref.weighted_gram(np.abs(X), w)).max()
    atol = 1e-6 * max(scale, 1.0)
    np.testing.assert_allclose(got, np.asarray(jref.weighted_gram(X, w)),
                               rtol=1e-5, atol=atol)
    pallas = np.asarray(jwg.weighted_gram(X, w, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)


def test_cpu_tensors_take_the_plain_version_without_launching():
    X, M = _lev_inputs(0, (3,), (3,), 50, 6)
    Xt, Mt = torch.from_numpy(X), torch.from_numpy(M)
    before = (klev.leverage.launches, kwg.weighted_gram.launches)
    assert torch.equal(klev.leverage(Xt, Mt), klev.plain(Xt, Mt))
    assert torch.equal(ops.leverage(Xt, Mt), ref.leverage(Xt, Mt))
    w = torch.ones(50)
    assert torch.equal(kwg.weighted_gram(Xt, w), kwg.plain(Xt, w))
    assert torch.equal(ops.weighted_gram(Xt, w, use_kernel=False),
                       ref.weighted_gram(Xt, w))
    assert (klev.leverage.launches, kwg.weighted_gram.launches) == before


def test_row_split_is_a_function_of_n():
    assert kwg.row_split(1) == (kwg.MIN_ROWS, 1)
    assert kwg.row_split(5000) == (256, 20)
    rows, P = kwg.row_split(463_715)
    assert P <= kwg.TARGET_CTAS and rows * P >= 463_715 > rows * (P - 1)


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xb,mb,n,d", LEV_CASES + [((), (), 4097, 238), ((3,), (3,), 100_003, 31)])
def test_leverage_kernel_matches_plain(xb, mb, n, d):
    dev = _cuda()
    X, M = (torch.from_numpy(a).to(dev) for a in _lev_inputs(n + d, xb, mb, n, d))
    before = klev.leverage.launches
    got = klev.leverage(X, M)
    again = klev.leverage(X, M)
    assert klev.leverage.launches == before + 2
    want = klev.plain(X, M)
    assert torch.equal(got, again)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("xb,wb,n,d", GRAM_CASES + [((), (), 20_001, 90), ((), (), 777, 200)])
def test_weighted_gram_kernel_matches_plain_and_is_deterministic(xb, wb, n, d):
    dev = _cuda()
    X, w = (torch.from_numpy(a).to(dev) for a in _gram_inputs(n * 3 + d, xb, wb, n, d))
    before = kwg.weighted_gram.launches
    got = kwg.weighted_gram(X, w)
    again = kwg.weighted_gram(X, w)
    assert kwg.weighted_gram.launches == before + 2
    assert torch.equal(got, again)
    want = kwg.plain(X, w)
    scale = kwg.plain(X.abs(), w.abs()).max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1.0))


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    with pytest.raises(ValueError):
        klev.leverage(torch.zeros(4, 239, device=dev), torch.zeros(239, 239, device=dev))
    with pytest.raises(ValueError):
        klev.leverage(torch.zeros(2, 4, 3, device=dev), torch.zeros(3, 3, 3, device=dev))
    with pytest.raises(ValueError):
        kwg.weighted_gram(torch.zeros(4, 3, device=dev), torch.zeros(5, device=dev))
    with pytest.raises(ValueError):
        kwg.weighted_gram(torch.zeros(4, 3, device=dev), torch.zeros(4))
