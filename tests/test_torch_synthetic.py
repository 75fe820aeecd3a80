"""The port's synthetic datasets (``repro_torch.data.synthetic``) and the
normal draw they need (``repro_torch.rng.normal``), on the CPU.

- ``rng.normal`` is ``jax.random.normal`` bit for bit (0 differing words):
  at several keys, odd and even sizes, a size of one and of zero, and
  across its position chunks.  Its pieces, ``rng.log1p`` and
  ``rng.erf_inv``, are ``jnp.log1p`` and ``lax.erf_inv`` bit for bit on
  their whole input range.
- ``year_prediction_like`` and ``kc_house_like`` against the reference's at
  small n: X within ``atol=1e-5`` (it sums ``Z @ W`` in a library's order;
  its entries are O(1) to O(10)), ``y`` within ``rtol=1e-6`` (YearPrediction,
  values near 2000) and ``rtol=1e-5`` (KC-House, through ``exp``).
- ``correlated_vfl_data``: the cluster assignment (``randint``) exact, and
  X exact too (elementwise float32 from the same words).
- ``device="cuda"`` without a card raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as J
from repro_torch import rng
from repro_torch.data import correlated_vfl_data, kc_house_like, year_prediction_like

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("seed,shape", [
    (0, (1001, 7)), (1, (4096,)), (42, (333, 333)), (7, (4, 5, 6)),
    (123, (1,)), (5, (0,)), (2 ** 32 - 7, (77, 90)),
])
def test_normal_bit_for_bit(seed, shape):
    ref = jax.random.normal(jax.random.PRNGKey(seed), shape)
    got = rng.normal(rng.PRNGKey(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(_bits(got.numpy()), _bits(ref))


def test_normal_across_position_chunks(monkeypatch):
    """A draw made a few thousand positions at a time is the whole draw:
    each word depends on its own flat position."""
    monkeypatch.setattr(rng, "NORMAL_CHUNK", 1000)
    shape = (2501, 3)                   # 7503 words: 8 chunks, the last ragged
    ref = jax.random.normal(jax.random.PRNGKey(9), shape)
    assert np.array_equal(_bits(rng.normal(rng.PRNGKey(9), shape).numpy()), _bits(ref))


def test_normal_tails_bit_for_bit():
    """A million draws reach |z| > 4.5, where erf_inv's sqrt branch runs."""
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (1_000_003,)))
    got = rng.normal(rng.PRNGKey(11), (1_000_003,)).numpy()
    assert np.abs(ref).max() > 4.5
    assert np.array_equal(_bits(got), _bits(ref))


def test_log1p_and_erf_inv_bit_for_bit():
    r = np.random.default_rng(0)
    x = np.concatenate([-(r.uniform(0, 1, 200_000) ** 2), -np.linspace(0, 1, 20_001),
                        r.uniform(-0.5, 3.0, 50_000), [0.0, -0.0, np.inf, -1.0]]
                       ).astype(np.float32)
    assert np.array_equal(_bits(rng.log1p(torch.from_numpy(x)).numpy()),
                          _bits(jnp.log1p(x)))
    u = np.concatenate([r.uniform(-1, 1, 200_000),
                        np.nextafter(np.float32(1), np.float32(0)) - r.uniform(0, 1e-3, 20_000),
                        [-1.0, 1.0, 0.0]]).astype(np.float32)
    assert np.array_equal(_bits(rng.erf_inv(torch.from_numpy(u)).numpy()),
                          _bits(jax.lax.erf_inv(u)))


@pytest.mark.parametrize("seed", [7, 11])
def test_year_prediction_like_matches_reference(seed):
    Xj, yj = J.year_prediction_like(jax.random.PRNGKey(seed), n=3001)
    X, y = year_prediction_like(rng.PRNGKey(seed), n=3001, device=CPU)
    assert tuple(X.shape) == (3001, 90) and tuple(y.shape) == (3001,)
    assert X.dtype == y.dtype == torch.float32
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6)


def test_kc_house_like_matches_reference():
    Xj, yj = J.kc_house_like(jax.random.PRNGKey(3), n=2000)
    X, y = kc_house_like(rng.PRNGKey(3), n=2000, device=CPU)
    assert tuple(X.shape) == (2000, 18)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5)


@pytest.mark.parametrize("cc,k", [(0.7, 0), (0.3, 8), (1.0, 5), (-0.5, 3)])
def test_correlated_vfl_data_matches_reference(cc, k):
    key = jax.random.PRNGKey(5)
    Xj = J.correlated_vfl_data(key, 2001, 12, 3, cross_correlation=cc, k_clusters=k)
    X = correlated_vfl_data(rng.PRNGKey(5), 2001, 12, 3, cross_correlation=cc,
                            k_clusters=k, device=CPU)
    assert np.array_equal(_bits(X.numpy()), _bits(Xj))
    if k:
        kz = jax.random.split(key, 4)[3]
        assign = rng.randint(rng.split(rng.PRNGKey(5), 4)[3], (2001,), 0, k)
        np.testing.assert_array_equal(assign.numpy(),
                                      np.asarray(jax.random.randint(kz, (2001,), 0, k)))


def test_generators_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: year_prediction_like(rng.PRNGKey(0), n=10),
               lambda: kc_house_like(rng.PRNGKey(0), n=10),
               lambda: correlated_vfl_data(rng.PRNGKey(0), 10, 4, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
