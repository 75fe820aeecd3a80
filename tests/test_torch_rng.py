"""repro_torch.rng against jax.random: bit-exact under the non-partitionable
threefry layout (the one the reference's draw pins assume).

The JAX side runs inside ``jax.threefry_partitionable(False)``, scoped to
each test by a fixture, so the setting never leaks into the JAX tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dis import _key_chain as jax_key_chain
from repro_torch import rng

SEEDS = [0, 1, 42, 123456789, 2 ** 31 - 1]


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


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _bits32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(kj), kt.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_words(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())
    for data in (0, 1, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(_words(jax.random.fold_in(kj, data)),
                                      rng.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("num", [1, 4, 7])
def test_key_chain_matches_dis(seed, num):
    from repro_torch.core.dis import _key_chain

    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_words(jax_key_chain(kj, num)),
                                  _key_chain(kt, num).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (64, 33), (2, 3, 4)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_threefry_bits(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    bj = np.asarray(jax.random.bits(kj, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(bj, rng.random_bits(kt, shape).numpy())


def test_threefry_2x32_raw_counts():
    from jax._src.prng import threefry_2x32

    counts = np.array([5, 0, 2 ** 32 - 1, 17, 123456, 9], np.uint32)
    for seed in SEEDS[:3]:
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(threefry_2x32(kj, jnp.asarray(counts)))
        got = rng.threefry_2x32(rng.PRNGKey(seed),
                                torch.as_tensor(counts.astype(np.int64)))
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
        # odd length pads with a zero counter, as jax does
        want = np.asarray(threefry_2x32(kj, jnp.asarray(counts[:5])))
        got = rng.threefry_2x32(rng.PRNGKey(seed),
                                torch.as_tensor(counts[:5].astype(np.int64)))
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_past_the_counter_limit(seed):
    """Past 2**32 - 1 words jax draws blocks of 2**32 - 1 counters under
    split subkeys.  The port's words at positions around and past the
    block edges (a full block's pad slot and the last block's among them)
    equal jax's ``threefry_2x32`` under its ``threefry_split`` subkeys,
    computed at those positions only, never as the full draw."""
    from jax._src.prng import threefry_2x32, threefry_split

    limit = 2 ** 32 - 1
    size = 3 * limit + 7
    nblocks, rem = divmod(size, limit)
    subkeys = np.asarray(threefry_split(jax.random.PRNGKey(seed), (nblocks + 1,)))
    pos = [2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32, 2 * limit + 5, size - 1,
           2 ** 31 - 1, limit + 2 ** 31 - 1, 3 * limit + 3, 0]
    want = []
    for p in pos:
        blk, off = divmod(p, limit)
        bsize = limit if blk < nblocks else rem
        half = (bsize + 1) // 2
        x1, x2, lane = (off, off + half, 0) if off < half else (off - half, off, 1)
        pair = np.array([x1, 0 if x2 >= bsize else x2], np.uint32)
        want.append(int(np.asarray(threefry_2x32(jnp.asarray(subkeys[blk]),
                                                 jnp.asarray(pair)))[lane]))
    got = rng._bits_at(rng.PRNGKey(seed), torch.tensor(pos, dtype=torch.int64), size)
    np.testing.assert_array_equal(np.array(want, np.int64), got.numpy())


@pytest.mark.parametrize("shape", [(1,), (9,), (4, 33), (101, 77)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_and_gumbel_bits(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    uj = np.asarray(jax.random.uniform(kj, shape))
    np.testing.assert_array_equal(uj.view(np.int32), _bits32(rng.uniform(kt, shape)))
    gj = np.asarray(jax.random.gumbel(kj, shape))
    np.testing.assert_array_equal(gj.view(np.int32), _bits32(rng.gumbel(kt, shape)))


def test_uniform_range():
    kj, kt = jax.random.PRNGKey(3), rng.PRNGKey(3)
    uj = np.asarray(jax.random.uniform(kj, (257,), minval=-2.0, maxval=5.0))
    ut = rng.uniform(kt, (257,), minval=-2.0, maxval=5.0)
    np.testing.assert_array_equal(uj.view(np.int32), _bits32(ut))


def test_log_is_jax_cpu_log_bitwise():
    """The gumbel double log reproduces jax's CPU float32 log bit for bit
    (over the finite inputs; NaN payloads are not compared)."""
    r = np.random.default_rng(0)
    x = np.concatenate([
        r.uniform(1e-30, 10, 20000), r.uniform(0, 1, 20000),
        np.exp(r.uniform(-87, 88, 20000)),
        [np.finfo(np.float32).tiny, 1.0, 2.0, 0.5, 3e38, 0.0, np.inf],
    ]).astype(np.float32)
    want = np.asarray(jnp.log(x))
    got = rng.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    bad = rng.log(torch.tensor([-1.0, float("nan")])).numpy()
    assert np.isnan(bad).all()


@pytest.mark.parametrize("n", [1, 7, 1000, 65537, 463715])
def test_randint(n):
    for seed in SEEDS[:3]:
        kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        want = np.asarray(jax.random.randint(kj, (513,), 0, n))
        np.testing.assert_array_equal(want, rng.randint(kt, (513,), 0, n).numpy())


@pytest.mark.parametrize("cap,n", [(1, 1), (5, 3), (33, 997), (64, 1000), (7, 1001)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_indices(seed, cap, n):
    """Full draws, including an odd cap * n (the zero-padded counter)."""
    lg = np.log(np.random.default_rng(seed).uniform(0.01, 1.0, n)).astype(np.float32)
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(kj, jnp.asarray(lg), shape=(cap,)))
    got = rng.categorical_plain(kt, torch.from_numpy(lg), cap)
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("take", [0, 1, 20, 63, 64])
def test_categorical_head_and_chunking(monkeypatch, take):
    """The first ``take`` rows of the (cap, n) draw, computed in chunks of
    any size, equal the full jax draw's rows."""
    cap, n = 64, 999
    lg = np.log(np.random.default_rng(5).uniform(0.01, 1.0, n)).astype(np.float32)
    kj, kt = jax.random.PRNGKey(9), rng.PRNGKey(9)
    full = np.asarray(jax.random.categorical(kj, jnp.asarray(lg), shape=(cap,)))
    for chunk in (1, 3, 64):
        monkeypatch.setattr(rng, "CATEGORICAL_CHUNK_ROWS", chunk)
        got = rng.categorical_plain(kt, torch.from_numpy(lg), cap, take=take)
        np.testing.assert_array_equal(full[:take], got.numpy())


def test_categorical_rejects_bad_arguments():
    kt = rng.PRNGKey(0)
    with pytest.raises(ValueError):
        rng.categorical_plain(kt, torch.zeros(2, 3), 4)
    with pytest.raises(ValueError):
        rng.categorical_plain(kt, torch.zeros(3), 4, take=5)
    with pytest.raises(ValueError):
        rng.PRNGKey(-1)
