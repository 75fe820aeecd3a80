"""The DIS draw kernel's two entry shapes (``kernels.ops.categorical``
and ``kernels.ops.categorical_parties``) and DIS with its round-1 counts on the
device.

On the CPU the plain versions are held to ``jax.random.categorical``
(non-partitionable threefry), and ``dis_plan_full`` to the reference's
and to the parent's host-sized rounds, all bit for bit: draws are
integers, and the weights are the same float32 operations in the same
order.  On a CUDA card (the ``gpu`` tests) the kernel is held to the
plain version bit for bit.

The module imports no JAX at the top, so the ``gpu`` tests run on a card
machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_categorical.py``.  The reference tests import it
inside.
"""

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core import dis as tdis
from repro_torch.kernels import categorical as kcat
from repro_torch.kernels import ops as kops

# (party logits width n, cap, counts a_j): a party with a_j = 0, cap = 1,
# n = 1, odd cap * n, take < cap, rows either side of the row-per-thread
# width, and rows long enough for several tiles
PARTY_CASES = [(37, 20, [5, 0, 15]), (1, 1, [1, 0]), (7, 3, [2]),
               (33, 9, [0, 9, 0, 0]), (101, 13, [4, 4, 5]),
               (kcat.ROW_THREAD_MAX, 5, [2, 3]), (kcat.ROW_THREAD_MAX + 1, 5, [3, 1]),
               (999, 7, [0, 0, 7])]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax():
    """JAX on the CPU in the non-partitionable threefry layout, scoped to
    the test."""
    jax = pytest.importorskip("jax")
    with jax.threefry_partitionable(False):
        yield jax


def _logits(seed, T, n):
    u = np.random.default_rng(seed).uniform(0.01, 1.0, (T, n))
    return np.log(u).astype(np.float32)


def _keys(seed, T):
    return rng.split(rng.PRNGKey(seed), T)


@pytest.mark.parametrize("n,cap,counts", PARTY_CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_categorical_parties_equals_party_heads_and_jax(jax, seed, n, cap, counts):
    T = len(counts)
    lg = _logits(seed * 31 + n, T, n)
    keys = _keys(seed, T)
    a = torch.tensor(counts, dtype=torch.int64)
    got = kops.categorical_parties(keys, torch.from_numpy(lg), cap, a, total=sum(counts))
    heads = [kops.categorical(keys[j], torch.from_numpy(lg[j]), cap, take=counts[j])
             for j in range(T)]
    np.testing.assert_array_equal(got.numpy(), torch.cat(heads).numpy())
    want = [np.asarray(jax.random.categorical(
                jax.numpy.asarray(keys[j].numpy().astype(np.uint32)),
                jax.numpy.asarray(lg[j]), shape=(cap,)))[:counts[j]]
            for j in range(T)]
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))


def _parent_plan(key, scores, m):
    """The parent's DIS rounds: round-1 counts by ``bincount``, read on
    the host to size each party's round-2 head."""
    T = scores.shape[0]
    subs = tdis._key_chain(key, T + 1)
    G_j = torch.sum(scores, dim=1)
    draws = rng.categorical_plain(subs[0], rng.log(torch.clamp_min(G_j, 1e-30)), m)
    a = torch.bincount(draws, minlength=T)
    logits = rng.log(torch.clamp_min(scores, 1e-30))
    S = torch.cat([rng.categorical_plain(subs[1 + j], logits[j], m, take=int(a[j]))
                   for j in range(T)])
    g_sum_S = torch.zeros((m,), dtype=scores.dtype)
    for j in range(T):
        g_sum_S = g_sum_S + scores[j][S]
    return S, G_j.sum() / (m * torch.clamp_min(g_sum_S, 1e-30)), a


@pytest.mark.parametrize("T,n,m", [(3, 500, 64), (2, 1001, 7), (4, 257, 129),
                                   (1, 33, 5), (3, 80, 1)])
def test_dis_plan_full_device_counts_equal_parent_and_reference(jax, T, n, m):
    from repro.core import dis as jdis

    r = np.random.default_rng(T * 1000 + n)
    sc = (r.uniform(0.0, 1.0, (T, n)) ** 3 + 1.0 / n).astype(np.float32)
    key = rng.PRNGKey(m)
    plan = tdis.dis_plan_full(key, torch.from_numpy(sc), m)
    S, w, a = _parent_plan(key, torch.from_numpy(sc), m)
    assert plan.counts.dtype == torch.int64
    assert torch.equal(plan.indices, S) and torch.equal(plan.counts, a)
    assert torch.equal(plan.weights, w)
    jp = jdis.dis_plan_full(jax.numpy.asarray(key.numpy().astype(np.uint32)),
                            jax.numpy.asarray(sc), m)
    np.testing.assert_array_equal(np.asarray(jp.indices), plan.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jp.counts), plan.counts.numpy())


@pytest.mark.parametrize("size", [1, 2 ** 32 - 2, 2 ** 32 - 1, 3 * (2 ** 32 - 1) + 7])
def test_block_keys_are_the_split_keys(size):
    keys = _keys(3, 4)
    table = rng.block_keys(keys, size)
    nblocks = size // rng.MASK
    assert table.shape == (4, nblocks + 1, 2) and table.dtype == torch.int64
    for j in range(4):
        want = keys[j][None] if nblocks == 0 else rng.split(keys[j], nblocks + 1)
        assert torch.equal(table[j], want)


@pytest.mark.parametrize("rows,n", [(1, 463_715), (5000, 463_715), (1000, 463_715),
                                    (9263, 463_715), (3, 65), (5000, 3), (1, 1),
                                    (64, 999), (2, 257)])
def test_launch_shape_covers_every_column(rows, n):
    tiles, cols = kcat.launch_shape(rows, n)
    if n <= kcat.ROW_THREAD_MAX:
        assert (tiles, cols) == (0, n)
        return
    assert 1 <= tiles <= -(-n // 256)
    assert (tiles - 1) * cols < n <= tiles * cols      # no tile is empty
    assert rows * tiles >= min(kcat.TARGET_CTAS, rows * -(-n // 256))


def test_categorical_parties_rejects_bad_arguments():
    keys, lg = _keys(0, 2), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="share T"):
        kops.categorical_parties(keys, lg, 4, torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="shape"):
        kops.categorical_parties(keys[0], lg, 4, torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="total"):
        kops.categorical_parties(keys, lg, 4, torch.tensor([1, 2]), total=4)
    with pytest.raises(ValueError, match="take"):
        kops.categorical_parties(keys, lg, 4, torch.tensor([1, 5]))


# --------------------------------------------------------------------------
# On the card: the kernel against the plain version, bit for bit
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,cap,counts", PARTY_CASES + [
    (100_003, 3, [1, 2, 0]), (463_715, 1, [1])])
def test_categorical_kernel_equals_plain(n, cap, counts):
    dev = _cuda()
    T = len(counts)
    lg = torch.from_numpy(_logits(n + cap, T, n))
    keys = _keys(n, T)
    a = torch.tensor(counts, dtype=torch.int64)
    want = rng.categorical_parties_plain(keys, lg, cap, a)
    before = kcat.categorical.launches
    got = kops.categorical_parties(keys.to(dev), lg.to(dev), cap, a.to(dev),
                                  total=sum(counts))
    again = kops.categorical_parties(keys.to(dev), lg.to(dev), cap, a.to(dev),
                                    total=sum(counts))
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    for j in range(T):                                       # one stream
        one = kops.categorical(keys[j].to(dev), lg[j].to(dev), cap, take=counts[j])
        assert torch.equal(one.cpu(), rng.categorical_plain(keys[j], lg[j], cap, counts[j]))
    launched = 2 + sum(1 for c in counts if c)
    assert kcat.categorical.launches == before + launched


@pytest.mark.gpu
def test_categorical_kernel_past_the_counter_limit():
    """A draw of more than 2**32 - 1 words: rows on both sides of the
    first block edge and the last row, against the plain rows."""
    dev = _cuda()
    n, cap = 1024, 4_194_305                                  # cap * n > 2**32 - 1
    lg = torch.from_numpy(_logits(5, 1, n)[0])
    key = rng.PRNGKey(17)
    got = kops.categorical(key.to(dev), lg.to(dev), cap).cpu()
    for r in (0, 1, rng.MASK // n - 1, rng.MASK // n, cap - 1):
        pos = r * n + torch.arange(n, dtype=torch.int64)
        row = rng._gumbel_of(rng._bits_at(key, pos, cap * n)) + lg
        assert int(got[r]) == int(torch.argmax(row)), r


@pytest.mark.gpu
def test_categorical_parties_replays_in_a_cuda_graph():
    """Captured once, the launch reads new counts from the device on
    every replay."""
    dev = _cuda()
    T, n, cap, m = 3, 5000, 40, 40
    lg = torch.from_numpy(_logits(1, T, n)).to(dev)
    keys = _keys(2, T).to(dev)
    counts = torch.tensor([10, 20, 10], dtype=torch.int64, device=dev)
    kops.categorical_parties(keys, lg, cap, counts, total=m)   # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kops.categorical_parties(keys, lg, cap, counts, total=m)
    for c in ([10, 20, 10], [0, 0, 40], [40, 0, 0], [13, 14, 13]):
        counts.copy_(torch.tensor(c))
        graph.replay()
        want = rng.categorical_parties_plain(keys.cpu(), lg.cpu(), cap, torch.tensor(c))
        assert torch.equal(out.cpu(), want), c
