"""DIS (Algorithm 1), its bill and the health report: the port against the
reference on shared inputs.

Given the same (T, n) scores and key, the draws are exact (indices and
counts equal).  Per-party totals and weights are fp32 sums taken in
another order by XLA's reduction and torch's, so they are held at
``rtol=1e-6``.  Ledger units, bits and the health report are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core import dis as jdis
from repro.core import integrity as jint
from repro.core import wire as jwire
from repro_torch import rng
from repro_torch.convert import key_from_numpy
from repro_torch.core import comm as tcomm
from repro_torch.core import dis as tdis
from repro_torch.core import integrity as tint
from repro_torch.core import wire as twire


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


def _scores(seed, T, n):
    r = np.random.default_rng(seed)
    s = r.uniform(0.0, 1.0, (T, n)).astype(np.float32) ** 3 + 1.0 / n
    s[:, r.integers(0, n, 3)] *= 50.0                         # a few heavy rows
    return s.astype(np.float32)


@pytest.mark.parametrize("T,n,m", [(3, 500, 64), (2, 1001, 7), (4, 257, 129),
                                   (1, 33, 5), (3, 1500, 400)])
@pytest.mark.parametrize("seed", [0, 3])
def test_dis_plan_full_exact_draws_on_shared_scores(seed, T, n, m):
    sc = _scores(seed * 100 + n, T, n)
    kj = jax.random.PRNGKey(seed)
    jp = jdis.dis_plan_full(kj, jnp.asarray(sc), m)
    tp = tdis.dis_plan_full(key_from_numpy(np.asarray(kj), "cpu"),
                            torch.from_numpy(sc), m)
    np.testing.assert_array_equal(np.asarray(jp.indices), tp.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jp.counts), tp.counts.numpy())
    assert int(tp.counts.sum()) == m
    np.testing.assert_allclose(tp.totals.numpy(), np.asarray(jp.totals), rtol=1e-6)
    np.testing.assert_allclose(tp.weights.numpy(), np.asarray(jp.weights), rtol=1e-6)


@pytest.mark.parametrize("n,m", [(1, 1), (100, 7), (463_715, 64)])
def test_uniform_plan_exact(n, m):
    kj = jax.random.PRNGKey(n)
    jS, jw = jdis.uniform_plan(kj, n, m)
    tS, tw = tdis.uniform_plan(rng.PRNGKey(n), n, m)
    np.testing.assert_array_equal(np.asarray(jS), tS.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


def test_split_uploads_matches_reference():
    idx = np.arange(10) * 3
    counts = np.array([4, 0, 6])
    want = jdis.split_uploads(idx, counts)
    got = tdis.split_uploads(torch.from_numpy(idx), torch.from_numpy(counts))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdis.split_uploads(torch.arange(5), torch.tensor([1, 1]))


def _ledger_view(led):
    return (led.total, led.total_bits, led.by_tag(), led.by_tag(bits=True),
            [dataclasses.astuple(m) for m in led.messages])


@pytest.mark.parametrize("T,m,counts", [(3, 10, [4, 0, 6]), (1, 5, [5]),
                                        (4, 1000, [1, 2, 3, 994])])
def test_comm_schedules_equal_reference(T, m, counts):
    payload = ("float32", (1001,))
    jpl = jwire.WirePayload.of(payload[1], payload[0], "raw_fp32")
    tpl = twire.WirePayload.of(payload[1], payload[0], "raw_fp32")
    assert dataclasses.astuple(jpl) == dataclasses.astuple(tpl)
    pairs = [
        (jcomm.CommSchedule.dis(T, m, counts, round1_payload=jpl),
         tcomm.CommSchedule.dis(T, m, counts, round1_payload=tpl)),
        (jcomm.CommSchedule.dis(T, m, counts),
         tcomm.CommSchedule.dis(T, m, counts)),
        (jcomm.CommSchedule.dis_round1(T) + jcomm.CommSchedule.dis_rounds23(T, m, counts),
         tcomm.CommSchedule.dis_round1(T) + tcomm.CommSchedule.dis_rounds23(T, m, counts)),
        (jcomm.CommSchedule.materialize(T, m), tcomm.CommSchedule.materialize(T, m)),
        (jcomm.CommSchedule.uniform(T, m), tcomm.CommSchedule.uniform(T, m)),
    ]
    for js, ts in pairs:
        assert (js.total, js.total_bits) == (ts.total, ts.total_bits)
        jl, tl = jcomm.CommLedger(), tcomm.CommLedger()
        js.record(jl)
        ts.record(tl)
        assert _ledger_view(jl) == _ledger_view(tl)
        assert jl.summary() == tl.summary()
    assert tcomm.CommSchedule.dis_total(T, m) == jcomm.CommSchedule.dis_total(T, m)
    with pytest.raises(ValueError):
        tcomm.CommSchedule.dis_rounds23(T, m + 1, counts)


def test_ledger_mark_rollback_since():
    led = tcomm.CommLedger()
    tcomm.CommSchedule.dis_round1(3).record(led)
    mark = led.mark()
    tcomm.CommSchedule.materialize(3, 8).record(led)
    assert led.since(mark) == 48 and led.since(mark, bits=True) == 48 * 32
    led.rollback(mark)
    assert led.total == 6 and tcomm.null_ledger(None).total == 0
    with pytest.raises(ValueError):
        led.send("x", "a", "b", -1)


@pytest.mark.parametrize("kind", ["clean", "nonfinite", "zero_party", "conds"])
def test_health_from_masses_equals_reference(kind):
    sc = _scores(11, 3, 64).astype(np.float64)
    conds = None
    if kind == "nonfinite":
        sc[1, 5] = np.nan
    elif kind == "zero_party":
        sc[2] = 0.0
    elif kind == "conds":
        conds = np.array([3.0, np.inf, 1e9])
    want = jint.health_from_masses(sc, gram_conds=conds)
    got = tint.health_from_masses(sc, gram_conds=conds)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.describe() == want.describe()
    assert got.healthy == want.healthy


@pytest.mark.parametrize("codec", ["raw_fp32", "fp16", "int8_blockscale", "delta_varint"])
def test_wire_codecs_pack_the_same_bytes(codec):
    r = np.random.default_rng(1)
    fl = r.uniform(0, 5, 333).astype(np.float32)
    ints = r.integers(0, 10 ** 6, 77).astype(np.int32)
    jc, tc = jwire.get_codec(codec), twire.get_codec(codec)
    for a in (fl, ints):
        assert jc.encode(a) == tc.encode(a)
        assert jc.wire_bits(a.shape, a.dtype) == tc.wire_bits(a.shape, a.dtype)
    assert twire.fmt_bits(12345678) == jwire.fmt_bits(12345678)
