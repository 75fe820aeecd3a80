"""The small pieces of the core the two slices left out, against the
reference on shared inputs: the DIS cost bounds, Theorem 4.2's total
sensitivity, ``standardize``, the ``m_cap`` capacity of DIS and of the
uniform plan, the seed API (``dis_sample``, ``uniform_sample``,
``dis_marginals``), the coreset ratios, and the spec's ``m_cap``,
``replace`` and ``describe``; and the seed-era builders' deprecation shims
(``tests/test_api.py``'s: the same key gives ``build_coreset``'s indices,
weights and bill, with the reference's warning text).

Integers, draws and bills are exact.  Float results are fp32 sums taken in
another order by XLA and torch: weights and standardized values at
``rtol=1e-6`` (with an absolute floor of 1e-6 of the data's scale for the
standardized values, which cross zero), the coreset ratios at
``rtol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import CommLedger as JLedger
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core import comm as jcomm
from repro.core import coreset as jcoreset
from repro.core import dis as jdis
from repro.core import sensitivity as jsens
from repro.core import vfl as jvfl
from repro_torch.convert import coreset_from_numpy, dataset_from_numpy, key_from_numpy
from repro_torch.core import CommLedger, CoresetSpec, build_coreset, compile_plan
from repro_torch.core import comm as tcomm
from repro_torch.core import coreset as tcoreset
from repro_torch.core import dis as tdis
from repro_torch.core import sensitivity as tsens
from repro_torch.core import vfl as tvfl


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


def _datasets(seed, n=600, d=10, T=3, labels=True):
    r = np.random.default_rng(seed)
    X = (3.0 * r.standard_normal((n, d)) + r.uniform(-5, 5, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + r.standard_normal(n)).astype(np.float32)
    jds = JDataset.from_dense(X, y if labels else None, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts],
                             np.asarray(jds.y) if labels else None, "cpu")
    return jds, tds


def _tkey(kj):
    return key_from_numpy(np.asarray(kj), "cpu")


@pytest.mark.parametrize("m,T", [(1, 1), (64, 3), (5000, 3), (17, 8)])
def test_cost_bounds_exact(m, T):
    assert tcomm.theoretical_dis_cost(m, T) == jcomm.theoretical_dis_cost(m, T)
    lo, hi = tcomm.theoretical_dis_cost(m, T)
    assert lo <= tcomm.CommSchedule.dis_total(T, m) <= hi


@pytest.mark.parametrize("dims", [(30, 30, 30), (4, 4), (1,), (7, 0, 12)])
def test_total_sensitivity_bound_vrlr_exact(dims):
    T = len(dims)
    got = tsens.total_sensitivity_bound_vrlr(dims, T)
    assert got == jsens.total_sensitivity_bound_vrlr(dims, T)
    assert isinstance(got, float)


@pytest.mark.parametrize("seed", [0, 1])
def test_standardize_matches_reference(seed):
    jds, tds = _datasets(seed)
    # a constant column takes the eps floor: (x - mu) / eps = 0 there
    parts = [np.asarray(p).copy() for p in jds.parts]
    parts[1][:, 2] = 7.25
    jds = JDataset([jnp.asarray(p) for p in parts], jds.y)
    tds = dataset_from_numpy(parts, np.asarray(jds.y), "cpu")
    jz, tz = jvfl.standardize(jds), tvfl.standardize(tds)
    assert tz.dims == tuple(jz.dims) and tz.device == tds.device
    jparts, jy = jvfl.as_numpy(jz)
    tparts, ty = tvfl.as_numpy(tz)
    for jp, tp in zip(jparts, tparts):
        assert isinstance(tp, np.ndarray) and tp.dtype == np.float32
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-6 * np.abs(jp).max())
    np.testing.assert_array_equal(tparts[1][:, 2], 0.0)
    np.testing.assert_array_equal(ty, jy)
    # ddof = 0, as jnp.std: each standardized column has unit population std
    np.testing.assert_allclose(tparts[0].std(axis=0), 1.0, rtol=1e-5)


@pytest.mark.parametrize("T,n,m,m_cap", [(3, 500, 40, 64), (2, 1001, 7, 30),
                                         (4, 257, 129, 129), (1, 33, 1, 5),
                                         (3, 1500, 100, 400)])
def test_dis_plan_full_with_m_cap_matches_reference(T, n, m, m_cap):
    sc = _scores(n + m, T, n)
    kj = jax.random.PRNGKey(m_cap)
    jp = jdis.dis_plan_full(kj, jnp.asarray(sc), m, m_cap=m_cap)
    tp = tdis.dis_plan_full(_tkey(kj), torch.from_numpy(sc), m, m_cap=m_cap)
    assert tp.indices.shape == tp.weights.shape == (m_cap,)
    np.testing.assert_array_equal(np.asarray(jp.indices), tp.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jp.counts), tp.counts.numpy())
    assert int(tp.counts.sum()) == m
    np.testing.assert_array_equal(tp.indices[m:].numpy(), 0)
    np.testing.assert_array_equal(tp.weights[m:].numpy(), 0.0)
    assert bool((tp.weights[:m] > 0).all())
    np.testing.assert_allclose(tp.weights.numpy(), np.asarray(jp.weights), rtol=1e-6)
    # at m == m_cap the capacity plan is the eager plan
    eager = tdis.dis_plan_full(_tkey(kj), torch.from_numpy(sc), m)
    if m == m_cap:
        assert torch.equal(eager.indices, tp.indices)
    # dis_plan is the same core without its counts
    S, w = tdis.dis_plan(_tkey(kj), torch.from_numpy(sc), m, m_cap=m_cap)
    assert torch.equal(S, tp.indices) and torch.equal(w, tp.weights)


def test_dis_plan_full_takes_given_totals():
    sc = _scores(5, 3, 400)
    kj = jax.random.PRNGKey(9)
    totals = sc.sum(axis=1).astype(np.float32) * np.float32(1.5)
    jp = jdis.dis_plan_full(kj, jnp.asarray(sc), 50, totals=jnp.asarray(totals))
    tp = tdis.dis_plan_full(_tkey(kj), torch.from_numpy(sc), 50,
                            totals=torch.from_numpy(totals))
    np.testing.assert_array_equal(np.asarray(jp.indices), tp.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jp.counts), tp.counts.numpy())
    np.testing.assert_array_equal(tp.totals.numpy(), totals)
    np.testing.assert_allclose(tp.weights.numpy(), np.asarray(jp.weights), rtol=1e-6)
    with pytest.raises(ValueError, match="m_cap"):
        tdis.dis_plan_full(_tkey(kj), torch.from_numpy(sc), 51, m_cap=50)


@pytest.mark.parametrize("n,m,m_cap", [(100, 7, 7), (100, 7, 20), (463_715, 64, 100)])
def test_uniform_plan_with_m_cap_exact(n, m, m_cap):
    kj = jax.random.PRNGKey(n + m_cap)
    jS, jw = jdis.uniform_plan(kj, n, m, m_cap=m_cap)
    tS, tw = tdis.uniform_plan(_tkey(kj), n, m, m_cap=m_cap)
    np.testing.assert_array_equal(np.asarray(jS), tS.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


@pytest.mark.parametrize("T,n,m", [(3, 500, 64), (2, 77, 5)])
def test_dis_sample_and_uniform_sample_draws_and_bills(T, n, m):
    sc = _scores(T * n, T, n)
    kj = jax.random.PRNGKey(T + m)
    jl, tl = JLedger(), CommLedger()
    jS, jw = jdis.dis_sample(kj, [jnp.asarray(g) for g in sc], m, ledger=jl)
    tS, tw = tdis.dis_sample(_tkey(kj), [torch.from_numpy(g) for g in sc], m,
                             ledger=tl)
    np.testing.assert_array_equal(np.asarray(jS), tS.numpy())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    assert tl.total == tcomm.CommSchedule.dis_total(T, m)
    jl, tl = JLedger(), CommLedger()
    jS, jw = jdis.uniform_sample(kj, n, m, T, ledger=jl)
    tS, tw = tdis.uniform_sample(_tkey(kj), n, m, T, ledger=tl)
    np.testing.assert_array_equal(np.asarray(jS), tS.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    with pytest.raises(ValueError, match="positive total"):
        tdis.dis_sample(_tkey(kj), [torch.zeros(n) for _ in range(T)], m)


def test_dis_marginals_match_reference():
    sc = _scores(11, 3, 300)
    jm = np.asarray(jdis.dis_marginals([jnp.asarray(g) for g in sc]))
    tm = tdis.dis_marginals([torch.from_numpy(g) for g in sc]).numpy()
    np.testing.assert_allclose(tm, jm, rtol=1e-6)
    assert abs(float(tm.sum()) - 1.0) < 1e-5


def test_coreset_ratios_match_reference():
    jds, tds = _datasets(4, n=400, d=6)
    r = np.random.default_rng(4)
    idx = r.integers(0, tds.n, 60)
    w = r.uniform(2.0, 10.0, 60).astype(np.float32)
    jcs = jcoreset.Coreset(jnp.asarray(idx), jnp.asarray(w), 0)
    tcs = coreset_from_numpy(idx, w, 0, device="cpu")
    thetas = r.standard_normal((5, tds.d)).astype(np.float32)
    for lam in (0.0, 40.0):
        jr = float(jcoreset.vrlr_coreset_ratio(jds, jcs, jnp.asarray(thetas), lam))
        tr = float(tcoreset.vrlr_coreset_ratio(tds, tcs, torch.from_numpy(thetas), lam))
        assert tr == pytest.approx(jr, rel=1e-5)
    centers = r.standard_normal((4, 3, tds.d)).astype(np.float32)
    jr = float(jcoreset.vkmc_coreset_ratio(jds, jcs, jnp.asarray(centers)))
    tr = float(tcoreset.vkmc_coreset_ratio(tds, tcs, torch.from_numpy(centers)))
    assert tr == pytest.approx(jr, rel=1e-5)


def test_spec_m_cap_replace_and_describe():
    jds, tds = _datasets(5, n=100)
    for kw in (dict(budgets=(10, 20), m_cap=20), dict(budgets=5, m_cap=8),
               dict(m_cap=None)):
        assert CoresetSpec(**kw).m_cap == JSpec(**kw).m_cap
    for bad in (dict(budgets=(10, 30), m_cap=20), dict(m_cap=0), dict(m_cap=2.5),
                dict(m_cap=True), dict(budgets=9, m_cap=8)):
        with pytest.raises(ValueError):
            JSpec(**bad)
        with pytest.raises(ValueError):
            CoresetSpec(**bad)
    spec = CoresetSpec(task="vrlr", budgets=(10, 20))
    grid = spec.replace(num_seeds=3, m_cap=32)
    jgrid = JSpec(task="vrlr", budgets=(10, 20)).replace(num_seeds=3, m_cap=32)
    assert (grid.budgets, grid.num_seeds, grid.m_cap) == (
        jgrid.budgets, jgrid.num_seeds, jgrid.m_cap)
    assert spec.num_seeds == 1 and spec.m_cap is None       # frozen, copied
    with pytest.raises(ValueError):
        spec.replace(m_cap=15)
    ep = compile_plan(grid, tds)
    assert (ep.engine, ep.grid, ep.m_cap, ep.is_grid) == ("batched", (3, 2), 32, True)
    assert ep.predicted_comm_units == 3 * (
        tcomm.CommSchedule.dis_total(3, 10) + tcomm.CommSchedule.dis_total(3, 20))
    text = ep.describe()
    for part in ("engine=batched", "task=vrlr", "backend=ref", "grid=3x2",
                 "budgets=(10, 20)", "m_cap=32", "n=100", "T=3",
                 f"dims={tds.dims}", f"{ep.predicted_comm_units} units"):
        assert part in text
    one = compile_plan(CoresetSpec(task="uniform", budgets=7), tds)
    assert (one.engine, one.grid, one.m_cap, one.is_grid) == ("materialized", (1, 1), 7, False)
    assert one.predicted_comm_units == tcomm.CommSchedule.uniform(3, 7).total
    with pytest.raises(ValueError, match="grid"):
        compile_plan(CoresetSpec(budgets=(10, 20), engine="materialized"), tds)


# --------------------------------------------------------------------------
# tests/test_api.py's shims: the seed-era builders over build_coreset
# --------------------------------------------------------------------------

def _shim_warning(fn):
    """The call's result and the text of its one DeprecationWarning."""
    with pytest.warns(DeprecationWarning) as rec:
        out = fn()
    assert len(rec) == 1
    return out, str(rec[0].message)


def _reference_shim_text(name, *args, **kw):
    """The reference shim's warning text, from a call on a tiny dataset."""
    jds, _ = _datasets(99, n=40, d=4, T=2)
    _, text = _shim_warning(lambda: getattr(jcore, name)(jax.random.PRNGKey(0), jds,
                                                         *args, **kw))
    return text


def test_vrlr_shim_bit_identical_with_seed_ledger_total():
    jds, tds = _datasets(4, n=1200, d=12)
    m, T = 150, tds.T
    led_old, led_new = CommLedger(), CommLedger()
    key = _tkey(jax.random.PRNGKey(5))
    cs_old, text = _shim_warning(lambda: tcore.build_vrlr_coreset(
        key, tds, m, ledger=led_old, device="cpu"))
    cs_new = build_coreset("vrlr", tds, m, key=key, ledger=led_new, device="cpu")
    assert torch.equal(cs_old.indices, cs_new.indices)
    assert torch.equal(cs_old.weights, cs_new.weights)
    # the seed's exact bill: 2T (round 1) + m (round 2 up) + 2mT (bcast + round 3)
    assert led_old.total == led_new.total == 2 * T + m + 2 * m * T
    tags = led_new.by_tag()
    assert tags["dis/round1/G_j"] == T and tags["dis/round1/a_j"] == T
    assert tags["dis/round2/S_up"] == m
    assert tags["dis/round2/S_bcast"] == m * T
    assert tags["dis/round3/g_scores"] == m * T
    assert text == 'build_vrlr_coreset is deprecated; use build_coreset("vrlr", ...)'
    assert text == _reference_shim_text("build_vrlr_coreset", 8)
    # use_kernel=False is backend="ref", which the CPU resolves "auto" to
    cs_ref, _ = _shim_warning(lambda: tcore.build_vrlr_coreset(
        key, tds, m, use_kernel=False, device="cpu"))
    assert torch.equal(cs_ref.indices, cs_new.indices)


def test_vkmc_shim_bit_identical():
    jds, tds = _datasets(8, n=1200, d=12, labels=False)
    m, k = 120, 4
    led_old, led_new = CommLedger(), CommLedger()
    key = _tkey(jax.random.PRNGKey(9))
    cs_old, text = _shim_warning(lambda: tcore.build_vkmc_coreset(
        key, tds, k=k, m=m, ledger=led_old, device="cpu"))
    cs_new = build_coreset("vkmc", tds, m, key=key, k=k, ledger=led_new, device="cpu")
    assert torch.equal(cs_old.indices, cs_new.indices)
    assert torch.equal(cs_old.weights, cs_new.weights)
    assert led_old.total == led_new.total
    assert text == 'build_vkmc_coreset is deprecated; use build_coreset("vkmc", ...)'
    assert text == _reference_shim_text("build_vkmc_coreset", 2, 8, local_iters=2)


def test_uniform_shim_bit_identical():
    _, tds = _datasets(10, n=1200, d=12)
    m = 80
    led = CommLedger()
    key = _tkey(jax.random.PRNGKey(11))
    cs_old, text = _shim_warning(lambda: tcore.build_uniform_coreset(key, tds, m,
                                                                     device="cpu"))
    cs_new = build_coreset("uniform", tds, m, key=key, ledger=led, device="cpu")
    assert torch.equal(cs_old.indices, cs_new.indices)
    assert torch.equal(cs_old.weights, cs_new.weights)
    assert led.total == m * tds.T                        # broadcast only
    assert text == 'build_uniform_coreset is deprecated; use build_coreset("uniform", ...)'
    assert text == _reference_shim_text("build_uniform_coreset", 8)
