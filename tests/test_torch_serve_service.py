"""The multi-tenant service of the port (``repro_torch.serve.service``) and
its admission control (``repro_torch.serve.resilience``), on the CPU.

The first part restates the reference's tests against the port: all of
``tests/test_serve_service.py`` (tenant lifecycle, isolation, the shared
plan cache, the batched flush), the token bucket and circuit breaker tests
of ``tests/test_resilience.py`` and its service tests (deadlines at
admission, mid-build and on the boundary, degraded queries, rate limits,
the in-flight cap, queue bounds, breakers, leaf failover, eviction,
deferred flushes, plan-cache maintenance, and the ledger/receipt
reconciliation).

The second holds the port to the reference's service (``repro.serve``,
``backend="ref"``) on the same chunks and keys:

- a ``vrlr`` tenant's tree and its queries: indices exact, weights at
  ``rtol=1e-5``, ledger totals and bits exact (the pipelined reference
  engine is not bitwise its streamed one on this toolchain, ROADMAP queue
  3 B.2, so weights carry a tolerance as in ``test_torch_serve_tree.py``);
- ``vrlr`` flush cells: indices exact, weights at ``rtol=1e-5``, bills
  exact;
- ``vkmc`` by quality: the tenant's union fit by the port's k-means with
  one key lands within an absolute 2e-3 ``rel_error`` of the reference's
  (``REL_GAP`` of ``tests/test_torch_vkmc_slice.py``);
- the number of clock reads after each operation of a mixed sequence on a
  ticking ``SimClock``, and the receipts it yields, equal to the
  reference's;
- ``attach_dataset`` refusing a dataset off the service's device.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import VFLDataset as JDataset
from repro.core.faults import Deadline as JDeadline
from repro.core.faults import SimClock as JSimClock
from repro.serve import CoresetService as JService
from repro_torch import rng
from repro_torch.convert import dataset_from_numpy, key_from_numpy, materialized_from_numpy
from repro_torch.core import (
    PlanCache, build_coreset, evaluate, fit_kmeans, full_data_coreset)
from repro_torch.core.faults import (
    Deadline, FaultPlan, PartyUnavailable, SimClock, Transport)
from repro_torch.serve import (
    CoresetService, CoresetTree, InsertReceipt, QueryReceipt, ShedReceipt)
from repro_torch.serve import service as service_mod
from repro_torch.serve.resilience import CircuitBreaker, TokenBucket

BLOCK = 256
CPU = "cpu"
REL_GAP = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _service(**kw):
    return CoresetService(device=CPU, **kw)


def _chunk(r, rows=300, dims=(3, 2), labels=True):
    parts = [r.normal(size=(rows, d)).astype(np.float32) for d in dims]
    y = r.normal(size=(rows,)).astype(np.float32) if labels else None
    return parts, y


def _ds(r, n=512, dims=(3, 3)):
    parts = [r.normal(size=(n, d)).astype(np.float32) for d in dims]
    y = r.normal(size=(n,)).astype(np.float32)
    return dataset_from_numpy(parts, y, CPU)


# -- tests/test_serve_service.py, restated -------------------------------------


def test_register_insert_query_evict_lifecycle():
    svc = _service()
    svc.register("a", task="vrlr", budget=24, seed=1, block_size=BLOCK)
    r = np.random.default_rng(0)
    for i in range(3):
        parts, y = _chunk(r)
        rc = svc.insert("a", parts, y)
        assert rc.tenant == "a" and rc.chunk_idx == i
        assert rc.stats.leaf_builds == 1 and rc.latency_s > 0
        assert rc.ledger_total == svc.state("a").ledger.total
    q = svc.query("a", reduce_to=24)
    assert q.m == 24 and (q.result.weights > 0).all()
    ev = svc.evict("a")
    assert ev.chunks == 3 and ev.rows == 900 and ev.ledger_total > 0
    with pytest.raises(KeyError):
        svc.query("a")
    with pytest.raises(ValueError):
        svc.register("b", budget=8)
        svc.register("b", budget=8)


def test_tenant_draws_isolated_and_deterministic():
    """A tenant's coresets depend only on its own (seed, insert sequence) —
    other tenants' traffic cannot perturb them."""
    chunks = [_chunk(np.random.default_rng(s)) for s in range(4)]

    def run(with_noise):
        svc = _service()
        svc.register("t", task="vrlr", budget=20, seed=7, block_size=BLOCK)
        if with_noise:
            svc.register("noisy", task="vkmc", budget=16, seed=3,
                         block_size=BLOCK, k=3)
        for i, (parts, y) in enumerate(chunks):
            svc.insert("t", parts, y)
            if with_noise:
                np_parts, _ = _chunk(np.random.default_rng(100 + i), labels=False)
                svc.insert("noisy", np_parts)
                svc.query("noisy")
        return svc.query("t", reduce_to=20).result

    a, b = run(False), run(True)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)


def test_service_tree_matches_standalone_tree():
    chunks = [_chunk(np.random.default_rng(s)) for s in range(3)]
    svc = _service()
    svc.register("t", task="vrlr", budget=16, seed=5, block_size=BLOCK)
    tree = CoresetTree("vrlr", 16, key=rng.PRNGKey(5), block_size=BLOCK, device=CPU)
    for parts, y in chunks:
        svc.insert("t", parts, y)
        tree.insert(parts, y)
    a = svc.query("t", reduce_to=16).result
    b = tree.query(reduce_to=16)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert svc.state("t").ledger.total == tree.ledger.total


def test_plan_cache_shared_across_tenants():
    svc = _service()
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        svc.register(name, task="vrlr", budget=16, seed=seed, block_size=BLOCK)
    r = np.random.default_rng(0)
    receipts = []
    for name in ("a", "b", "c"):
        parts, y = _chunk(r)        # same shapes for every tenant
        receipts.append(svc.insert(name, parts, y))
    # the first insert compiles the plan, the rest hit the shared cache
    assert not receipts[0].plan_hit
    assert receipts[1].plan_hit and receipts[2].plan_hit
    s = svc.stats()
    assert s["plan_cache_size"] == 1 and s["plan_misses"] == 1
    assert s["plan_hits"] >= 2


def test_batched_flush_one_dispatch_per_group_draws_pinned():
    """R compatible requests flush as ONE batched build, and each request's
    draw equals the standalone build_coreset for its (key, m)."""
    r = np.random.default_rng(4)
    parts, y = _chunk(r, rows=800)
    ds = dataset_from_numpy(parts, y, CPU)
    svc = _service()
    svc.register("a", budget=8, seed=1, block_size=BLOCK)
    svc.register("b", budget=8, seed=2, block_size=BLOCK)
    svc.attach_dataset("ref", ds)
    with pytest.raises(ValueError):
        svc.attach_dataset("ref", ds)
    with pytest.raises(KeyError):
        svc.submit("a", "nope", 16, key=rng.PRNGKey(0))

    keys = [rng.PRNGKey(10 + i) for i in range(3)]
    t0 = svc.submit("a", "ref", 32, key=keys[0], task="vrlr")
    t1 = svc.submit("b", "ref", 48, key=keys[1], task="vrlr")
    t2 = svc.submit("a", "ref", 32, key=keys[2], task="vkmc", k=3)
    assert svc.pending == 3
    led_a0 = svc.state("a").ledger.total
    out = svc.flush()
    assert svc.pending == 0
    assert set(out) == {t0, t1, t2}
    # two groups: (ref, vrlr, {}) with 2 requests, (ref, vkmc, k=3) with 1
    assert svc.batched_flushes == 2 and svc.batched_cells == 3
    # draws pinned to the standalone builder (batched m == m_cap cells are
    # exactly the sequential result; smaller m is the iid prefix)
    solo = build_coreset("vrlr", ds, 48, key=keys[1], backend="ref", device=CPU)
    np.testing.assert_array_equal(out[t1].indices.numpy(), solo.indices.numpy())
    np.testing.assert_array_equal(out[t1].weights.numpy(), solo.weights.numpy())
    assert out[t0].indices.shape == (32,) and out[t2].indices.shape == (32,)
    # each cell billed its exact schedule on the submitting tenant's ledger
    assert svc.state("a").ledger.total \
        == led_a0 + out[t0].comm_units + out[t2].comm_units


def test_flush_requires_resubmission_and_empty_flush_ok():
    svc = _service()
    assert svc.flush() == {}
    r = np.random.default_rng(9)
    parts, y = _chunk(r, rows=400)
    svc.attach_dataset("d", dataset_from_numpy(parts, y, CPU))
    t = svc.submit("ghost", "d", 16, key=rng.PRNGKey(0))
    out = svc.flush()                 # unknown tenants still get results,
    assert out[t].indices.shape == (16,)   # just no ledger to bill
    assert svc.flush() == {}


def test_shared_plan_cache_injection():
    cache = PlanCache()
    svc1 = _service(plan_cache=cache)
    svc2 = _service(plan_cache=cache)
    r = np.random.default_rng(2)
    svc1.register("t", budget=16, seed=1, block_size=BLOCK)
    svc2.register("t", budget=16, seed=1, block_size=BLOCK)
    parts, y = _chunk(r)
    assert not svc1.insert("t", parts, y).plan_hit
    assert svc2.insert("t", parts, y).plan_hit   # warmed by svc1
    assert len(cache) == 1


# -- tests/test_resilience.py: bucket and breaker, restated --------------------


def test_token_bucket_burst_refill_and_retry_hint():
    b = TokenBucket(rate_per_s=2.0, burst=2)
    ok1, _ = b.try_take(0.0)
    ok2, _ = b.try_take(0.0)
    ok3, retry = b.try_take(0.0)
    assert (ok1, ok2, ok3) == (True, True, False)
    assert retry == pytest.approx(0.5)     # 1 token / 2 per second
    ok4, _ = b.try_take(0.6)               # refilled 1.2 tokens
    assert ok4
    with pytest.raises(ValueError):
        TokenBucket(0.0, 2)
    with pytest.raises(ValueError):
        TokenBucket(1.0, 0.5)


def test_breaker_full_lifecycle():
    br = CircuitBreaker(threshold=2, cooldown_s=10.0)
    assert br.allow(0.0) == (True, 0.0)
    br.record_failure(0.0, "boom1")
    assert br.state == "closed"            # 1 of 2
    br.record_failure(1.0, "boom2")
    assert br.state == "open" and br.trips == 1
    ok, retry = br.allow(5.0)
    # opened at t=1.0 (the tripping failure), so 6s of cooldown remain
    assert not ok and retry == pytest.approx(6.0)
    ok, _ = br.allow(11.0)                 # cooldown elapsed -> probe
    assert ok and br.state == "half_open"
    ok2, _ = br.allow(11.0)                # only ONE probe in flight
    assert not ok2
    br.record_failure(11.0, "probe died")
    assert br.state == "open" and br.trips == 2
    ok, _ = br.allow(22.0)
    br.record_success()                    # probe succeeded
    assert br.state == "closed" and br.failures == 0


def test_breaker_success_resets_consecutive_count():
    br = CircuitBreaker(threshold=3, cooldown_s=1.0)
    br.record_failure(0.0, "x")
    br.record_failure(0.0, "x")
    br.record_success()                    # intermittent, not consecutive
    br.record_failure(0.0, "x")
    br.record_failure(0.0, "x")
    assert br.state == "closed" and br.trips == 0


def test_breaker_neutral_requeues_probe_without_trip():
    br = CircuitBreaker(threshold=1, cooldown_s=10.0)
    br.record_failure(0.0, "x")
    assert br.state == "open" and br.trips == 1
    ok, _ = br.allow(20.0)
    assert ok and br.state == "half_open"
    br.record_neutral(20.0)                # e.g. the probe hit a deadline
    assert br.state == "open" and br.trips == 1
    ok, _ = br.allow(31.0)                 # next probe still fires
    assert ok


# -- tests/test_resilience.py: the service, restated ---------------------------


def _svc(clock=None, **kw):
    svc = _service(clock=clock, **kw)
    svc.register("t", task="vrlr", budget=16, seed=0, block_size=BLOCK)
    return svc


def test_insert_deadline_expired_at_admission_sheds_with_zero_work():
    clock = SimClock(tick=0.0)
    svc = _svc(clock)
    parts, y = _chunk(np.random.default_rng(0))
    r = svc.insert("t", parts, y, deadline=Deadline.after(clock, 0.0))
    assert isinstance(r, ShedReceipt)
    assert r.reason == "deadline" and r.op == "insert"
    st = svc.state("t")
    assert st.tree.num_chunks == 0 and st.ledger.total == 0
    assert st.sheds == 1 and svc.stats()["sheds"] == 1


def test_insert_deadline_mid_build_rolls_back():
    clock = SimClock(tick=1.0)       # every clock read costs a full second
    svc = _svc(clock)
    parts, y = _chunk(np.random.default_rng(0))
    ok = svc.insert("t", parts, y)   # no deadline: lands
    assert isinstance(ok, InsertReceipt)
    led_before = svc.state("t").ledger.total
    levels = list(svc.state("t").tree.levels)
    # admission passes (first read), the leaf probe's read expires it
    r = svc.insert("t", parts, y, deadline=Deadline.after(clock, 1.5))
    assert isinstance(r, ShedReceipt) and r.reason == "deadline"
    st = svc.state("t")
    assert st.tree.num_chunks == 1 and st.ledger.total == led_before
    assert st.tree.levels == levels


def test_insert_deadline_exactly_at_boundary_sheds():
    """The >= semantics end to end: a deadline landing exactly on the
    superchunk-boundary check is a miss, not a keep-going."""
    clock = SimClock(tick=1.0)
    svc = _svc(clock)
    parts, y = _chunk(np.random.default_rng(0))
    # admission consumes t=0; the first probe reads exactly t=1.0 == at
    r = svc.insert("t", parts, y, deadline=Deadline.after(clock, 1.0))
    assert isinstance(r, ShedReceipt) and r.reason == "deadline"
    assert svc.state("t").tree.num_chunks == 0


def test_query_degrades_to_union_under_deadline_pressure():
    clock = SimClock(tick=0.6)
    svc = _svc(clock)
    r = np.random.default_rng(0)
    for _ in range(2):
        parts, y = _chunk(r)
        assert isinstance(svc.insert("t", parts, y), InsertReceipt)
    m_active = svc.state("t").tree.m_active
    led0 = svc.state("t").ledger.total
    # admission passes at t=0.6 < 1.0; the pre-reduce check lands past it
    q = svc.query("t", reduce_to=8, deadline=Deadline.after(clock, 1.0))
    assert isinstance(q, QueryReceipt)
    assert q.degraded and q.m == m_active and q.comm_delta == 0
    assert svc.state("t").ledger.total == led0      # union is free
    # an unpressed query still reduces
    q2 = svc.query("t", reduce_to=8)
    assert not q2.degraded and q2.m == 8 and q2.comm_delta > 0


def test_query_deadline_expired_at_admission_sheds():
    clock = SimClock(tick=0.0)
    svc = _svc(clock)
    parts, y = _chunk(np.random.default_rng(0))
    svc.insert("t", parts, y)
    r = svc.query("t", reduce_to=8, deadline=Deadline.after(clock, 0.0))
    assert isinstance(r, ShedReceipt) and r.reason == "deadline"


def test_rate_limited_tenant_sheds_and_recovers():
    clock = SimClock(tick=0.0)
    svc = _service(clock=clock)
    svc.register("g", task="vrlr", budget=16, seed=0, block_size=BLOCK,
                 rate_limit=(1.0, 2))
    r = np.random.default_rng(0)
    outs = [svc.insert("g", *_chunk(r)) for _ in range(3)]
    assert [isinstance(o, InsertReceipt) for o in outs] == [True, True, False]
    assert outs[2].reason == "rate_limit" and outs[2].retry_after_s > 0
    clock.advance(2.0)                     # refill
    assert isinstance(svc.insert("g", *_chunk(r)), InsertReceipt)


def test_global_inflight_cap_sheds_overloaded():
    svc = _service(max_inflight=1)
    svc.register("t", task="vrlr", budget=16, seed=0, block_size=BLOCK)
    parts, y = _chunk(np.random.default_rng(0))
    svc._inflight = 1                      # a request is mid-flight
    r = svc.insert("t", parts, y)
    assert isinstance(r, ShedReceipt) and r.reason == "overloaded"
    svc._inflight = 0
    assert isinstance(svc.insert("t", parts, y), InsertReceipt)
    with pytest.raises(ValueError):
        _service(max_inflight=0)


def test_submit_queue_bound_sheds_queue_full():
    r = np.random.default_rng(0)
    svc = _service()
    svc.register("t", task="vrlr", budget=16, seed=0, block_size=BLOCK,
                 max_pending=2)
    svc.attach_dataset("ref", _ds(r))
    k = rng.PRNGKey(0)
    t1 = svc.submit("t", "ref", 8, key=k)
    t2 = svc.submit("t", "ref", 8, key=rng.fold_in(k, 1))
    assert isinstance(t1, int) and isinstance(t2, int)
    shed = svc.submit("t", "ref", 8, key=rng.fold_in(k, 2))
    assert isinstance(shed, ShedReceipt) and shed.reason == "queue_full"
    svc.flush()                            # drains the queue
    assert isinstance(svc.submit("t", "ref", 8, key=rng.fold_in(k, 3)), int)


def test_breaker_trips_isolates_and_recovers_per_tenant():
    clock = SimClock(tick=0.5)
    svc = _service(clock=clock)
    tr = Transport(FaultPlan(seed=3, drop=1.0, max_retries=1), clock=clock)
    svc.register("bad", task="vrlr", budget=16, seed=0, block_size=BLOCK,
                 fault_policy="retry", transport=tr,
                 breaker_threshold=2, breaker_cooldown_s=50.0)
    svc.register("good", task="vrlr", budget=16, seed=1, block_size=BLOCK)
    r = np.random.default_rng(0)
    for _ in range(2):
        with pytest.raises(PartyUnavailable):
            svc.insert("bad", *_chunk(r))
    br = svc.stats()["breakers"]["bad"]
    assert br["state"] == "open" and br["trips"] == 1
    assert "PartyUnavailable" in br["last_error"]
    shed = svc.insert("bad", *_chunk(r))
    assert isinstance(shed, ShedReceipt) and shed.reason == "breaker_open"
    assert shed.retry_after_s > 0
    # the good tenant is untouched
    assert isinstance(svc.insert("good", *_chunk(r)), InsertReceipt)
    assert svc.stats()["breakers"]["good"]["state"] == "closed"
    # cooldown passes; the transport still drops, so the probe reopens
    clock.advance(100.0)
    with pytest.raises(PartyUnavailable):
        svc.insert("bad", *_chunk(r))
    assert svc.stats()["breakers"]["bad"]["trips"] == 2


def test_service_failover_receipt_and_draw_identity():
    chunks = [_chunk(np.random.default_rng(s)) for s in range(2)]

    def play(**extra):
        svc = _service()
        svc.register("t", task="vrlr", budget=16, seed=5, block_size=BLOCK,
                     chunk_blocks=2, **extra)
        recs = [svc.insert("t", p, y) for p, y in chunks]
        return svc, recs, svc.query("t", reduce_to=16)

    svc_ok, recs_ok, q_ok = play()
    svc_fb, recs_fb, q_fb = play(failover=True, memory_budget_bytes=1)
    assert all(r.fallback == "pipelined->streamed" for r in recs_fb)
    assert all(r.stats.fallback == "pipelined->streamed" for r in recs_fb)
    assert all(r.fallback is None for r in recs_ok)
    np.testing.assert_array_equal(q_ok.result.indices, q_fb.result.indices)
    np.testing.assert_array_equal(q_ok.result.weights, q_fb.result.weights)
    assert svc_fb.state("t").ledger.total == svc_ok.state("t").ledger.total
    assert svc_fb.state("t").tree.fallbacks == 2
    assert svc_fb.state("t").tree.last_fallback == "pipelined->streamed"
    assert svc_fb.stats()["fallbacks"] == 2


def test_evict_drops_pending_submits():
    r = np.random.default_rng(0)
    svc = _service()
    svc.register("a", task="vrlr", budget=16, seed=0, block_size=BLOCK)
    svc.register("b", task="vrlr", budget=16, seed=1, block_size=BLOCK)
    svc.attach_dataset("ref", _ds(r))
    k = rng.PRNGKey(0)
    svc.submit("a", "ref", 8, key=k)
    svc.submit("a", "ref", 8, key=rng.fold_in(k, 1))
    tb = svc.submit("b", "ref", 8, key=rng.fold_in(k, 2))
    ev = svc.evict("a")
    assert ev.dropped_pending == 2 and svc.pending == 1
    out = svc.flush()
    assert set(out) == {tb}                # a's tickets never execute


def test_flush_deadline_defers_unstarted_groups():
    r = np.random.default_rng(0)
    clock = SimClock(tick=0.0)
    svc = _service(clock=clock)
    svc.attach_dataset("ref", _ds(r))
    k = rng.PRNGKey(0)
    t1 = svc.submit("x", "ref", 8, key=k)
    t2 = svc.submit("x", "ref", 12, key=rng.fold_in(k, 1))
    out = svc.flush(deadline=Deadline.after(clock, 0.0))   # born expired
    assert out == {} and svc.pending == 2
    out = svc.flush()
    assert set(out) == {t1, t2}


def test_service_exposes_plan_cache_maintenance():
    t = [0.0]
    svc = _service(plan_cache=PlanCache(time_fn=lambda: t[0]))
    svc.register("t", task="vrlr", budget=16, seed=0, block_size=BLOCK)
    r = np.random.default_rng(0)
    svc.insert("t", *_chunk(r))
    assert svc.stats()["plan_cache_size"] == 1
    t[0] = 100.0
    assert svc.stats()["plan_oldest_idle_s"] == 100.0
    assert svc.prune_plans(50.0) == 1
    assert svc.stats()["plan_cache_size"] == 0
    svc.insert("t", *_chunk(r))
    svc.clear_plans()
    assert svc.stats()["plan_cache_size"] == 0


def _reconcile(seed, n_chunks, n_queries, budget=12):
    """One tenant's ledger total must equal the sum of comm units across
    its insert/query/flush receipts — no unattributed cost."""
    r = np.random.default_rng(seed)
    svc = _service()
    svc.register("t", task="vrlr", budget=budget, seed=seed, block_size=BLOCK)
    svc.attach_dataset("ref", _ds(r))
    total = 0
    for i in range(n_chunks):
        rc = svc.insert("t", *_chunk(r, rows=200 + 50 * i))
        total += rc.stats.comm_delta
        for _ in range(n_queries):
            q = svc.query("t", reduce_to=budget)
            total += q.comm_delta
    tk = svc.submit("t", "ref", 8, key=rng.PRNGKey(seed + 99))
    out = svc.flush()
    total += out[tk].comm_units
    assert svc.state("t").ledger.total == total
    return total


def test_ledger_receipt_reconciliation_fixed_seed():
    # deterministic pin: the composed bill for this exact workload
    total = _reconcile(0, n_chunks=3, n_queries=1)
    assert total == _reconcile(0, n_chunks=3, n_queries=1)
    assert total > 0


def test_ledger_receipt_reconciliation_property():
    # hypothesis sweep of the same invariant over (seed, workload shape)
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(seed=st.integers(min_value=0, max_value=2**16),
           n_chunks=st.integers(min_value=1, max_value=2),
           n_queries=st.integers(min_value=0, max_value=1))
    @settings(database=None, max_examples=6, deadline=None)
    def prop(seed, n_chunks, n_queries):
        _reconcile(seed, n_chunks=n_chunks, n_queries=n_queries)

    prop()


# -- the port's own: the device seam ------------------------------------------


def test_service_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoresetService()


def test_attach_dataset_refuses_a_dataset_off_the_service_device(monkeypatch):
    """A service on the card refuses a host dataset when it is attached,
    not at flush time after tenants' submits are queued."""
    monkeypatch.setattr(service_mod, "resolve_device",
                        lambda device="cuda": torch.device("cuda", 0))
    svc = CoresetService()
    assert svc.device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match=r"dataset 'ref' lives on cpu, the service "
                                         r"builds on cuda:0"):
        svc.attach_dataset("ref", _ds(np.random.default_rng(0)))
    assert svc.stats()["pending"] == 0
    with pytest.raises(KeyError):
        svc.submit("t", "ref", 8, key=rng.PRNGKey(0))


# -- against the reference -----------------------------------------------------


def _services(**kw):
    return JService(backend="ref", **kw), _service(backend="ref", **kw)


def _same_result(mt, mj):
    np.testing.assert_array_equal(mt.indices, np.asarray(mj.indices))
    np.testing.assert_allclose(mt.weights, np.asarray(mj.weights), rtol=1e-5)
    for pt, pj in zip(mt.parts, mj.parts):
        np.testing.assert_array_equal(pt, np.asarray(pj))
    assert (mt.comm_units, mt.comm_bits) == (mj.comm_units, mj.comm_bits)


def test_vrlr_tenant_matches_reference():
    """Four inserts of one tenant with a reduced query after each, beside a
    second tenant's traffic: the receipts' census and bills, every query
    and the ledger equal the reference service's."""
    jsvc, tsvc = _services()
    jkey = jax.random.PRNGKey(21)
    jsvc.register("t", task="vrlr", budget=24, key=jkey, block_size=BLOCK)
    tsvc.register("t", task="vrlr", budget=24, key=key_from_numpy(np.asarray(jkey), CPU),
                  block_size=BLOCK)
    for svc in (jsvc, tsvc):
        svc.register("o", task="vrlr", budget=24, seed=3, block_size=BLOCK)
    r = np.random.default_rng(14)
    for i in range(4):
        parts, y = _chunk(r)
        ji, ti = jsvc.insert("t", parts, y), tsvc.insert("t", parts, y)
        js, ts = ji.stats, ti.stats
        assert (ts.chunk_rows, ts.merges, ts.rescored_rows, ts.comm_delta,
                ts.height_after) == (js.chunk_rows, js.merges, js.rescored_rows,
                                     js.comm_delta, js.height_after)
        assert (ti.chunk_idx, ti.ledger_total, ti.ledger_bits, ti.plan_hit) == \
            (ji.chunk_idx, ji.ledger_total, ji.ledger_bits, ji.plan_hit)
        other = _chunk(r)
        assert jsvc.insert("o", *other).plan_hit == tsvc.insert("o", *other).plan_hit
        jq, tq = jsvc.query("t", reduce_to=24), tsvc.query("t", reduce_to=24)
        _same_result(tq.result, jq.result)
        assert (tq.m, tq.ledger_total, tq.comm_delta, tq.ledger_bits,
                tq.comm_delta_bits, tq.degraded) == \
            (jq.m, jq.ledger_total, jq.comm_delta, jq.ledger_bits,
             jq.comm_delta_bits, jq.degraded)
    _same_result(tsvc.query("t").result, jsvc.query("t").result)
    jl, tl = jsvc.state("t").ledger, tsvc.state("t").ledger
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    assert tsvc.describe() == jsvc.describe()
    tstats, jstats = tsvc.stats(), jsvc.stats()
    for k in ("plan_oldest_idle_s",):
        tstats.pop(k), jstats.pop(k)
    assert tstats == jstats
    te, je = tsvc.evict("t"), jsvc.evict("t")
    assert dataclasses.asdict(te) == dataclasses.asdict(je)


def test_vrlr_flush_matches_reference():
    """Two tenants' vrlr requests at two budgets flush as one batched grid
    on each side: every cell's indices exact, weights at rtol 1e-5, and
    each tenant billed the same."""
    r = np.random.default_rng(4)
    parts, y = _chunk(r, rows=800)
    jsvc, tsvc = _services()
    jsvc.attach_dataset("ref", JDataset(parts, y))
    tsvc.attach_dataset("ref", dataset_from_numpy(parts, y, CPU))
    for svc in (jsvc, tsvc):
        svc.register("a", budget=8, seed=1, block_size=BLOCK)
        svc.register("b", budget=8, seed=2, block_size=BLOCK)
    reqs = [("a", 32, 10), ("b", 48, 11), ("a", 48, 12), ("b", 32, 13)]
    jt = [jsvc.submit(t, "ref", m, key=jax.random.PRNGKey(s)) for t, m, s in reqs]
    tt = [tsvc.submit(t, "ref", m, key=rng.PRNGKey(s)) for t, m, s in reqs]
    assert jt == tt
    jout, tout = jsvc.flush(), tsvc.flush()
    assert (tsvc.batched_flushes, tsvc.batched_cells) == (jsvc.batched_flushes,
                                                          jsvc.batched_cells) == (1, 4)
    for t in tt:
        np.testing.assert_array_equal(tout[t].indices.numpy(), np.asarray(jout[t].indices))
        np.testing.assert_allclose(tout[t].weights.numpy(), np.asarray(jout[t].weights),
                                   rtol=1e-5)
        assert (tout[t].comm_units, tout[t].comm_bits) == \
            (jout[t].comm_units, jout[t].comm_bits)
    for name in ("a", "b"):
        jl, tl = jsvc.state(name).ledger, tsvc.state(name).ledger
        assert (tl.total, tl.total_bits) == (jl.total, jl.total_bits)


def test_vkmc_tenant_quality_matches_reference():
    """Two inserts (two pipelined leaves and one weighted-union merge): the
    tenant's union of each service, fit by the same k-means with the same
    key, against the same full-data baseline."""
    r = np.random.default_rng(16)
    chunks = [_chunk(r, rows=600, dims=(4, 3), labels=False)[0] for _ in range(2)]
    tds = dataset_from_numpy([np.concatenate([c[j] for c in chunks]) for j in range(2)],
                             None, CPU)
    jsvc, tsvc = _services()
    jkey = jax.random.PRNGKey(41)
    jsvc.register("k", task="vkmc", budget=100, key=jkey, block_size=BLOCK, k=4)
    tsvc.register("k", task="vkmc", budget=100, key=key_from_numpy(np.asarray(jkey), CPU),
                  block_size=BLOCK, k=4)
    for c in chunks:
        ji, ti = jsvc.insert("k", c), tsvc.insert("k", c)
        assert (ti.stats.merges, ti.stats.rescored_rows, ti.stats.comm_delta,
                ti.ledger_total, ti.ledger_bits) == \
            (ji.stats.merges, ji.stats.rescored_rows, ji.stats.comm_delta,
             ji.ledger_total, ji.ledger_bits)
    qj = materialized_from_numpy(jsvc.query("k").result)
    qt = tsvc.query("k").result
    assert (qt.m, qt.comm_units) == (qj.m, qj.comm_units) == (200, tsvc.state("k").ledger.total)
    kf = rng.PRNGKey(42)
    base = fit_kmeans(tds, full_data_coreset(tds), 4, key=kf).params

    def rel_error(q):
        fit = fit_kmeans(tds, q.coreset(CPU), 4, key=rng.fold_in(kf, 1))
        return evaluate(tds, fit, baseline=base).rel_error

    r_t, r_j = rel_error(qt), rel_error(qj)
    assert np.isfinite(r_t) and r_t < 0.25
    assert abs(r_t - r_j) <= REL_GAP


def _counting(clock_cls):
    class Counting(clock_cls):
        """A ticking SimClock that counts its reads."""

        def __init__(self):
            super().__init__(tick=1.0)
            self.reads = 0

        def now(self):
            self.reads += 1
            return super().now()

    return Counting()


def _hostile_sequence(svc, clock, deadline_cls, key_fn, ds):
    """One mixed sequence of operations; returns, after each, the clock's
    read count and what the operation gave back."""
    r = np.random.default_rng(5)
    svc.register("t", task="vrlr", budget=24, seed=0, block_size=BLOCK,
                 rate_limit=(0.01, 5))
    svc.register("u", task="vrlr", budget=24, seed=1, block_size=BLOCK)
    svc.attach_dataset("ref", ds)
    trail = []

    def note(tag, out):
        if isinstance(out, ShedReceipt) or type(out).__name__ == "ShedReceipt":
            desc = ("shed", out.op, out.reason, out.retry_after_s)
        elif hasattr(out, "stats"):
            desc = ("insert", out.chunk_idx, out.ledger_total)
        elif hasattr(out, "degraded"):
            desc = ("query", out.m, out.degraded, out.comm_delta)
        else:
            desc = (type(out).__name__, sorted(out) if isinstance(out, dict) else out)
        trail.append((tag, clock.reads, desc))

    note("insert", svc.insert("t", *_chunk(r)))
    note("insert far deadline", svc.insert("t", *_chunk(r),
                                           deadline=deadline_cls.after(clock, 1e6)))
    note("insert mid-build", svc.insert("t", *_chunk(r),
                                        deadline=deadline_cls.after(clock, 2.5)))
    note("query reduce", svc.query("t", reduce_to=8, deadline=deadline_cls.after(clock, 1e6)))
    note("query degraded", svc.query("t", reduce_to=8,
                                     deadline=deadline_cls.after(clock, 2.0)))
    note("query expired", svc.query("t", deadline=deadline_cls.after(clock, 0.0)))
    note("insert rate-limited", svc.insert("t", *_chunk(r)))
    note("insert other", svc.insert("u", *_chunk(r)))
    note("query union", svc.query("u"))
    note("submit", svc.submit("u", "ref", 8, key=key_fn(0)))
    note("submit", svc.submit("u", "ref", 12, key=key_fn(1), task="uniform"))
    note("flush", svc.flush(deadline=deadline_cls.after(clock, 1.5)))
    note("flush rest", svc.flush(deadline=deadline_cls.after(clock, 1e6)))
    return trail


def test_clock_reads_and_receipts_match_reference():
    """On a SimClock that ticks every read, the same sequence of inserts
    (undeadlined, under a far deadline, breached mid-build, rate-limited),
    queries (reduced, degraded, expired) and submits and deadlined flushes
    reads the clock as many times after each operation as the reference
    does, and yields the same receipts."""
    parts, y = _chunk(np.random.default_rng(8), rows=800)
    jclock, tclock = _counting(JSimClock), _counting(SimClock)
    jsvc, tsvc = JService(backend="ref", clock=jclock), _service(backend="ref", clock=tclock)
    jtrail = _hostile_sequence(jsvc, jclock, JDeadline,
                               lambda i: jax.random.PRNGKey(30 + i), JDataset(parts, y))
    ttrail = _hostile_sequence(tsvc, tclock, Deadline, lambda i: rng.PRNGKey(30 + i),
                               dataset_from_numpy(parts, y, CPU))
    assert ttrail == jtrail
    reasons = [d[2] for _, _, d in ttrail if d[0] == "shed"]
    assert reasons == ["deadline", "deadline", "rate_limit"]
    queries = [d for _, _, d in ttrail if d[0] == "query"]
    assert queries[0][1:] == (8, False, queries[0][3]) and queries[0][3] > 0
    assert queries[1][2] and queries[1][3] == 0                     # degraded
    assert (tsvc.state("t").ledger.total, tsvc.state("t").ledger.total_bits) == \
        (jsvc.state("t").ledger.total, jsvc.state("t").ledger.total_bits)
    assert tsvc.state("t").sheds == jsvc.state("t").sheds == 3
    assert tclock.peek() == jclock.peek()
