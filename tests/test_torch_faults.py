"""The party fault and integrity seam: the port's ``core/faults.py``,
``core/integrity.py`` and the executors' transport hooks, against the
reference on the CPU from the same numpy data, keys and fault plans.

Tolerances:

- Exact: fates (``decide``, ``silent_fate``), ``perturb_payload``,
  digests and envelopes, ``deliver``/``ship`` ledgers, reports and stats,
  validator findings, receipts, bills, the chaos pin's numbers and every
  draw's indices.
- Within the port, bit for bit: a null-plan transport against the
  transportless build (indices, weights, ledger) on every single-cell
  engine, task and policy; a quarantined or degraded build against a
  build on ``select_parties(survivors)``.
- Weights against the reference's: ``rtol=1e-4`` (the port's scores match
  the reference's to fp tolerance, not bitwise); through the ``fp16``
  codec ``rtol=2**-10``, one fp16 rounding step, since a score that lies
  on a rounding boundary may quantize to the neighbouring fp16 value in
  one package and not the other.

The reference's fate cache (``repro.core.faults._fault_draw`` and
``_seed_key``) carries fates across threefry layouts, so it is cleared on
entry to and exit from every test here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.faults as jfaults
from repro.core import CommLedger as JLedger
from repro.core import CoresetPipeline as JPipeline
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core import integrity as jint
from repro.core.comm import CommSchedule as JSchedule
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    FAULT_POLICIES, SILENT_KINDS, CommLedger, CommSchedule, Coreset, CoresetPipeline,
    CoresetSpec, Deadline, DeadlineExceeded, DegradedBuild, FaultPlan, IntegrityError,
    PartyUnavailable, SimClock, Transport, WireEnvelope, check_mass_table,
    check_merge_children, check_weights, deliver_or_record, payload_digest,
    perturb_payload, require_valid_masses)
from repro_torch.core import faults as tfaults

BLOCK = 128


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
    """The non-partitionable threefry layout the port implements, with the
    reference's fate cache emptied on both sides of the test."""
    jfaults._fault_draw.cache_clear()
    jfaults._seed_key.cache_clear()
    with jax.threefry_partitionable(False):
        yield
    jfaults._fault_draw.cache_clear()
    jfaults._seed_key.cache_clear()


def _np_ds(seed=0, n=600, dims=(3, 2, 2), labels=True):
    """``tests/test_faults.py``'s ``_ds`` as numpy parts and labels."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(size=(n, d)).astype(np.float32) for d in dims]
    y = None
    if labels:
        theta = np.linspace(1.0, -1.0, dims[0]).astype(np.float32)
        y = (parts[0] @ theta + 0.1 * rng.normal(size=n).astype(np.float32))
    return parts, y


def _both(labels=True, **kw):
    parts, y = _np_ds(labels=labels, **kw)
    return JDataset(parts, y), dataset_from_numpy(parts, y, "cpu")


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


def _spec_kw(engine="materialized", policy="fail", task="vrlr", m=32, **kw):
    params = {"k": 3} if task == "vkmc" else {}
    params.update(kw.pop("params", {}))
    return dict(task=task, budgets=m, engine=engine, backend="ref", fault_policy=policy,
                params=params, block_size=BLOCK, **kw)


def _tbuild(ds, key, transport=None, ledger=None, **kw):
    return CoresetPipeline(ds).build(CoresetSpec(**_spec_kw(**kw)), key=key, ledger=ledger,
                                     transport=transport, device="cpu")


def _jbuild(ds, key, transport=None, ledger=None, **kw):
    return JPipeline(ds).build(JSpec(**_spec_kw(**kw)), key=key, ledger=ledger,
                               transport=transport)


def _msgs(led):
    return [dataclasses.astuple(m) for m in led.messages]


def _same(a: Coreset, b: Coreset) -> bool:
    return torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)


def _match_reference(cs, ref, rtol=1e-4):
    """Indices and bill exact, weights at ``rtol``."""
    np.testing.assert_array_equal(cs.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(cs.weights.numpy(), np.asarray(ref.weights), rtol=rtol)
    assert (cs.comm_units, cs.comm_bits) == (ref.comm_units, ref.comm_bits)


def _receipt(d):
    return None if d is None else dataclasses.astuple(d)


# --------------------------------------------------------------------------
# fates, payload perturbation, envelopes and validators: the reference's exactly
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123, 2**16 + 3])
def test_fates_equal_reference(seed):
    kw = dict(seed=seed, drop=0.3, corrupt=0.1, delay=0.2, silent_corrupt={0: 0.5, 2: 0.9})
    tp, jp = FaultPlan(**kw), jfaults.FaultPlan(**kw)
    tags = ["dis/round1/G_j", "dis/round1/a_j", "dis/round2/S_up", "dis/round3/g_scores",
            "uniform/S_bcast"]
    fired = set()
    for tag in tags:
        for party in range(3):
            for attempt in range(5):
                te, je = tp.decide(tag, party, attempt), jp.decide(tag, party, attempt)
                assert dataclasses.astuple(te) == dataclasses.astuple(je)
                assert tp.silent_fate(tag, party, attempt) == jp.silent_fate(tag, party,
                                                                            attempt)
                fired.add(te.status)
    assert fired >= {"ok", "drop"}
    assert tp.is_null == jp.is_null and tp.backoff_s(3) == jp.backoff_s(3)
    assert FaultPlan.none().is_null and FAULT_POLICIES == jfaults.FAULT_POLICIES


def test_fault_plan_validation_matches_reference():
    for bad in (dict(drop=1.5), dict(seed=True), dict(max_retries=-1),
                dict(silent_kind="flip"), dict(delay_s=-1.0), dict(corrupt={0: -0.1})):
        with pytest.raises(ValueError) as te:
            FaultPlan(**bad)
        with pytest.raises(ValueError) as je:
            jfaults.FaultPlan(**bad)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kind", SILENT_KINDS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
def test_perturb_payload_and_envelopes_byte_for_byte(kind, dtype):
    r = np.random.default_rng(5)
    payload = (r.standard_normal((3, 17)) * 100).astype(dtype)
    for u in (0.0, 0.37, 0.999):
        got, want = perturb_payload(payload, kind, u), jfaults.perturb_payload(payload, kind, u)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert payload_digest(got) == jint.payload_digest(want)
        env = WireEnvelope.seal("dis/round1/G_j", 1, payload)
        assert dataclasses.astuple(env) == dataclasses.astuple(
            jint.WireEnvelope.seal("dis/round1/G_j", 1, payload))
        assert env.mismatch(got) == jint.WireEnvelope.seal(
            "dis/round1/G_j", 1, payload).mismatch(want)
    blob = payload.tobytes()
    assert dataclasses.astuple(WireEnvelope.seal_bytes("t", 0, blob)) == \
        dataclasses.astuple(jint.WireEnvelope.seal_bytes("t", 0, blob))
    env = WireEnvelope.seal("t", 0, payload)
    assert env.mismatch(payload[:2]).startswith("shape") and env.verify(payload)
    assert env.mismatch(payload.astype(np.int64)).startswith("dtype")


def test_validators_equal_reference():
    r = np.random.default_rng(2)
    good = r.uniform(0.1, 1.0, (3, 40)).astype(np.float32)
    tables = [good, good.copy(), good.copy(), good.copy()]
    tables[1][1, 3] = np.nan
    tables[2][2, 0] = -1.0
    tables[3] *= 1000.0
    totals = good.sum(axis=1)
    for tbl in tables:
        for tot, bound in ((None, None), (totals, None), (totals, 50.0), (None, 5.0)):
            got = check_mass_table(tbl, tot, bound=bound)
            want = jint.check_mass_table(tbl, tot, bound=bound)
            assert [dataclasses.astuple(f) for f in got] == \
                [dataclasses.astuple(f) for f in want]
            assert require_valid_masses(tbl, tot, bound=bound, policy="quarantine") == \
                jint.require_valid_masses(tbl, tot, bound=bound, policy="quarantine")
            if got:
                with pytest.raises(IntegrityError) as te:
                    require_valid_masses(tbl, tot, bound=bound)
                with pytest.raises(jint.IntegrityError) as je:
                    jint.require_valid_masses(tbl, tot, bound=bound)
                assert str(te.value) == str(je.value) and te.value.party == je.value.party
    for w in (np.ones(4), np.array([1.0, np.inf]), np.array([1.0, 0.0]), np.array([])):
        assert check_weights(w) == jint.check_weights(w)
    for idx, ws in (([np.arange(3), np.arange(3, 6)], [np.ones(3), np.ones(3)]),
                    ([np.arange(3), np.arange(2, 6)], [np.ones(3), np.ones(4)]),
                    ([np.arange(3), np.arange(3, 6)], [np.ones(3), -np.ones(3)])):
        errs = []
        for fn, exc in ((check_merge_children, IntegrityError),
                        (jint.check_merge_children, jint.IntegrityError)):
            try:
                fn(idx, ws)
                errs.append(None)
            except exc as e:
                errs.append((str(e), e.party, e.tag))
        assert errs[0] == errs[1]


def test_clocks_deadlines_and_merge_schedule_match_reference():
    tc, jc = SimClock(start=1.0, tick=0.5), jfaults.SimClock(start=1.0, tick=0.5)
    td, jd = Deadline.after(tc, 2.0), jfaults.Deadline.after(jc, 2.0)
    assert dataclasses.astuple(td) == dataclasses.astuple(jd)
    for _ in range(3):
        assert td.expired(tc) == jd.expired(jc)
    with pytest.raises(DeadlineExceeded) as te:
        td.check(tc, "superchunk")
    with pytest.raises(jfaults.DeadlineExceeded) as je:
        jd.check(jc, "superchunk")
    assert str(te.value) == str(je.value)
    got, want = CommSchedule.merge(3, 5, 7), JSchedule.merge(3, 5, 7)
    assert [dataclasses.astuple(o) for o in got.ops] == \
        [dataclasses.astuple(o) for o in want.ops]
    with pytest.raises(ValueError, match="merge sizes must be >= 0"):
        CommSchedule.merge(3, -1, 2)


# --------------------------------------------------------------------------
# deliver and ship: ledgers message for message
# --------------------------------------------------------------------------

_PLANS = [dict(seed=3, drop=0.3, corrupt=0.1, delay=0.3, max_retries=4),
          dict(seed=9, drop={1: 0.9}, max_retries=2),
          dict(seed=1, delay=1.0, delay_s=0.05, timeout_s=0.02, max_retries=5)]


@pytest.mark.parametrize("plan", _PLANS)
@pytest.mark.parametrize("drop_on_exhaust", [False, True])
def test_deliver_equals_reference(plan, drop_on_exhaust):
    for sched_t, sched_j in ((CommSchedule.dis(3, 8, counts=[5, 0, 3]),
                              JSchedule.dis(3, 8, counts=[5, 0, 3])),
                             (CommSchedule.uniform(3, 6), JSchedule.uniform(3, 6))):
        tt, jt = Transport(FaultPlan(**plan)), jfaults.Transport(jfaults.FaultPlan(**plan))
        tl, jl = CommLedger(), JLedger()
        outs = []
        for tr, sched, led, exc in ((tt, sched_t, tl, PartyUnavailable),
                                    (jt, sched_j, jl, jfaults.PartyUnavailable)):
            try:
                rep = tr.deliver(sched, led, drop_on_exhaust=drop_on_exhaust)
                outs.append(("ok", rep.units, rep.bits, rep.retries, rep.sim_time_s,
                             {p: dataclasses.astuple(d) for p, d in rep.failed.items()}))
            except exc as e:
                outs.append(("raised", str(e), e.party, e.attempts))
        assert outs[0] == outs[1]
        assert _msgs(tl) == _msgs(jl)
        assert tt.stats.as_dict() == jt.stats.as_dict()
    assert deliver_or_record(sched_t, None, None).units == sched_t.total


@pytest.mark.parametrize("codec", [None, "raw_fp32", "fp16", "int8_blockscale"])
@pytest.mark.parametrize("verify", [True, False])
def test_ship_equals_reference(codec, verify):
    r = np.random.default_rng(4)
    rows = {j: r.uniform(0.1, 2.0, 50).astype(np.float32) for j in range(3)}
    ups = {0: np.array([5, 1, 9], np.int32), 2: np.array([7, 3], np.int32)}
    plan = dict(seed=21, silent_corrupt={0: 0.6, 1: 0.3, 2: 0.8}, max_retries=2)
    for payloads, units in ((rows, 1), (ups, {0: 3, 2: 2})):
        tt, jt = (Transport(FaultPlan(**plan), verify=verify),
                  jfaults.Transport(jfaults.FaultPlan(**plan), verify=verify))
        tl, jl = CommLedger(), JLedger()
        got = tt.ship("dis/round1/G_j", payloads, tl, units=units, codec=codec,
                      drop_on_exhaust=True)
        want = jt.ship("dis/round1/G_j", payloads, jl, units=units, codec=codec,
                       drop_on_exhaust=True)
        assert sorted(got[0]) == sorted(want[0])
        for j in got[0]:
            assert np.asarray(got[0][j]).tobytes() == np.asarray(want[0][j]).tobytes()
            assert (got[0][j] is payloads[j]) == (want[0][j] is payloads[j])
        assert {p: dataclasses.astuple(d) for p, d in got[1].items()} == \
            {p: dataclasses.astuple(d) for p, d in want[1].items()}
        assert _msgs(tl) == _msgs(jl)
        assert tt.stats.as_dict() == jt.stats.as_dict()


# --------------------------------------------------------------------------
# builds through a transport
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["materialized", "streamed", "pipelined"])
@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_null_transport_bit_for_bit_transportless(engine, task):
    _, ds = _both(labels=task == "vrlr")
    _, key = _keys(5)
    led0 = CommLedger()
    cs0 = _tbuild(ds, key, ledger=led0, engine=engine, task=task)
    for policy in FAULT_POLICIES:
        for plan in (FaultPlan.none(), FaultPlan(seed=9)):
            led, tr = CommLedger(), Transport(plan)
            cs = _tbuild(ds, key, transport=tr, ledger=led, engine=engine, task=task,
                         policy=policy)
            assert _same(cs, cs0), policy
            assert (cs.comm_units, cs.comm_bits) == (cs0.comm_units, cs0.comm_bits)
            assert cs.degraded is None and _msgs(led) == _msgs(led0)
            assert tr.stats.silent_corrupts == 0 and tr.stats.retries == 0


def test_chaos_pin_port_and_reference():
    """Plan seed 123, drop 0.3 on ``tests/test_faults.py``'s data: the pinned
    294 units (230 base + 64 retry), 2 retries, 2 drops and the first six
    indices, from the port and from the reference in this layout."""
    jds, ds = _both()
    kj, kt = _keys(7)
    pins = []
    for build, ledger, tr in ((_tbuild, CommLedger(), Transport(FaultPlan(
            seed=123, drop=0.3, max_retries=6))), (_jbuild, JLedger(), jfaults.Transport(
                jfaults.FaultPlan(seed=123, drop=0.3, max_retries=6)))):
        cs = build(ds if build is _tbuild else jds, kt if build is _tbuild else kj,
                   transport=tr, ledger=ledger, policy="retry")
        pins.append((ledger.total, ledger.by_prefix("retry/"), tr.stats.retries,
                     tr.stats.drops, cs.comm_units, np.asarray(cs.indices)[:6].tolist()))
    assert pins[0] == pins[1] == (294, 64, 2, 2, 294, [140, 576, 86, 101, 422, 206])
    led, tr = CommLedger(), Transport(FaultPlan(seed=123, drop=0.3, max_retries=6))
    again = _tbuild(ds, kt, transport=tr, ledger=led, policy="retry")
    assert led.total == 294 and again.indices[:6].tolist() == pins[0][5]


@pytest.mark.parametrize("engine", ["materialized", "pipelined"])
def test_degrade_receipt_and_draw_match_reference(engine):
    jds, ds = _both()
    kj, kt = _keys(3)
    plan = dict(seed=0, drop={0: 1.0}, max_retries=2)
    tl, jl = CommLedger(), JLedger()
    cs = _tbuild(ds, kt, transport=Transport(FaultPlan(**plan)), ledger=tl,
                 engine=engine, policy="degrade")
    ref = _jbuild(jds, kj, transport=jfaults.Transport(jfaults.FaultPlan(**plan)),
                  ledger=jl, engine=engine, policy="degrade")
    assert isinstance(cs.degraded, DegradedBuild)
    assert _receipt(cs.degraded) == _receipt(ref.degraded)
    assert cs.degraded.describe() == ref.degraded.describe()
    assert cs.degraded.surviving == (1, 2) and cs.comm_units == tl.total
    _match_reference(cs, ref)
    assert _msgs(tl) == _msgs(jl)
    sub = _tbuild(ds.select_parties([1, 2]), kt, engine=engine)
    assert _same(cs, sub)


def _poison(mod, party, kind="sign"):
    """Party ``party`` silently corrupts every transmission on a wire that
    does not verify (``tests/test_integrity.py``'s ``_poison``)."""
    return mod.Transport(mod.FaultPlan(seed=11, silent_corrupt={party: 1.0},
                                       silent_kind=kind), verify=False)


@pytest.mark.parametrize("engine", ["materialized", "streamed", "pipelined"])
@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_quarantine_receipt_and_draw_match_reference(engine, task):
    jds, ds = _both(labels=task == "vrlr")
    kj, kt = _keys(3)
    tl, jl = CommLedger(), JLedger()
    cs = _tbuild(ds, kt, transport=_poison(tfaults, 0), ledger=tl, engine=engine,
                 task=task, policy="quarantine")
    ref = _jbuild(jds, kj, transport=_poison(jfaults, 0), ledger=jl, engine=engine,
                  task=task, policy="quarantine")
    assert _receipt(cs.degraded) == _receipt(ref.degraded)
    assert cs.degraded.surviving == (1, 2)
    assert "quarantined for integrity violations" in cs.degraded.describe()
    _match_reference(cs, ref)
    assert _msgs(tl) == _msgs(jl)
    sub = _tbuild(ds.select_parties([1, 2]), kt, engine=engine, task=task)
    assert _same(cs, sub)
    assert check_weights(cs.weights.numpy()) is None


def test_fail_and_label_party_raise_as_the_reference():
    jds, ds = _both()
    kj, kt = _keys(3)
    cases = [(dict(policy="fail"), 0, "party 0"),
             (dict(policy="quarantine"), 2, "label party")]
    for kw, party, match in cases:
        with pytest.raises(IntegrityError, match=match) as te:
            _tbuild(ds, kt, transport=_poison(tfaults, party), **kw)
        with pytest.raises(jint.IntegrityError) as je:
            _jbuild(jds, kj, transport=_poison(jfaults, party), **kw)
        assert str(te.value) == str(je.value)
    for policy in ("fail", "retry"):
        with pytest.raises(PartyUnavailable, match="party 1 unavailable"):
            _tbuild(ds, kt, transport=Transport(FaultPlan(seed=0, drop={1: 1.0},
                                                          max_retries=1)), policy=policy)
    with pytest.raises(PartyUnavailable):       # degrade cannot lose the labels
        _tbuild(ds, kt, transport=Transport(FaultPlan(seed=0, drop={2: 1.0},
                                                      max_retries=1)), policy="degrade")


def test_round2_corruption_retried_with_exact_billing():
    jds, ds = _both()
    kj, kt = _keys(3)
    base = _tbuild(ds, kt)
    plan = dict(seed=13, silent_corrupt=0.4, max_retries=16)
    tl, jl = CommLedger(), JLedger()
    tr = Transport(FaultPlan(**plan))
    jt = jfaults.Transport(jfaults.FaultPlan(**plan))
    cs = _tbuild(ds, kt, transport=tr, ledger=tl, policy="retry")
    ref = _jbuild(jds, kj, transport=jt, ledger=jl, policy="retry")
    assert _same(cs, base)
    assert tr.stats.silent_detected == tr.stats.silent_corrupts > 0
    assert tl.by_prefix("retry/") == tr.stats.units_retried
    assert cs.comm_units == base.comm_units + tl.by_prefix("retry/")
    _match_reference(cs, ref)
    assert _msgs(tl) == _msgs(jl) and tr.stats.as_dict() == jt.stats.as_dict()


@pytest.mark.parametrize("codec", ["fp16", "int8_blockscale"])
@pytest.mark.parametrize("engine", ["materialized", "pipelined"])
def test_codec_tables_through_a_transport_match_reference(codec, engine):
    """The round-1 table crosses the wire quantized: the port's delivered
    table is decode(encode(its own table)), billed at the packed bits; the
    draws and the bill equal the reference's (weights within one fp16
    rounding step under ``fp16``)."""
    jds, ds = _both()
    kj, kt = _keys(3)
    tl, jl = CommLedger(), JLedger()
    cs = _tbuild(ds, kt, transport=Transport(), ledger=tl, engine=engine, codec=codec)
    ref = _jbuild(jds, kj, transport=jfaults.Transport(), ledger=jl, engine=engine,
                  codec=codec)
    _match_reference(cs, ref, rtol=2**-10 if codec == "fp16" else 1e-4)
    assert _msgs(tl) == _msgs(jl)
    raw = _tbuild(ds, kt, transport=Transport(), engine=engine)
    assert cs.comm_units == raw.comm_units and cs.comm_bits < raw.comm_bits
    with pytest.raises(ValueError, match="without a transport nothing crosses it"):
        _tbuild(ds, kt, engine=engine, codec=codec)


def test_build_and_spec_refusals():
    _, ds = _both()
    _, kt = _keys(0)
    pipe = CoresetPipeline(ds)
    with pytest.raises(ValueError, match="batched engine bills its cells"):
        pipe.build(CoresetSpec(task="vrlr", budgets=(16,), engine="batched", backend="ref"),
                   key=kt, transport=Transport(), device="cpu")
    with pytest.raises(ValueError, match="fused jit path"):
        pipe.build(CoresetSpec(**_spec_kw(jit=True)), key=kt, transport=Transport(),
                   device="cpu")
    # codec="auto" resolves at plan time: raw_fp32 when no bit budget binds
    assert pipe.plan(CoresetSpec(**_spec_kw(codec="auto"))).codec == "raw_fp32"
    for bad in (dict(fault_policy="bogus"), dict(codec="zstd"),
                dict(engine="batched", fault_policy="retry"),
                dict(codec="fp16", jit=True), dict(codec="fp16", engine="batched")):
        with pytest.raises(ValueError) as te:
            CoresetSpec(task="vrlr", budgets=(16,), **bad)
        with pytest.raises(ValueError) as je:
            JSpec(task="vrlr", budgets=(16,), **bad)
        if "codec" in bad and bad["codec"] == "zstd":
            assert "codec must be one of" in str(te.value)
        else:
            assert str(te.value) == str(je.value)
    text = pipe.plan(CoresetSpec(**_spec_kw(policy="quarantine"))).describe()
    assert "fault_policy=quarantine" in text and "value validators on" in text


def test_select_parties_keeps_rows_device_and_labels():
    _, ds = _both()
    sub = ds.select_parties([0, 2])
    assert sub.dims == (3, 2) and sub.y is ds.y and sub.device == ds.device
    assert sub.parts[1] is ds.parts[2]
    assert ds.select_parties([0, 1]).y is None
    for bad, msg in (([], "at least one party"), ([3], "out of range"),
                     ([1, 1], "duplicate parties")):
        with pytest.raises(ValueError, match=msg):
            ds.select_parties(bad)
