"""The planner's memory, codec and cache axes and the engine failover: the
port's ``core/plan.py`` (``memory_model``, ``live_bytes``,
``MemoryWatchdog``, ``PlanCache``, ``compile_plan``), ``core/wire/budget.py``
and ``CoresetPipeline.build_failover``, restating the reference's planner,
codec, resilience and cache tests on the CPU, and held to the reference
from the same numpy data and keys.

Tolerances:

- Exact against the reference: ``predict_dis_bits``,
  ``predict_uniform_bits`` and ``choose_codec`` over a grid of (T, m,
  cells, codec, budget); ``compile_plan``'s engine, codec, predicted bits,
  bill, grid and failover chain for the same spec under a memory budget
  both models admit; the refusals' words.
- The memory model is the port's own, fitted to the card
  (``chip_smoke.py`` phase 12): the thresholds are its values, not the
  reference's.
- Bit for bit, within the port: a failover build against the forced
  build of the engine it fell back to, and its ledger against that
  build's plus one zero-unit ``fallback/`` entry.

Plans for a build on the card are compiled here with the planner's
device lookup pointed at a CUDA device that is never touched: planning
allocates nothing.
"""

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

import repro.core.plan as jplan
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core.wire import budget as jbudget
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    FAILOVER_LADDER, CommLedger, CoresetPipeline, CoresetSpec, Deadline,
    DeadlineExceeded, FailoverOutcome, FaultPlan, MemoryBudgetExceeded, MemoryWatchdog,
    PlanCache, SimClock, StreamCheckpoint, Transport, VFLDataset,
    build_coreset_streaming, compile_plan, live_bytes, memory_model)
from repro_torch.core import api as tapi
from repro_torch.core import plan as tplan
from repro_torch.core.plan import ENGINES, PLAN_KEY_EXEMPT, PLAN_KEY_FIELDS
from repro_torch.core.wire import (
    CODEC_LADDER, SPEC_CODECS, UNIT_BITS, choose_codec, get_codec, predict_dis_bits,
    predict_uniform_bits)

CARD = torch.device("cuda", 0)


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


def _data(seed, n, d=12, T=3):
    r = np.random.default_rng(seed)
    X = r.standard_normal((n, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + 0.1 * r.standard_normal(n)).astype(np.float32)
    jds = JDataset.from_dense(X, y, T=T)
    return jds, dataset_from_numpy([np.asarray(p) for p in jds.parts], y, "cpu")


def _ds(seed=0, n=512, dims=(3, 3)):
    """``tests/test_resilience.py``'s ``_ds`` on the port."""
    r = np.random.default_rng(seed)
    parts = [r.normal(size=(n, d)).astype(np.float32) for d in dims]
    y = r.normal(size=(n,)).astype(np.float32)
    return dataset_from_numpy(parts, y, "cpu")


def _key(seed):
    return key_from_numpy(np.asarray(jax.random.PRNGKey(seed)), "cpu")


def _plan(ds, **spec_kw):
    return CoresetPipeline(ds).plan(CoresetSpec(task="vrlr", budgets=64, **spec_kw))


def _same(a, b) -> bool:
    return (torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)
            and a.comm_units == b.comm_units)


@pytest.fixture
def card_planning(monkeypatch):
    """Plans (and build refusals) for a build on the card, with no card:
    the planner and the pipeline resolve ``"cuda"`` to a CUDA device they
    never allocate on."""
    def resolve(device="cuda"):
        d = torch.device(device)
        return CARD if d.type == "cuda" else d

    monkeypatch.setattr(tplan, "resolve_device", resolve)
    monkeypatch.setattr(tapi, "resolve_device", resolve)


# --------------------------------------------------------------------------
# tests/test_plan.py's planner tests, with the port's model values
# --------------------------------------------------------------------------

def test_auto_planner_threshold_flips():
    """materialized at its predicted bytes, pipelined one byte below,
    streamed one byte below the pipelined peak — the exact model values."""
    _, ds = _data(2, 4096)
    kw = dict(block_size=256, chunk_blocks=2)
    mm = _plan(ds, **kw).memory_model
    assert mm["streamed"] < mm["pipelined"] < mm["materialized"]
    at = lambda B: _plan(ds, memory_budget_bytes=B, **kw)
    assert at(mm["materialized"]).engine == "materialized"
    assert at(mm["materialized"] - 1).engine == "pipelined"
    assert at(mm["pipelined"]).engine == "pipelined"
    p = at(mm["pipelined"] - 1)
    assert p.engine == "streamed" and not p.budget_exceeded
    assert at(mm["streamed"]).engine == "streamed"
    tight = at(mm["streamed"] - 1)            # below even the streamed floor: flagged
    assert tight.engine == "streamed" and tight.budget_exceeded
    assert "EXCEEDS" in tight.describe()


def test_planner_no_budget_defaults_materialized():
    _, ds = _data(3, 500)
    plan = _plan(ds)
    assert plan.engine == "materialized"
    assert plan.predicted_peak_bytes == plan.memory_model["materialized"]


def test_planner_grid_forces_batched():
    _, ds = _data(4, 300)
    pipeline = CoresetPipeline(ds)
    plan = pipeline.plan(CoresetSpec(task="vrlr", budgets=(10, 20), num_seeds=3))
    assert plan.engine == "batched" and plan.grid == (3, 2)
    with pytest.raises(ValueError, match="grid"):
        pipeline.plan(CoresetSpec(task="vrlr", budgets=(10, 20), engine="materialized"))


def test_plan_predicted_comm_is_exact():
    """The DIS bill does not depend on the realised split, so the plan's
    prediction is the ledger's total on every single-cell engine."""
    _, ds = _data(8, 600)
    pipeline = CoresetPipeline(ds)
    for engine in ("materialized", "streamed", "pipelined"):
        plan = pipeline.plan(CoresetSpec(task="vrlr", budgets=40, engine=engine,
                                         block_size=128))
        led = CommLedger()
        cs = pipeline.build(plan, key=_key(9), ledger=led, device="cpu")
        assert led.total == plan.predicted_comm_units == cs.comm_units
        assert cs.comm_bits == led.total_bits == plan.predicted_wire_bits
    assert pipeline.plan(CoresetSpec(task="uniform", budgets=40)).predicted_comm_units \
        == 40 * ds.T


def test_memory_model_uniform_is_tiny():
    _, ds = _data(10, 5000)
    plan = CoresetPipeline(ds).plan(CoresetSpec(task="uniform", budgets=16,
                                                memory_budget_bytes=10_000))
    assert plan.engine == "materialized"            # nothing to stream
    assert plan.predicted_peak_bytes < 10_000


@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_memory_model_function_matches_plan(task):
    _, ds = _data(11, 2048)
    params = {"k": 6, "center_sample": 300} if task == "vkmc" else {}
    plan = CoresetPipeline(ds).plan(CoresetSpec(task=task, budgets=64, block_size=256,
                                                chunk_blocks=4, params=params))
    _, s = ds.stacked_widths(with_labels=task == "vrlr")
    mm = memory_model(plan.T, plan.n, s, 256, 4, 1, 1, plan.m_cap,
                      prefetch=plan.prefetch, k=6 if task == "vkmc" else 0,
                      center_sample=300)
    assert {e: mm[e] for e in ENGINES} == dict(plan.memory_model)
    # prefetch stages a second superchunk when there is a next one to stage
    # (at a width where the staged data, not the draw's log, is the peak)
    on = memory_model(3, 2048, 64, 256, 4, prefetch=True)
    off = memory_model(3, 2048, 64, 256, 4, prefetch=False)
    assert on["pipelined"] > off["pipelined"] and on["streamed"] == off["streamed"]
    one = memory_model(3, 2048, 64, 4096, 4, prefetch=True)   # one superchunk: one slot
    assert one["pipelined"] == memory_model(3, 2048, 64, 4096, 4, prefetch=False)[
        "pipelined"]


def test_auto_planner_never_drops_jit_silently():
    """jit=True under engine='auto' is refused when the memory model picks
    a streaming engine — the same refusal as the forced combination."""
    _, ds = _data(30, 4096)
    spec = CoresetSpec(task="vrlr", budgets=32, jit=True, block_size=256,
                       chunk_blocks=2, memory_budget_bytes=1)
    with pytest.raises(ValueError, match="jit"):
        CoresetPipeline(ds).plan(spec)
    loose = spec.replace(memory_budget_bytes=1 << 30)
    assert CoresetPipeline(ds).plan(loose).engine == "materialized"


def test_auto_planner_never_drops_sharded_masses_silently():
    _, ds = _data(31, 800)
    spec = CoresetSpec(task="vrlr", budgets=10, block_size=100,
                       sharded_masses=True)             # auto -> materialized
    with pytest.raises(ValueError, match="sharded_masses"):
        CoresetPipeline(ds).plan(spec)


# --------------------------------------------------------------------------
# the port's adaptation: a host dataset bound for the card
# --------------------------------------------------------------------------

def test_auto_plan_of_a_host_dataset_for_the_card_streams(card_planning):
    """Only the streaming engines read a CPU dataset from a card build, so
    ``auto`` picks pipelined (the card's prefetch on) or, under a budget
    below it, streamed, and says why; the chain starts at pipelined."""
    _, ds = _data(12, 4096)
    kw = dict(block_size=256, chunk_blocks=2)
    plan = _plan(ds, **kw)                          # the dataset's own device
    card = CoresetPipeline(ds).plan(CoresetSpec(task="vrlr", budgets=64, **kw), "cuda")
    assert plan.engine == "materialized" and plan.device.type == "cpu"
    assert card.engine == "pipelined" and card.device == CARD and card.prefetch
    assert card.backend == "pallas" and card.fallback_chain == ("streamed",)
    assert any("only the streamed and pipelined engines" in n for n in card.notes)
    mm = card.memory_model
    huge = CoresetPipeline(ds).plan(
        CoresetSpec(task="vrlr", budgets=64, memory_budget_bytes=mm["materialized"],
                    **kw), "cuda")
    assert huge.engine == "pipelined"                # never materialized
    tight = CoresetPipeline(ds).plan(
        CoresetSpec(task="vrlr", budgets=64, memory_budget_bytes=mm["pipelined"] - 1,
                    **kw), "cuda")
    assert tight.engine == "streamed" and not tight.budget_exceeded
    forced = CoresetPipeline(ds).plan(
        CoresetSpec(task="vrlr", budgets=64, engine="materialized", **kw), "cuda")
    assert forced.engine == "materialized"           # a forced engine is kept ...
    with pytest.raises(ValueError, match="only the streamed and pipelined"):
        CoresetPipeline(ds).build(forced, key=_key(0), device="cuda")   # ... and refused


def test_a_cpu_plan_is_refused_by_a_card_build_and_cached_apart(card_planning):
    _, ds = _data(13, 600)
    cache = PlanCache()
    pipe = CoresetPipeline(ds, plan_cache=cache)
    spec = CoresetSpec(task="vrlr", budgets=16, block_size=128)
    cpu_plan = pipe.plan(spec)
    card_plan = pipe.plan(spec, "cuda")
    assert (cache.misses, cache.hits, len(cache)) == (2, 0, 2)
    assert cpu_plan.device.type == "cpu" and card_plan.device == CARD
    assert pipe.plan(spec) is cpu_plan and pipe.plan(spec, "cuda") is card_plan
    assert cache.hits == 2
    with pytest.raises(ValueError, match="recompile"):
        pipe.build(cpu_plan, key=_key(0), device="cuda")
    assert PlanCache.key(spec, ds) != PlanCache.key(spec, ds, "cuda")


# --------------------------------------------------------------------------
# tests/test_wire.py's codec axis, and the bits against the reference
# --------------------------------------------------------------------------

def test_choose_codec_walks_the_ladder_fidelity_first():
    bits = {"raw_fp32": 1000, "fp16": 600, "int8_blockscale": 300}
    assert choose_codec("auto", None, bits) == ("raw_fp32", False, "")
    name, exceeded, note = choose_codec("auto", 700, bits)
    assert (name, exceeded) == ("fp16", False) and "fp16" in note
    name, exceeded, note = choose_codec("auto", 100, bits)
    assert (name, exceeded) == ("int8_blockscale", True) and "unmeetable" in note
    name, exceeded, note = choose_codec("fp16", 100, bits)
    assert (name, exceeded) == ("fp16", True) and "exceeds" in note


def test_predict_dis_bits_is_the_per_codec_wire_sum():
    T, m, cells = 3, 64, 1024
    for name in CODEC_LADDER:
        c = get_codec(name)
        want = (T * (c.wire_bits((cells,), "float32") + UNIT_BITS)
                + c.wire_bits((m,), "int32") + 2 * T * m * UNIT_BITS)
        assert predict_dis_bits(T, m, cells, name) == want
    assert predict_uniform_bits(T, m) == T * m * UNIT_BITS


def test_bit_predictions_and_codec_walk_equal_reference():
    for T in (1, 3, 7):
        for m in (1, 33, 1000):
            assert predict_uniform_bits(T, m) == jbudget.predict_uniform_bits(T, m)
            for cells in (1, 63, 64, 65, 4097, 463_715):
                bits = {}
                for name in CODEC_LADDER:
                    bits[name] = predict_dis_bits(T, m, cells, name)
                    assert bits[name] == jbudget.predict_dis_bits(T, m, cells, name)
                grid = sorted(set(bits.values()))
                for budget in [None, 1] + [b + d for b in grid for d in (-1, 0, 1)]:
                    for codec in ("auto",) + CODEC_LADDER:
                        assert choose_codec(codec, budget, bits) == \
                            jbudget.choose_codec(codec, budget, bits)


def test_spec_codec_validation():
    for bad in ("gzip", "delta_varint"):      # not a spec-selectable table format
        with pytest.raises(ValueError):
            CoresetSpec(task="vrlr", budgets=32, codec=bad)
    with pytest.raises(ValueError, match="jit"):
        CoresetSpec(task="vrlr", budgets=32, codec="fp16", jit=True)
    with pytest.raises(ValueError, match="batched"):
        CoresetSpec(task="vrlr", budgets=32, codec="int8_blockscale", engine="batched")
    for field in ("comm_budget_bits", "memory_budget_bytes"):
        for bad in (0, -5, 2.5, True):
            with pytest.raises(ValueError) as te:
                CoresetSpec(task="vrlr", budgets=32, **{field: bad})
            with pytest.raises(ValueError) as je:
                JSpec(task="vrlr", budgets=32, **{field: bad})
            assert str(te.value) == str(je.value) and field in str(te.value)
    assert "codec" in PLAN_KEY_FIELDS and "comm_budget_bits" in PLAN_KEY_FIELDS
    assert SPEC_CODECS == ("auto",) + CODEC_LADDER


def test_plan_predicts_bits_and_resolves_auto_codec():
    _, ds = _data(0, 1024)
    spec = CoresetSpec(task="vrlr", budgets=64, engine="materialized", backend="ref")
    plan = compile_plan(spec, ds)
    assert plan.codec == "raw_fp32"
    assert plan.predicted_wire_bits == predict_dis_bits(ds.T, 64, ds.n, "raw_fp32")
    assert "on the wire" in plan.describe()
    tight = predict_dis_bits(ds.T, 64, ds.n, "fp16")
    plan2 = compile_plan(spec.replace(codec="auto", comm_budget_bits=tight), ds)
    assert plan2.codec == "fp16" and not plan2.comm_budget_exceeded
    assert plan2.predicted_wire_bits == tight and "comm budget" in plan2.describe()
    plan3 = compile_plan(spec.replace(codec="auto", comm_budget_bits=1), ds)
    assert plan3.codec == "int8_blockscale" and plan3.comm_budget_exceeded


@pytest.mark.parametrize("codec", ["fp16", "int8_blockscale"])
def test_lossy_codec_requires_a_transport(codec):
    """Also through ``codec="auto"``: the resolved codec is what the build
    ships, and what it bills stays within the plan's prediction."""
    _, ds = _data(6, 200)
    spec = CoresetSpec(task="vrlr", budgets=16, engine="materialized", backend="ref",
                       codec=codec)
    with pytest.raises(ValueError, match="transport"):
        CoresetPipeline(ds).build(spec, key=_key(7), device="cpu")
    led = CommLedger()
    cs = CoresetPipeline(ds).build(spec, key=_key(7), ledger=led, device="cpu",
                                   transport=Transport(FaultPlan.none()))
    assert cs.comm_bits == led.total_bits
    assert (led.by_tag(bits=True)["dis/round1/G_j"]
            == ds.T * get_codec(codec).wire_bits((ds.n,), "float32"))
    auto = CoresetPipeline(ds).plan(spec.replace(
        codec="auto", comm_budget_bits=predict_dis_bits(ds.T, 16, ds.n, codec)))
    assert auto.codec == codec
    led2 = CommLedger()
    cs2 = CoresetPipeline(ds).build(auto, key=_key(7), ledger=led2, device="cpu",
                                    transport=Transport(FaultPlan.none()))
    assert _same(cs2, cs) and led2.by_tag(bits=True) == led.by_tag(bits=True)
    assert cs2.comm_bits <= auto.predicted_wire_bits


_SPECS = [
    dict(task="vrlr", budgets=48),
    dict(task="vrlr", budgets=48, memory_budget_bytes=1 << 40),
    dict(task="vkmc", budgets=48, params={"k": 4}),
    dict(task="uniform", budgets=48),
    dict(task="vrlr", budgets=48, engine="streamed"),
    dict(task="vrlr", budgets=48, engine="pipelined", chunk_blocks=3, prefetch=True),
    dict(task="vrlr", budgets=48, engine="pipelined", chunk_blocks=1, prefetch=False),
    dict(task="vrlr", budgets=48, engine="pipelined", chunk_blocks=100),
    dict(task="vkmc", budgets=48, engine="streamed", params={"k": 4}),
    dict(task="vrlr", budgets=(16, 48), num_seeds=2),
    dict(task="vrlr", budgets=48, jit=True, codec="auto", comm_budget_bits=1),
    dict(task="vrlr", budgets=48, engine="streamed", sharded_masses=True, block_size=100),
] + [dict(task=t, budgets=48, engine=e, codec="auto", comm_budget_bits=b)
     for t in ("vrlr", "uniform") for e in ("materialized", "pipelined")
     for b in (1, 50_000, 150_000, 10**9)] + [
    dict(task="vrlr", budgets=48, engine="streamed", codec=c, comm_budget_bits=9_000)
    for c in CODEC_LADDER]


@pytest.mark.parametrize("spec_kw", _SPECS)
def test_compile_plan_equals_reference(spec_kw):
    """Engine, codec, bits, bill, grid, knobs and failover chain: the
    reference's for the same spec (no memory budget, or one both models
    admit)."""
    jds, ds = _data(21, 800)
    kw = {"block_size": 128, **spec_kw}
    got = compile_plan(CoresetSpec(**kw), ds)
    want = jplan.compile_plan(JSpec(**kw), jds)
    assert (got.engine, got.codec, got.predicted_wire_bits, got.predicted_comm_units,
            got.comm_budget_exceeded, got.fallback_chain, got.grid, got.m_cap,
            got.chunk_blocks, got.prefetch, got.backend, got.budget_exceeded) == (
        want.engine, want.codec, want.predicted_wire_bits, want.predicted_comm_units,
        want.comm_budget_exceeded, want.fallback_chain, want.grid, want.m_cap,
        want.chunk_blocks, want.prefetch, want.backend, want.budget_exceeded)


# --------------------------------------------------------------------------
# tests/test_resilience.py's watchdog, ladder and failover
# --------------------------------------------------------------------------

def test_live_bytes_counts_tensors_once_per_storage():
    gc.collect()                     # no unreachable tensor awaiting collection
    before = live_bytes("cpu")
    keep = torch.zeros((256, 256), dtype=torch.float32)
    views = [keep[1:], keep.T, keep.view(-1)]     # views of one storage count once
    assert live_bytes("cpu") == before + keep.numel() * 4
    del views, keep
    assert live_bytes("cpu") == before


def test_watchdog_raises_with_census():
    wd = MemoryWatchdog(1, "cpu")
    keep = torch.zeros(64, dtype=torch.float32)       # anything live trips it
    with pytest.raises(MemoryBudgetExceeded) as ei:
        wd.check()
    assert ei.value.budget == 1 and ei.value.observed >= keep.numel() * 4
    assert wd.checks == 1 and wd.peak >= keep.numel() * 4
    with pytest.raises(ValueError):
        MemoryWatchdog(0, "cpu")
    roomy = MemoryWatchdog(live_bytes("cpu") + (1 << 30), "cpu")
    assert roomy() <= roomy.budget_bytes and roomy.checks == 1


def test_watchdog_without_a_baseline_keeps_the_absolute_check():
    """The reference's contract: no baseline, the whole census against the
    budget.  With a baseline only the bytes above it count; ``peak`` keeps
    the absolute census, ``own_peak`` the bytes above the baseline, and the
    refusal says which bytes it counted."""
    gc.collect()
    keep = torch.zeros(1 << 16, dtype=torch.float32)           # 256 KiB resident
    live = live_bytes("cpu")
    absolute = MemoryWatchdog(live - 1, "cpu")
    assert absolute.baseline == 0
    with pytest.raises(MemoryBudgetExceeded) as ei:
        absolute.check()
    assert ei.value.baseline == 0 and ei.value.observed >= keep.numel() * 4
    assert str(ei.value).startswith(f"live device bytes {ei.value.observed} exceed")
    own = MemoryWatchdog(1 << 20, "cpu", baseline=live)
    assert own() <= 0 and own.own_peak <= 0 and own.peak >= keep.numel() * 4
    extra = torch.ones(1 << 19, dtype=torch.float32)            # 2 MiB above it
    with pytest.raises(MemoryBudgetExceeded) as ei:
        own.check()
    assert ei.value.baseline == live and ei.value.observed >= extra.numel() * 4
    assert f"less a baseline of {live} resident before it" in str(ei.value)
    assert own.own_peak >= extra.numel() * 4 and own.peak >= live + extra.numel() * 4
    with pytest.raises(ValueError, match="baseline"):
        MemoryWatchdog(1, "cpu", baseline=-1)
    del keep, extra


@pytest.mark.parametrize("engine", ["materialized", "pipelined"])
def test_a_build_under_its_own_prediction_makes_no_attempt(engine):
    """The budget means the build's own bytes on both sides: a build under
    a budget equal to its plan's ``predicted_peak_bytes`` keeps its engine,
    with tensors resident before it that are larger than that budget."""
    ds = _ds(5, n=2048)
    resident = torch.zeros(1 << 24, dtype=torch.float32)          # 64 MiB
    for task in ("vrlr", "vkmc"):
        params = ({} if task == "vrlr" else {"k": 4} if engine == "materialized"
                  else {"k": 4, "center_sample": 512})
        spec = CoresetSpec(task=task, budgets=48, engine=engine, block_size=256,
                           chunk_blocks=4, prefetch=engine == "pipelined", params=params)
        pipe = CoresetPipeline(ds)
        pred = pipe.plan(spec, "cpu").predicted_peak_bytes
        assert pred < resident.numel() * 4
        gc.collect()
        out = pipe.build_failover(spec, key=_key(6), memory_budget_bytes=pred,
                                  device="cpu")
        assert out.attempts == () and out.engine == engine and out.fallback is None
    del resident


def test_a_resident_tensor_changes_neither_the_engine_nor_a_trip():
    """64 MiB allocated before the build: the engine a budget selects is
    the same, and so is whether ``build_failover``'s watchdog trips — it
    does not at the pipelined prediction, it does at one byte."""
    ds = _ds(7, n=2048)
    base = dict(task="vrlr", budgets=48, block_size=256, chunk_blocks=4, prefetch=True)
    mm = CoresetPipeline(ds).plan(CoresetSpec(**base), "cpu").memory_model

    def outcome():
        pipe = CoresetPipeline(ds)
        engines = [pipe.plan(CoresetSpec(memory_budget_bytes=B, **base), "cpu").engine
                   for B in (mm["materialized"], mm["pipelined"], mm["streamed"])]
        forced = CoresetSpec(engine="pipelined", **base)
        runs = []
        for B in (mm["pipelined"], 1):
            gc.collect()
            led = CommLedger()
            out = pipe.build_failover(forced, key=_key(8), ledger=led,
                                      memory_budget_bytes=B, device="cpu")
            runs.append((out.fallback, [a.engine for a in out.attempts], led.total,
                         out.coreset.indices.tolist(), out.coreset.weights.tolist()))
        return engines, runs

    alone = outcome()
    resident = torch.zeros(1 << 24, dtype=torch.float32)          # 64 MiB
    with_resident = outcome()
    del resident
    assert alone == with_resident
    engines, runs = alone
    assert engines == ["materialized", "pipelined", "streamed"]
    assert runs[0][:2] == (None, []) and runs[1][:2] == ("pipelined->streamed",
                                                        ["pipelined"])
    assert runs[0][3] == runs[1][3]               # the streamed rung, bit for bit


def test_fallback_chain_follows_ladder():
    ds = _ds(0)
    chains = {}
    for engine in ("materialized", "pipelined", "streamed", "batched"):
        spec = CoresetSpec(task="vrlr", budgets=16, engine=engine, block_size=64,
                           chunk_blocks=4, num_seeds=2 if engine == "batched" else 1)
        chains[engine] = compile_plan(spec, ds).fallback_chain
    assert chains == {"materialized": ("pipelined", "streamed"),
                      "pipelined": ("streamed",), "streamed": (), "batched": ()}
    jspec = CoresetSpec(task="vrlr", budgets=16, engine="materialized", block_size=64,
                        jit=True)
    assert compile_plan(jspec, ds).fallback_chain == ()
    assert FAILOVER_LADDER == ("materialized", "pipelined", "streamed")


def test_failover_draw_identity_and_ledger_bill():
    """A pipelined build over its memory budget falls back to streamed bit
    for bit; the ledger is the streamed build's bill plus a zero-unit
    ``fallback/`` entry."""
    ds = _ds(1)
    key = _key(3)
    spec = CoresetSpec(task="vrlr", budgets=24, engine="pipelined", block_size=64,
                       chunk_blocks=2)
    led = CommLedger()
    out = CoresetPipeline(ds).build_failover(spec, key=key, ledger=led,
                                             memory_budget_bytes=1, device="cpu")
    assert isinstance(out, FailoverOutcome)
    assert out.fallback == "pipelined->streamed" and out.engine == "streamed"
    assert out.attempts[0].engine == "pipelined"
    assert "MemoryBudgetExceeded" in out.attempts[0].error
    assert any("failover: pipelined -> streamed" in n for n in out.plan.notes)
    led_ref = CommLedger()
    ref = build_coreset_streaming("vrlr", ds, 24, key=key, block_size=64, ledger=led_ref,
                                  device="cpu")
    assert _same(out.coreset, ref) and led.total == led_ref.total
    fb = {t: u for t, u in led.by_tag().items() if t.startswith("fallback/")}
    assert fb == {"fallback/pipelined->streamed": 0}
    rest = {t: u for t, u in led.by_tag().items() if not t.startswith("fallback/")}
    assert rest == led_ref.by_tag()


def test_failover_noop_when_first_engine_succeeds():
    ds = _ds(2)
    spec = CoresetSpec(task="vrlr", budgets=16, engine="pipelined", block_size=64,
                       chunk_blocks=2)
    led = CommLedger()
    out = CoresetPipeline(ds).build_failover(spec, key=_key(0), ledger=led, device="cpu")
    assert out.fallback is None and out.attempts == ()
    assert led.by_prefix("fallback/") == 0
    assert not any("failover" in n for n in out.plan.notes)


def test_failover_passes_engine_independent_errors_through():
    """Deadline and spec errors must not burn ladder rungs."""
    ds = _ds(3)
    spec = CoresetSpec(task="vrlr", budgets=16, engine="pipelined", block_size=64,
                       chunk_blocks=2)
    c = SimClock(tick=1.0)
    dl = Deadline.after(c, 0.5)
    led = CommLedger()
    with pytest.raises(DeadlineExceeded):
        CoresetPipeline(ds).build_failover(spec, key=_key(0), ledger=led, device="cpu",
                                           probe=lambda: dl.check(c, "leaf"))
    assert led.total == 0                  # rolled back, no fallback entry
    with pytest.raises(ValueError, match="requires labels"):
        CoresetPipeline(VFLDataset(ds.parts, None)).build_failover(
            spec, key=_key(0), device="cpu")


def test_failover_walks_every_rung_and_hands_the_checkpoint_to_streaming_rungs():
    """A materialized build over budget, then a pipelined one, then the
    streamed last rung without the watchdog; the checkpoint rides only the
    streaming rungs and is cleared by the one that finishes.  A crash (not
    a breach) fails over the same way, and one on the last rung raises."""
    ds = _ds(4)
    key = _key(5)
    spec = CoresetSpec(task="vrlr", budgets=16, engine="materialized", block_size=64,
                       chunk_blocks=2)
    ck = StreamCheckpoint()
    led = CommLedger()
    out = CoresetPipeline(ds).build_failover(spec, key=key, ledger=led, checkpoint=ck,
                                             memory_budget_bytes=1, device="cpu")
    assert [a.engine for a in out.attempts] == ["materialized", "pipelined"]
    assert out.fallback == "materialized->streamed"
    assert led.by_tag()["fallback/pipelined->streamed"] == 0
    assert ck.saves > 0 and ck.signature is None
    ref = CoresetPipeline(ds).build(spec.replace(engine="streamed"), key=key,
                                    device="cpu")
    assert _same(out.coreset, ref)

    class Once:
        calls = 0

        def __call__(self):
            Once.calls += 1
            if Once.calls == 1:
                raise RuntimeError("engine lost")

    p = spec.replace(engine="pipelined")
    out = CoresetPipeline(ds).build_failover(p, key=key, probe=Once(), device="cpu")
    assert out.fallback == "pipelined->streamed"
    assert out.attempts[0].error == "RuntimeError: engine lost"
    assert _same(out.coreset, ref)

    def always():
        raise RuntimeError("engine lost")

    with pytest.raises(RuntimeError, match="engine lost"):
        CoresetPipeline(ds).build_failover(p, key=key, probe=always, device="cpu")


# --------------------------------------------------------------------------
# the plan cache: LRU, aging, the key audit
# --------------------------------------------------------------------------

def test_plan_cache_lru_evicts_at_capacity():
    ds = _ds(n=200)
    pc = PlanCache(max_entries=2)
    specs = [CoresetSpec(task="vrlr", budgets=8 + i, backend="ref", block_size=128)
             for i in range(3)]
    for sp in specs:
        pc.get(sp, ds)
    s = pc.stats()
    assert {k: s[k] for k in ("size", "max_entries", "hits", "misses", "evictions")} == {
        "size": 2, "max_entries": 2, "hits": 0, "misses": 3, "evictions": 1}
    assert s["oldest_idle_s"] >= s["newest_idle_s"] >= 0.0
    pc.get(specs[2], ds)                     # the newest entry: a hit
    assert pc.hits == 1
    pc.get(specs[0], ds)                     # the evicted entry: a miss again
    assert pc.misses == 4
    with pytest.raises(ValueError, match="max_entries must be a positive"):
        PlanCache(max_entries=0)


def test_plan_cache_prune_by_idle_age():
    t = [0.0]
    pc = PlanCache(time_fn=lambda: t[0])
    ds_a, ds_b = _ds(0, n=256), _ds(0, n=512)
    spec = CoresetSpec(task="vrlr", budgets=8, engine="streamed", block_size=64)
    pc.get(spec, ds_a)
    t[0] = 10.0
    pc.get(spec, ds_b)
    t[0] = 15.0
    assert pc.prune(max_idle_s=8.0) == 1          # only ds_a is stale
    assert len(pc) == 1 and pc.evictions == 1
    s = pc.stats()
    assert s["oldest_idle_s"] == 5.0 and s["newest_idle_s"] == 5.0
    pc.get(spec, ds_b)                            # still cached
    assert pc.hits == 1
    pc.clear()
    assert len(pc) == 0 and pc.stats()["oldest_idle_s"] == 0.0
    with pytest.raises(ValueError):
        pc.prune(-1.0)


def test_plan_cache_key_audits_every_spec_field():
    """Every CoresetSpec field is in the cache key (PLAN_KEY_FIELDS or the
    task/params pair) or explicitly exempt, as in the reference; the key
    also holds the build's and the dataset's devices."""
    fields = {f.name for f in dataclasses.fields(CoresetSpec)}
    covered = {"task", "params"} | set(PLAN_KEY_FIELDS) | set(PLAN_KEY_EXEMPT)
    assert fields == covered, sorted(fields ^ covered)
    assert fields == {f.name for f in dataclasses.fields(JSpec)}
    assert PLAN_KEY_FIELDS == jplan.PLAN_KEY_FIELDS
    ds = _ds(n=64)
    spec = CoresetSpec(task="vrlr", budgets=32, backend="ref", block_size=128)
    a = PlanCache.key(spec, ds)
    assert PlanCache.key(spec, ds) == a == PlanCache.key(spec, ds, "cpu")
    assert "cpu" in a[:6]
    assert PlanCache.key(spec.replace(fault_policy="quarantine"), ds) != a
    assert PlanCache.key(spec.replace(budgets=33), ds) != a
    assert PlanCache.key(spec.replace(memory_budget_bytes=10), ds) != a
    assert PlanCache.key(spec.replace(codec="auto", comm_budget_bits=10), ds) != a


def test_pipeline_plans_through_its_cache():
    ds = _ds(n=300)
    cache = PlanCache()
    pipe = CoresetPipeline(ds, plan_cache=cache)
    spec = CoresetSpec(task="vrlr", budgets=16, engine="streamed", block_size=64)
    first = pipe.plan(spec)
    assert pipe.plan(spec) is first and (cache.hits, cache.misses) == (1, 1)
    cs = pipe.build(spec, key=_key(1), device="cpu")       # through the cache too
    assert cache.hits == 2 and cs.comm_units == first.predicted_comm_units
