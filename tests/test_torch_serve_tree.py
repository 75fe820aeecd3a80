"""The merge-and-reduce serving tree of the port (``repro_torch.serve.tree``)
and the ``MaterializedCoreset`` it keeps, on the CPU.

The first part restates ``tests/test_serve_tree.py`` against the port at
its sizes: leaf draw-identity, the insert census (no full-data rescore),
ledger composition and insert-order invariance, global index integrity,
query determinism, and the rel_error of a height-h tree against the flat
equal-budget build.  The second holds the port to the reference
(``repro.serve``, ``backend="ref"``) on the same numpy chunks and keys:

- ``vrlr`` and ``uniform`` trees: indices, bills (units and bits), the
  insert census exact; weights at ``rtol=1e-5`` (the streamed and
  pipelined reference engines are not bitwise equal on this toolchain,
  ROADMAP queue 3 B.2).
- ``merge_reduce`` on the reference's own children, carried across by
  ``materialized_from_numpy``: indices and bills exact, weights at
  ``rtol=1e-5``.
- ``vkmc`` by quality: the merged node's ``rel_error`` within an absolute
  2e-3 of the reference node's, both fit by the port's k-means with one
  key (``tests/test_torch_vkmc_slice.py``'s ``REL_GAP``), since local
  Lloyd amplifies fp differences.
- ``MaterializedCoreset.concat`` / ``from_coreset`` refusals word for word.

Within the port, leaves are bit for bit the direct pipelined builds, and a
failed insert retried with a ``StreamCheckpoint``, or a leaf that fails
over to the streamed engine, is bit for bit the undisturbed tree.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import VFLDataset as JDataset
from repro.core.api import build_coreset as j_build_coreset
from repro.core.coreset import MaterializedCoreset as JMaterialized
from repro.serve import CoresetTree as JTree
from repro.serve import merge_reduce as j_merge_reduce
from repro_torch import rng
from repro_torch.convert import (
    dataset_from_numpy, key_from_numpy, materialized_from_numpy)
from repro_torch.core import (
    CommLedger, CommSchedule, MaterializedCoreset, PlanCache, StreamCheckpoint,
    VFLDataset, build_coreset, build_coreset_streaming, evaluate, fit_kmeans, fit_ridge,
    full_data_coreset)
from repro_torch.serve import CoresetTree, merge_reduce

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


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _key(seed):
    return rng.PRNGKey(seed)


def _chunks(seed, num, rows, dims=(3, 2), labels=True):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        parts = [r.normal(size=(rows, d)).astype(np.float32) for d in dims]
        theta = np.linspace(1.0, -1.0, dims[0]).astype(np.float32)
        y = (parts[0] @ theta
             + 0.1 * r.normal(size=rows).astype(np.float32)) if labels else None
        out.append((parts, y))
    return out


def _stream_ds(chunks):
    """The dense view of the whole stream (what the tree never re-reads)."""
    T = len(chunks[0][0])
    parts = [np.concatenate([c[0][j] for c in chunks]) for j in range(T)]
    y = None if chunks[0][1] is None else np.concatenate([c[1] for c in chunks])
    return dataset_from_numpy(parts, y, CPU)


def _tree(task, budget, seed, **kw):
    kw.setdefault("block_size", BLOCK)
    return CoresetTree(task, budget, key=_key(seed), device=CPU, **kw)


def _same_node(a, b):
    return (np.array_equal(a.indices, b.indices) and np.array_equal(a.weights, b.weights)
            and all(np.array_equal(p, q) for p, q in zip(a.parts, b.parts))
            and (a.comm_units, a.comm_bits) == (b.comm_units, b.comm_bits))


# -- leaves ------------------------------------------------------------------


@pytest.mark.parametrize("task,params", [("vrlr", {}), ("vkmc", {"k": 3})])
def test_leaf_draw_identical_to_direct_pipelined_build(task, params):
    labels = task == "vrlr"
    chunks = _chunks(0, 2, 400, labels=labels)
    # replay each even leaf directly through the streaming shim with
    # leaf_key(i) (leaves build at node_budget = headroom * budget); an odd
    # leaf is merged away as soon as it lands
    for i, (parts, y) in enumerate(chunks):
        ds = dataset_from_numpy(parts, y, CPU)
        led = CommLedger()
        t2 = _tree(task, 48, 5, params=params)
        for parts2, y2 in chunks[: i + 1]:
            t2.insert(parts2, y2)
        direct = build_coreset_streaming(task, ds, t2.node_budget, key=t2.leaf_key(i),
                                         block_size=BLOCK, ledger=led, device=CPU,
                                         **params)
        if i % 2 == 0:          # even leaf index -> still at level 0
            leaf = t2.levels[0].cs
            np.testing.assert_array_equal(direct.indices.numpy() + i * 400, leaf.indices)
            np.testing.assert_array_equal(direct.weights.numpy(), leaf.weights)
            assert direct.comm_units == led.total == leaf.comm_units
        else:
            assert t2.levels[0] is None and t2.levels[1].chunks == 2


def test_leaf_rows_match_stream_rows():
    chunks = _chunks(1, 3, 300)
    stream = _stream_ds(chunks)
    tree = _tree("vrlr", 32, 0)
    for parts, y in chunks:
        tree.insert(parts, y)
    q = tree.query()
    for j in range(stream.T):
        np.testing.assert_array_equal(stream.parts[j].numpy()[q.indices], q.parts[j])
    np.testing.assert_array_equal(stream.y.numpy()[q.indices], q.y)
    assert (q.weights > 0).all()
    assert q.indices.dtype == np.int64 and q.weights.dtype == np.float32


# -- insert census: never a full-data rescore --------------------------------


def test_insert_census_o_log_n():
    m = 32
    tree = _tree("vrlr", m, 2)
    nb = tree.node_budget            # headroom * m rows per node
    assert nb == 2 * m
    total_rows = 0
    for i, (parts, y) in enumerate(_chunks(3, 9, 250)):
        stats = tree.insert(parts, y)
        total_rows += 250
        # binary-counter carry bound: #merges = #trailing ones of i
        carries = bin(i)[2:][::-1]
        expect = len(carries) - len(carries.lstrip("1"))
        assert stats.merges == expect
        assert stats.merges <= math.floor(math.log2(i + 1)) + 1
        assert stats.leaf_builds == 1
        # census: the chunk itself + one 2-node union per merge — NEVER n_total
        assert stats.rescored_rows == 250 + 2 * nb * stats.merges
        if i > 0:
            assert stats.rescored_rows < total_rows
        assert stats.height_after == tree.height
    assert tree.n_total == total_rows
    assert tree.num_chunks == 9
    # 9 = 0b1001 -> two occupied levels
    assert tree.num_nodes == 2 and tree.m_active == 2 * nb


def test_insert_comm_delta_is_exact():
    """Each insert's ledger delta = leaf DIS + per-merge (merge + DIS),
    all at node_budget = headroom * m."""
    m, T = 40, 2
    nb = 2 * m                       # default headroom
    leaf_bill = CommSchedule.dis_total(T, nb)
    merge_bill = CommSchedule.merge(T, nb, nb).total + leaf_bill
    tree = _tree("vrlr", m, 3)
    assert tree.node_budget == nb
    for parts, y in _chunks(4, 4, 200):
        stats = tree.insert(parts, y)
        assert stats.comm_delta == leaf_bill + stats.merges * merge_bill
    assert tree.ledger.total == 4 * leaf_bill + 3 * merge_bill
    # the root node's composed comm_units equals the whole ledger
    assert tree.query().comm_units == tree.ledger.total


# -- merge_reduce semantics --------------------------------------------------


def test_merge_reduce_folds_weights_and_composes_comm():
    chunks = _chunks(5, 2, 300)
    mats, led = [], CommLedger()
    for i, (parts, y) in enumerate(chunks):
        ds = dataset_from_numpy(parts, y, CPU)
        cs = build_coreset("vrlr", ds, 30, key=_key(i), backend="ref", device=CPU)
        mats.append(MaterializedCoreset.from_coreset(cs, ds, offset=300 * i))
    merged = merge_reduce("vrlr", mats, 30, key=_key(9), ledger=led, backend="ref",
                          device=CPU)
    assert merged.m == 30 and merged.T == mats[0].T
    assert (merged.weights > 0).all()
    # global ids come from the union, rows gathered consistently
    stream = _stream_ds(chunks)
    for j in range(stream.T):
        np.testing.assert_array_equal(stream.parts[j].numpy()[merged.indices],
                                      merged.parts[j])
    # billing: Thm 2.5 consume for both children + the union re-sample DIS
    T = mats[0].T
    assert led.by_prefix("merge/") == 2 * (30 + 30) * T
    assert led.total == 2 * 60 * T + CommSchedule.dis_total(T, 30)
    assert merged.comm_units == mats[0].comm_units + mats[1].comm_units + led.total


def test_merge_reduce_uniform_task():
    chunks = _chunks(6, 2, 200, labels=False)
    mats = []
    for i, (parts, _) in enumerate(chunks):
        ds = dataset_from_numpy(parts, None, CPU)
        cs = build_coreset("uniform", ds, 25, key=_key(i), backend="ref", device=CPU)
        mats.append(MaterializedCoreset.from_coreset(cs, ds, offset=200 * i))
    merged = merge_reduce("uniform", mats, 25, key=_key(1), device=CPU)
    assert merged.m == 25 and (merged.weights > 0).all()


def test_tree_rejects_bad_inputs():
    tree = _tree("vrlr", 16, 0, block_size=65536)
    with pytest.raises(ValueError):
        tree.query()
    with pytest.raises(ValueError):
        CoresetTree("vrlr", 0, key=_key(0), device=CPU)
    with pytest.raises(ValueError):
        CoresetTree("vrlr", 16, key=_key(0), headroom=0, device=CPU)
    with pytest.raises(ValueError):
        tree.insert([np.zeros((0, 2), np.float32)])


# -- determinism -------------------------------------------------------------


def test_query_deterministic_until_next_insert():
    tree = _tree("vrlr", 24, 8)
    chunks = _chunks(7, 3, 220)
    for parts, y in chunks[:2]:
        tree.insert(parts, y)
    q1 = tree.query(reduce_to=24)
    q2 = tree.query(reduce_to=24)
    np.testing.assert_array_equal(q1.indices, q2.indices)
    np.testing.assert_array_equal(q1.weights, q2.weights)
    tree.insert(*chunks[2])
    q3 = tree.query(reduce_to=24)
    assert not np.array_equal(q1.indices, q3.indices[: q1.m]) or \
        tree.num_chunks == 2  # key advanced with the insert count


def test_tree_replays_exactly():
    chunks = _chunks(9, 5, 180)

    def run():
        t = _tree("vrlr", 20, 4, plan_cache=PlanCache())
        for parts, y in chunks:
            t.insert(parts, y)
        return t.query(reduce_to=20)
    a, b = run(), run()
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.comm_units == b.comm_units


# -- ledger: insert order never changes the composed total -------------------


def _ordered_total(order):
    r = np.random.default_rng(0)
    t = _tree("vrlr", 16, 1)
    for rows in order:
        parts = [r.normal(size=(rows, d)).astype(np.float32) for d in (3, 2)]
        y = r.normal(size=(rows,)).astype(np.float32)
        t.insert(parts, y)
    return t.ledger.total


def test_ledger_insert_order_invariance():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(st.lists(st.sampled_from([120, 180, 240]), min_size=1, max_size=5),
           st.randoms(use_true_random=False))
    @settings(database=None, max_examples=8, deadline=None)
    def prop(sizes, rnd):
        perm = list(sizes)
        rnd.shuffle(perm)
        # the composed bill depends only on (chunk count, budget, T) — the
        # leaf DIS bill is chunk-size-free and the carry chain is
        # count-determined — so any permutation of sizes bills identically
        assert _ordered_total(sizes) == _ordered_total(perm)

    prop()


def test_ledger_insert_order_invariance_fixed():
    """Three fixed permutations of mixed chunk sizes compose to the same
    ledger total."""
    sizes = [120, 240, 180, 120, 240]
    totals = {_ordered_total(sizes), _ordered_total(sizes[::-1]),
              _ordered_total([240, 120, 120, 240, 180])}
    assert len(totals) == 1


# -- end-to-end: tree vs flat build ------------------------------------------


@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_tree_rel_error_degrades_gracefully(task):
    """A height-h tree's reduced query stays usable: its full-data rel_error
    is within a constant factor of the flat equal-budget batch build (the
    reference's small-n bounds; its 2x gate at n=1e5 is benchmarks/serve.py's)."""
    labels = task == "vrlr"
    chunks = _chunks(11, 8, 1500, dims=(4, 3), labels=labels)
    stream = _stream_ds(chunks)
    m = 256
    params = {} if labels else {"k": 4}
    tree = _tree(task, m, 6, block_size=1024, params=params)
    for parts, y in chunks:
        tree.insert(parts, y)
    q = tree.query(reduce_to=m)
    flat = build_coreset(task, stream, m, key=_key(60), backend="ref", device=CPU,
                         **params)
    kev = _key(7)
    if task == "vrlr":
        base = fit_ridge(stream, full_data_coreset(stream), 0.1).params
        r_tree = evaluate(stream, fit_ridge(stream, q.coreset(CPU), 0.1),
                          baseline=base).rel_error
        r_flat = evaluate(stream, fit_ridge(stream, flat, 0.1), baseline=base).rel_error
    else:
        base = fit_kmeans(stream, full_data_coreset(stream), 4, key=kev, restarts=3,
                          backend="ref").params
        r_tree = evaluate(stream, fit_kmeans(stream, q.coreset(CPU), 4,
                                             key=rng.fold_in(kev, 1), restarts=3,
                                             backend="ref"),
                          baseline=base).rel_error
        r_flat = evaluate(stream, fit_kmeans(stream, flat, 4, key=rng.fold_in(kev, 2),
                                             restarts=3, backend="ref"),
                          baseline=base).rel_error
    assert r_tree < 0.25
    assert r_tree <= max(8.0 * max(r_flat, 0.0), 0.05)


# -- within the port: crash safety and leaf failover ---------------------------


def test_failed_insert_rolls_back_and_resumes_from_its_checkpoint():
    """A probe that kills the third insert's leaf mid-scan leaves the tree
    as it was before that insert (levels, counters, ledger); the retry with
    the tree's StreamCheckpoint resumes the leaf and lands bit for bit on a
    never-failed tree."""
    chunks = _chunks(12, 3, 700)
    ref = _tree("vrlr", 20, 3)
    for parts, y in chunks:
        ref.insert(parts, y)
    ck = StreamCheckpoint()
    tree = _tree("vrlr", 20, 3, checkpoint=ck)
    for parts, y in chunks[:2]:
        tree.insert(parts, y)
    before = (list(tree.levels), tree.num_chunks, tree.n_total, tree._merge_ops,
              tree.ledger.total, tree.ledger.mark())
    calls = [0]

    def killer():
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("killed mid-scan")

    with pytest.raises(RuntimeError, match="killed mid-scan"):
        tree.insert(*chunks[2], probe=killer)
    after = (list(tree.levels), tree.num_chunks, tree.n_total, tree._merge_ops,
             tree.ledger.total, tree.ledger.mark())
    assert after == before and ck.saves > 0
    tree.insert(*chunks[2])
    assert ck.resumes > 0 and ck.signature is None
    assert tree.ledger.messages == ref.ledger.messages
    for a, b in zip(tree.levels, ref.levels):
        assert (a is None) == (b is None)
        if a is not None:
            assert _same_node(a.cs, b.cs)


def test_leaf_failover_is_bit_for_bit_the_undisturbed_tree():
    """Under a one-byte budget every pipelined leaf trips its watchdog and
    falls back to the streamed engine: the nodes are the undisturbed
    tree's bit for bit, and the ledger is its bill plus one 0-unit
    ``fallback/`` entry a leaf."""
    chunks = _chunks(13, 3, 600)
    ref = _tree("vrlr", 20, 2, chunk_blocks=2)
    tree = _tree("vrlr", 20, 2, chunk_blocks=2, failover=True, memory_budget_bytes=1)
    for parts, y in chunks:
        ref.insert(parts, y)
        stats = tree.insert(parts, y)
        assert stats.fallback == "pipelined->streamed"
    assert tree.fallbacks == 3 and tree.last_fallback == "pipelined->streamed"
    assert tree.ledger.by_tag().get("fallback/pipelined->streamed") == 0
    assert tree.ledger.total == ref.ledger.total
    rest = [(m.tag, m.src, m.dst, m.units) for m in tree.ledger.messages
            if not m.tag.startswith("fallback/")]
    assert rest == [(m.tag, m.src, m.dst, m.units) for m in ref.ledger.messages]
    assert sum(m.tag.startswith("fallback/") for m in tree.ledger.messages) == 3
    for a, b in zip(tree.levels, ref.levels):
        assert (a is None) == (b is None)
        if a is not None:
            assert _same_node(a.cs, b.cs)


# -- against the reference -----------------------------------------------------


def _reference_tree(task, inserts):
    """The reference tree of the cross-package tests (chunks of 300 rows,
    budget 24): the same shapes in every test, so XLA compiles them once."""
    chunks = _chunks(14, 4, 300, labels=task == "vrlr")
    jkey = jax.random.PRNGKey(21)
    jt = JTree(task, 24, key=jkey, block_size=BLOCK, backend="ref")
    for parts, y in chunks[:inserts]:
        jt.insert(parts, y)
    return jt, chunks, key_from_numpy(np.asarray(jkey), CPU)


@pytest.mark.parametrize("task", ["vrlr", "uniform"])
def test_tree_matches_reference(task):
    jt, chunks, tkey = _reference_tree(task, 0)
    tt = CoresetTree(task, 24, key=tkey, block_size=BLOCK, backend="ref", device=CPU)
    for parts, y in chunks:
        js, ts = jt.insert(parts, y), tt.insert(parts, y)
        assert (ts.chunk_rows, ts.merges, ts.rescored_rows, ts.comm_delta,
                ts.height_after) == (js.chunk_rows, js.merges, js.rescored_rows,
                                     js.comm_delta, js.height_after)
    assert (tt.ledger.total, tt.ledger.total_bits) == (jt.ledger.total, jt.ledger.total_bits)
    assert tt.ledger.by_tag() == jt.ledger.by_tag()
    for q_t, q_j in ((tt.query(), jt.query()),
                     (tt.query(reduce_to=24), jt.query(reduce_to=24))):
        np.testing.assert_array_equal(q_t.indices, np.asarray(q_j.indices))
        np.testing.assert_allclose(q_t.weights, np.asarray(q_j.weights), rtol=1e-5)
        for pt, pj in zip(q_t.parts, q_j.parts):
            np.testing.assert_array_equal(pt, np.asarray(pj))
        assert (q_t.comm_units, q_t.comm_bits) == (q_j.comm_units, q_j.comm_bits)
    assert tt.describe().replace(f" device={tt.device}", "") == jt.describe()


@pytest.mark.parametrize("task", ["vrlr", "uniform"])
def test_merge_reduce_on_reference_children_matches_reference(task):
    """The reference tree's two nodes after three inserts (leaves 0 and 1
    merged, leaf 2), merged by both packages from the same arrays."""
    jt, _, _ = _reference_tree(task, 3)
    jmats = [jt.levels[1].cs, jt.levels[0].cs]          # older child first
    jl, tl = JLedger(), CommLedger()
    key = jax.random.PRNGKey(33)
    jm = j_merge_reduce(task, jmats, jt.node_budget, key=key, ledger=jl, backend="ref")
    tm = merge_reduce(task, [materialized_from_numpy(mt) for mt in jmats],
                      jt.node_budget, key=key_from_numpy(np.asarray(key), CPU),
                      ledger=tl, backend="ref", device=CPU)
    np.testing.assert_array_equal(tm.indices, np.asarray(jm.indices))
    np.testing.assert_allclose(tm.weights, np.asarray(jm.weights), rtol=1e-5)
    for pt, pj in zip(tm.parts, jm.parts):
        np.testing.assert_array_equal(pt, np.asarray(pj))
    assert (tm.comm_units, tm.comm_bits) == (jm.comm_units, jm.comm_bits)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())


def test_vkmc_tree_quality_matches_reference():
    """Two inserts (two pipelined leaves and one weighted-union merge): the
    merged node of each package, fit by the same k-means with the same key,
    against the same full-data baseline."""
    chunks = _chunks(16, 2, 600, dims=(4, 3), labels=False)
    parts = [np.concatenate([c[0][j] for c in chunks]) for j in range(2)]
    tds = dataset_from_numpy(parts, None, CPU)
    params, k, m = {"k": 4}, 4, 100
    jkey = jax.random.PRNGKey(41)
    jt = JTree("vkmc", m, key=jkey, block_size=BLOCK, backend="ref", params=params)
    tt = CoresetTree("vkmc", m, key=key_from_numpy(np.asarray(jkey), CPU),
                     block_size=BLOCK, backend="ref", params=params, device=CPU)
    for p, _ in chunks:
        js, ts = jt.insert(p), tt.insert(p)
        assert (ts.merges, ts.rescored_rows, ts.comm_delta) == \
            (js.merges, js.rescored_rows, js.comm_delta)
    assert (tt.ledger.total, tt.ledger.total_bits) == (jt.ledger.total, jt.ledger.total_bits)
    qj, qt = materialized_from_numpy(jt.query()), tt.query()
    assert (qt.m, qt.comm_units) == (qj.m, qj.comm_units) == (2 * m, jt.ledger.total)
    kf = _key(42)
    base = fit_kmeans(tds, full_data_coreset(tds), k, key=kf).params

    def rel_error(q):
        fit = fit_kmeans(tds, q.coreset(CPU), k, key=rng.fold_in(kf, 1))
        return evaluate(tds, fit, baseline=base).rel_error

    r_t, r_j = rel_error(qt), rel_error(qj)
    assert np.isfinite(r_t) and r_t < 0.25
    assert abs(r_t - r_j) <= REL_GAP


def _message(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


def test_materialized_refusals_word_for_word():
    r = np.random.default_rng(17)

    def mats(dims_list, labels):
        return [JMaterialized(indices=np.arange(4), weights=np.ones(4, np.float32),
                              parts=[r.normal(size=(4, d)).astype(np.float32)
                                     for d in dims],
                              y=np.zeros(4, np.float32) if lab else None)
                for dims, lab in zip(dims_list, labels)]

    cases = [
        ([], []),
        ([(2, 3), (2,)], [True, True]),
        ([(2, 3), (2, 3), (2, 4)], [True, True, True]),
        ([(2, 3), (2, 3)], [True, False]),
    ]
    for dims_list, labels in cases:
        j = mats(dims_list, labels)
        t = [materialized_from_numpy(mt) for mt in j]
        assert _message(lambda: MaterializedCoreset.concat(t)) == \
            _message(lambda: JMaterialized.concat(j))
    parts = [r.normal(size=(6, 2)).astype(np.float32) for _ in range(2)]
    jds, tds = JDataset(parts), dataset_from_numpy(parts, None, CPU)
    jcs = j_build_coreset("uniform", jds, 3, key=jax.random.PRNGKey(0))
    tcs = build_coreset("uniform", tds, 3, key=_key(0), device=CPU)
    for offset in (-1, np.iinfo(np.int64).max):
        assert _message(lambda: MaterializedCoreset.from_coreset(tcs, tds, offset)) == \
            _message(lambda: JMaterialized.from_coreset(jcs, jds, offset))
    # the happy path: the same rows, weights and bill on both sides
    mt = MaterializedCoreset.from_coreset(tcs, tds, offset=10)
    mj = JMaterialized.from_coreset(jcs, jds, offset=10)
    np.testing.assert_array_equal(mt.indices, np.asarray(mj.indices))
    np.testing.assert_array_equal(mt.weights, np.asarray(mj.weights))
    assert mt.comm_units == mj.comm_units and mt.T == 2 and mt.m == 3
    back = mt.dataset()
    assert isinstance(back, VFLDataset) and back.device.type == "cpu"
    assert torch.equal(mt.coreset(CPU).indices, torch.as_tensor(mt.indices))
