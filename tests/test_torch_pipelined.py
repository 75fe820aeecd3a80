"""The pipelined engine (superchunk scans, double-buffered prefetch and the
grouped redraw): the port against its own streamed engine and against the
reference on the CPU, from the same numpy data and keys, at n <= 1,100,
block sizes {97, 128, >= n}, superchunks of C in {2, 3, nb, > nb} blocks
(nb not a multiple of C where it can be), prefetch on and off, and m <= 120.

Tolerances:

- Bit for bit, within the port: the superchunk views against ``block``;
  the pipelined scorer's masses, Gram condition numbers, per-block and
  grouped scores against the streamed scorer's; the pipelined build's
  indices, weights, counts and bill against the streamed build's;
  ``dis_plan_streamed_batched`` against ``dis_plan_streamed``; the
  ``norm`` build at one block against the materialized ``norm`` build.
- Against the reference: the superchunk views value for value (the
  reference pads its last superchunk with zero blocks, the port stages
  only the blocks that exist); the build's indices and bill exact,
  weights and masses at ``rtol=1e-5`` (the reference's own pipelined
  engine is not bitwise its streamed one on this toolchain).

Card-only behaviour (pinned slots, the side stream, the launch counters)
is held by ``chip_smoke.py`` phase 10.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import VFLDataset as JDataset
from repro.core import build_coreset_streaming as j_streaming
from repro.core.streaming import make_stream_scorer as j_scorer
from repro_torch import rng
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    CommLedger, CoresetPipeline, CoresetSpec, StreamScorer, build_coreset,
    build_coreset_streaming, compile_plan, dis_plan_streamed,
    dis_plan_streamed_batched, make_stream_scorer)
from repro_torch.kernels import ops as kops

N = 1100
VKMC = dict(k=4, local_iters=3, center_sample=500)
# (block_size, chunk_blocks, prefetch): nb = 12 at 97, 9 at 128, 1 at N
KNOBS = [(97, 2, True), (97, 5, False), (97, 12, True), (97, 20, False),
         (128, 2, False), (128, 4, True), (128, 9, False), (128, 3, True),
         (N, 3, True), (N, 1, True)]
TASKS = [("vrlr", "ref"), ("vrlr", "pallas"), ("vrlr", "norm"),
         ("vkmc", "ref"), ("vkmc", "norm")]


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


def _both(seed=3, n=N, d=13, T=3, labels=True):
    """Clustered rows with a noisy linear response; d = 13 splits 5, 4, 4,
    so the stacked view pads two parties (and vrlr's label widens the
    last)."""
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((6, d)).astype(np.float32)
    X = centers[r.integers(0, 6, n)] + r.standard_normal((n, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + 0.1 * r.standard_normal(n)).astype(np.float32)
    jds = JDataset.from_dense(X, y if labels else None, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts],
                             np.asarray(jds.y) if labels else None, "cpu")
    return jds, tds


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


def _params(task):
    return dict(VKMC) if task == "vkmc" else {}


# --------------------------------------------------------------------------
# the superchunk views
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("block_size,chunk_blocks,prefetch", KNOBS + [(1500, 2, False)])
def test_blocks_prefetched_equal_reference_and_block(block_size, chunk_blocks, prefetch,
                                                     with_labels):
    """Each superchunk holds the blocks that exist, block i equal to
    ``block(b0 + i)`` and to the reference's superchunk slot i (whose
    trailing padded blocks are zero with no valid rows)."""
    jds, tds = _both()
    nb, bs = tds.block_geometry(block_size)
    got = list(tds.blocks_prefetched(block_size, with_labels, chunk_blocks, prefetch))
    want = list(jds.blocks_prefetched(block_size, with_labels, chunk_blocks, prefetch))
    assert [b0 for b0, _, _ in got] == [b0 for b0, _, _ in want] == list(
        range(0, nb, chunk_blocks))
    for (b0, chunk, nv), (_, jchunk, jnv) in zip(got, want):
        count = min(chunk_blocks, nb - b0)
        assert chunk.shape == (count, 3, bs, jchunk.shape[3]) and nv.shape == (count,)
        jchunk = np.asarray(jchunk)
        np.testing.assert_array_equal(chunk.numpy(), jchunk[:count])
        np.testing.assert_array_equal(nv, jnv[:count])
        assert not jchunk[count:].any() and not jnv[count:].any()
        for i in range(count):
            blk, nvalid = tds.block(b0 + i, block_size, with_labels)
            assert torch.equal(chunk[i], blk) and nv[i] == nvalid
    assert sum(int(nv.sum()) for _, _, nv in got) == N
    assert tds.staged_bytes == 0            # nothing left the host


@pytest.mark.parametrize("block_size", [97, 128, N])
def test_gather_blocks_equal_reference_and_block(block_size):
    jds, tds = _both()
    nb, _ = tds.block_geometry(block_size)
    for ids in ([0], [nb - 1, 0], list(range(nb)), [nb // 2, nb - 1, 1][:nb]):
        for with_labels in (True, False):
            batch, nv = tds.gather_blocks(ids, block_size, with_labels)
            jbatch, jnv = jds.gather_blocks(ids, block_size, with_labels)
            np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
            np.testing.assert_array_equal(nv, jnv)
            for i, b in enumerate(ids):
                blk, nvalid = tds.block(b, block_size, with_labels)
                assert torch.equal(batch[i], blk) and nv[i] == nvalid
    with pytest.raises(IndexError):
        tds.gather_blocks([nb], block_size)
    with pytest.raises(ValueError, match="chunk_blocks"):
        next(tds.blocks_prefetched(block_size, chunk_blocks=0))


# --------------------------------------------------------------------------
# the pipelined scorer and build against the streamed ones (bit for bit)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_size,chunk_blocks,prefetch", KNOBS)
@pytest.mark.parametrize("task,backend", TASKS)
def test_pipelined_scorer_equals_streamed(task, backend, block_size, chunk_blocks,
                                          prefetch):
    """On the CPU ``pallas`` takes the kernels' plain versions."""
    _, tds = _both(11, labels=task == "vrlr")
    key = rng.PRNGKey(12)
    calls = []
    st = make_stream_scorer(task, key, tds, block_size, backend, device="cpu",
                            **_params(task))
    pl = make_stream_scorer(task, key, tds, block_size, backend, device="cpu",
                            chunk_blocks=chunk_blocks, prefetch=prefetch,
                            probe=lambda: calls.append(1), **_params(task))
    nb = st.nb
    C = min(chunk_blocks, nb)
    assert (pl.T, pl.n, pl.nb, pl.bs, pl.data_passes, pl.chunk_blocks) == (
        st.T, st.n, st.nb, st.bs, st.data_passes, C)
    assert torch.equal(pl.dis_key, st.dis_key)
    assert torch.equal(pl.masses, st.masses)
    if st.gram_conds is None:
        assert pl.gram_conds is None
    else:
        assert torch.equal(pl.gram_conds, st.gram_conds)
    per_block = [st.score_block(b) for b in range(nb)]
    for b in range(nb):
        assert torch.equal(pl.score_block(b), per_block[b])
    for ids in (list(range(nb)), [nb - 1, 0][:nb], list(range(0, nb, 2))):
        want = torch.stack([per_block[b] for b in ids])
        assert torch.equal(pl.score_blocks(ids), want)
        assert torch.equal(st.score_blocks(ids), want)
    # a probe after every superchunk of every pass (and vkmc's centers)
    nchunks = -(-nb // C)
    passes = st.data_passes - (task == "vkmc" and backend != "norm")
    assert len(calls) == passes * nchunks + (task == "vkmc" and backend != "norm")


@pytest.mark.parametrize("entry", ["pipeline", "shim"])
@pytest.mark.parametrize("block_size,chunk_blocks,prefetch",
                         [(97, 5, True), (128, 2, False), (128, 4, True), (N, 3, True)])
@pytest.mark.parametrize("task,backend", TASKS[:1] + TASKS[2:] + [("uniform", "auto")])
def test_pipelined_build_equals_streamed(task, backend, block_size, chunk_blocks, prefetch,
                                         entry):
    _, tds = _both(17, labels=task != "vkmc")
    key = rng.PRNGKey(18)
    ls, lp = CommLedger(), CommLedger()
    base = CoresetSpec(task=task, budgets=120, backend=backend, block_size=block_size,
                       params=_params(task))
    st = CoresetPipeline(tds).build(base.replace(engine="streamed"), key=key, ledger=ls,
                                    device="cpu")
    if entry == "pipeline":
        spec = base.replace(engine="pipelined", chunk_blocks=chunk_blocks, prefetch=prefetch)
        assert CoresetPipeline(tds).plan(spec).engine == "pipelined"
        pl = CoresetPipeline(tds).build(spec, key=key, ledger=lp, device="cpu")
    else:
        pl = build_coreset_streaming(task, tds, 120, key=key, backend=backend,
                                     block_size=block_size, chunk_blocks=chunk_blocks,
                                     prefetch=prefetch, ledger=lp, device="cpu",
                                     **_params(task))
    assert torch.equal(pl.indices, st.indices) and torch.equal(pl.weights, st.weights)
    assert (pl.comm_units, pl.comm_bits) == (st.comm_units, st.comm_bits)
    assert (lp.total, lp.total_bits, lp.by_tag()) == (ls.total, ls.total_bits, ls.by_tag())
    assert (pl.health is None) == (st.health is None) == (task == "uniform")
    if st.health is not None:
        assert pl.health == st.health


@pytest.mark.parametrize("task,params", [("vrlr", {}), ("vkmc", {"k": 4})])
def test_norm_pipelined_at_one_block_is_the_materialized_build(task, params):
    """``block_size >= n`` and row-local scores: the pipelined build (one
    superchunk of one block, prefetched) is the materialized one."""
    _, tds = _both(21)
    key = rng.PRNGKey(22)
    mat = build_coreset(task, tds, 120, key=key, backend="norm", device="cpu", **params)
    for block_size in (N, 4 * N):
        pl = CoresetPipeline(tds).build(
            CoresetSpec(task=task, budgets=120, engine="pipelined", backend="norm",
                        block_size=block_size, chunk_blocks=4, prefetch=True,
                        params=params), key=key, device="cpu")
        assert torch.equal(pl.indices, mat.indices)
        assert torch.equal(pl.weights, mat.weights)
        assert pl.comm_units == mat.comm_units


# --------------------------------------------------------------------------
# the grouped redraw against the per-block one
# --------------------------------------------------------------------------

def _table_scorer(sc: np.ndarray, bs: int, key, chunk_blocks: int) -> StreamScorer:
    """A StreamScorer over a fixed (T, n) score table, blocks zero-padded."""
    T, n = sc.shape
    nb = -(-n // bs)
    padded = torch.zeros((T, nb * bs))
    padded[:, :n] = torch.from_numpy(sc)
    blocks = padded.view(T, nb, bs).transpose(0, 1)                # (nb, T, bs)
    return StreamScorer(T=T, n=n, nb=nb, bs=bs, masses=blocks.sum(2).T.contiguous(),
                        dis_key=key, score_block=lambda b: blocks[b].clone(),
                        data_passes=0,
                        score_blocks=lambda ids: blocks[list(ids)].clone(),
                        chunk_blocks=chunk_blocks)


@pytest.mark.parametrize("m", [1, 7, 40, 120])
@pytest.mark.parametrize("chunk_blocks", [1, 2, 3, 5, 30])
def test_batched_redraw_equals_per_block_redraw(chunk_blocks, m):
    """Skewed masses (party 1 nearly empty in most blocks) and small m give
    groups whose blocks touch only some parties; 23 blocks give a short
    last group for every C here but 1.  The draws, weights, counts and
    totals are the per-block redraw's bit for bit; one probe a group."""
    r = np.random.default_rng(m + chunk_blocks)
    sc = (r.random((3, N)) + 1e-3).astype(np.float32)
    sc[1, 48 * 5:] *= 1e-4
    scorer = _table_scorer(sc, 48, rng.PRNGKey(m), chunk_blocks)
    calls = []
    want = dis_plan_streamed(scorer, m)
    got = dis_plan_streamed_batched(scorer, m, probe=lambda: calls.append(1))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    blocks = {int(i) // 48 for i in got.indices}
    cells = {(int(i) // 48, j) for j in range(3)
             for i in got.indices[int(got.counts[:j].sum()):int(got.counts[:j + 1].sum())]}
    assert len(calls) == -(-len(blocks) // chunk_blocks)
    if m >= 7:
        assert len(cells) < 3 * len(blocks)       # some block misses a party
    # without score_blocks the grouped redraw is the per-block one
    plain = StreamScorer(**{f: getattr(scorer, f) for f in
                            ("T", "n", "nb", "bs", "masses", "dis_key", "score_block",
                             "data_passes")})
    for a, b in zip(want, dis_plan_streamed_batched(plain, m)):
        assert torch.equal(a, b)


def test_launches_once_per_superchunk_and_group(monkeypatch):
    """Every scoring kernel is called once per superchunk of each pass and
    once per redraw group, the draw once per group (plus round 1); counted
    at the ``kernels.ops`` entry points, which the CPU routes to the plain
    versions."""
    _, tds = _both(31)
    calls = {}
    for name in ("weighted_gram", "leverage", "kmeans_assign", "kmeans_assign_update",
                 "categorical", "categorical_parties"):
        fn = getattr(kops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kops, name, counted)
    C, bs = 5, 97                                     # nb = 12: superchunks 5, 5, 2
    for task in ("vrlr", "vkmc"):
        calls.clear()
        cs = build_coreset_streaming(task, tds, 120, key=rng.PRNGKey(3), block_size=bs,
                                     chunk_blocks=C, prefetch=True, device="cpu",
                                     **_params(task))
        groups = -(-len({int(i) // bs for i in cs.indices}) // C)
        if task == "vrlr":
            want = {"weighted_gram": 3, "leverage": 3 + groups, "categorical": 1,
                    "categorical_parties": groups}
        else:
            k, iters = VKMC["k"], VKMC["local_iters"]
            want = {"kmeans_assign_update": 3 * iters + 3, "kmeans_assign": 3 + groups,
                    "categorical": 1 + 3 * k, "categorical_parties": groups}
        assert calls == want, (task, calls)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_size,chunk_blocks,prefetch",
                         [(97, 5, True), (97, 3, False), (128, 4, True), (N, 2, False)])
@pytest.mark.parametrize("task,backend", [("vrlr", "ref"), ("vrlr", "norm"),
                                          ("vkmc", "norm"), ("uniform", "auto")])
def test_pipelined_build_matches_reference(task, backend, block_size, chunk_blocks,
                                           prefetch):
    jds, tds = _both(17)
    kj, kt = _keys(18)
    params = _params(task)
    jl, tl = JLedger(), CommLedger()
    jcs = j_streaming(task, jds, 100, key=kj, backend=backend, block_size=block_size,
                      chunk_blocks=chunk_blocks, prefetch=prefetch, ledger=jl, **params)
    tcs = build_coreset_streaming(task, tds, 100, key=kt, backend=backend,
                                  block_size=block_size, chunk_blocks=chunk_blocks,
                                  prefetch=prefetch, ledger=tl, device="cpu", **params)
    np.testing.assert_array_equal(tcs.indices.numpy(), np.asarray(jcs.indices))
    np.testing.assert_allclose(tcs.weights.numpy(), np.asarray(jcs.weights), rtol=1e-5)
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits,
                                                      jl.by_tag())
    if task != "uniform":
        js = j_scorer(task, kj, jds, block_size, backend, chunk_blocks=chunk_blocks,
                      prefetch=prefetch, **params)
        ts = make_stream_scorer(task, kt, tds, block_size, backend, device="cpu",
                                chunk_blocks=chunk_blocks, prefetch=prefetch, **params)
        assert (ts.nb, ts.chunk_blocks, ts.data_passes) == (js.nb, js.chunk_blocks,
                                                            js.data_passes)
        np.testing.assert_allclose(ts.masses.numpy(), np.asarray(js.masses), rtol=1e-5)


@pytest.mark.parametrize("chunk_blocks", [1, 2, 5, 12, 100])
@pytest.mark.parametrize("prefetch", [None, False, True])
def test_pipelined_compiles_for_every_knob(chunk_blocks, prefetch):
    """Every C >= 1 and prefetch setting compiles, to the reference's
    engine; only C = 1 without prefetch lowers to streamed."""
    _, tds = _both(5)
    ep = compile_plan(CoresetSpec(engine="pipelined", block_size=97,
                                  chunk_blocks=chunk_blocks, prefetch=prefetch), tds)
    lowered = chunk_blocks == 1 and not prefetch
    assert ep.engine == ("streamed" if lowered else "pipelined")
    assert ep.chunk_blocks == (1 if lowered else min(chunk_blocks, 12))
    assert ep.prefetch == bool(prefetch)


def test_pipelined_reads_a_host_dataset_and_defaults_to_the_card():
    """The pipelined engine takes a CPU dataset for a CPU build without
    staging a byte; the shim's defaults (C = 8, prefetch per device) plan
    it, and a build with no device asks for the card."""
    _, tds = _both(23)
    ep = compile_plan(CoresetSpec(engine="pipelined", block_size=97), tds)
    assert (ep.engine, ep.chunk_blocks, ep.prefetch) == ("pipelined", 8, False)
    cs = build_coreset_streaming("vrlr", tds, 50, key=rng.PRNGKey(1), block_size=97,
                                 device="cpu")
    assert cs.indices.shape == (50,) and tds.staged_bytes == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        build_coreset_streaming("vrlr", tds, 50, key=rng.PRNGKey(1), block_size=97)
