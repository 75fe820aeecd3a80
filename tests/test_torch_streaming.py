"""The streamed engine (block-scan scoring + hierarchical DIS from a
host-resident dataset): the port against the reference on the CPU, from
the same numpy data and keys, at n <= 1,100, block sizes {97, 128, 333,
>= n} and m <= 120.

Tolerances:

- Exact: block geometry, the block views, the DIS keys, every index and
  count, every bill (units, bits and per-tag ledger) and ``data_passes``.
- Weights at ``rtol=1e-5``: the mass table sums each block in another
  order than XLA, so ``G`` and the weights agree to fp tolerance, never
  bitwise (the reference's own streamed and pipelined engines differ by
  up to 2.9e-6).
- Scores and masses at ``rtol=1e-5``; the Gram condition numbers at
  ``rtol=1e-3`` (ratios of fp32 ``eigh`` eigenvalues); ``vkmc``'s local
  centers and cluster statistics at ``rtol=1e-4`` (k-means++ picks the
  same rows, then Lloyd sums in another order), its end-to-end result
  by quality: ``rel_error`` within ``REL_GAP`` of the reference's.
- Within the port: the blocked plan at ``block_size >= n`` equals
  ``dis_plan_full`` bit for bit, and the ``norm`` streamed build there
  equals the materialized ``norm`` build bit for bit, with the same bill
  in units (its round-1 upload is one float per block, not per row).

A host-resident dataset against one already on the card is compared by
``chip_smoke.py`` phase 9, which needs the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core import build_coreset_streaming as j_streaming
from repro.core import compile_plan as j_compile_plan
from repro.core.dis import blocked_geometry as j_blocked_geometry
from repro.core.dis import dis_blocked_marginals as j_marginals
from repro.core.dis import dis_plan_blocked as j_blocked
from repro.core.solve import evaluate as j_evaluate
from repro.core.solve import fit_kmeans as j_fit_kmeans
from repro.core.streaming import dis_plan_streamed as j_streamed
from repro.core.streaming import make_stream_scorer as j_scorer
from repro.core.streaming import vkmc_local_centers as j_centers
from repro_torch import rng
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, StreamScorer,
    blocked_geometry, build_coreset, build_coreset_streaming, compile_plan,
    dis_blocked_marginals, dis_plan_blocked, dis_plan_full, dis_plan_streamed,
    evaluate, fit_kmeans, make_stream_scorer, vkmc_local_centers)
from repro_torch.core.sensitivity import norm_scores
from repro_torch.core.streaming import with_masses
from repro_torch.core.vfl import block_geometry

N = 1100
BLOCK_SIZES = (97, 128, 333, N)
VKMC = dict(k=4, local_iters=3, center_sample=500)
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


def _scores(seed, T=3, n=N):
    return (np.random.default_rng(seed).random((T, n)) + 1e-3).astype(np.float32)


# --------------------------------------------------------------------------
# geometry and blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,block_size", [(100, 30), (100, 100), (100, 1000),
                                          (7, 1), (N, 97), (N, 333), (10, 0)])
def test_block_geometry(n, block_size):
    if block_size < 1:
        for fn in (j_blocked_geometry, blocked_geometry, block_geometry):
            with pytest.raises(ValueError, match="block_size must be >= 1"):
                fn(n, block_size)
        return
    want = j_blocked_geometry(n, block_size)
    assert blocked_geometry(n, block_size) == block_geometry(n, block_size) == want
    _, tds = _both(n=n, d=6)
    assert tds.block_geometry(block_size) == want


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("block_size", BLOCK_SIZES + (1500,))
def test_blocks_equal_reference(block_size, with_labels):
    """Every block (the ragged last one included) is the reference's block
    and the matching slice of ``stacked()``; rows past n are zero."""
    jds, tds = _both()
    st = tds.stacked(with_labels).blocks
    nb, bs = tds.block_geometry(block_size)
    seen = []
    for b, blk, nvalid in tds.blocks(block_size, with_labels):
        jblk, jnv = jds.block(b, block_size, with_labels)
        assert nvalid == jnv and blk.shape == (3, bs, st.shape[2])
        np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
        assert torch.equal(blk[:, :nvalid], st[:, b * bs:b * bs + nvalid])
        assert not bool(blk[:, nvalid:].any())
        again, _ = tds.block(b, block_size, with_labels, device="cpu")
        assert torch.equal(again, blk) and again.data_ptr() != blk.data_ptr()
        seen.append(nvalid)
    assert len(seen) == nb and sum(seen) == N
    assert tds.staged_bytes == 0            # nothing left the host
    with pytest.raises(IndexError):
        tds.block(nb, block_size)
    if not with_labels:
        with pytest.raises(ValueError, match="labels"):
            _both(labels=False)[1].block(0, block_size, with_labels=True)


# --------------------------------------------------------------------------
# the blocked plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m_cap", [None, 150])
@pytest.mark.parametrize("block_size", BLOCK_SIZES + (5000,))
def test_blocked_plan_matches_reference(block_size, m_cap):
    sc = _scores(1)
    kj, kt = _keys(5)
    want = j_blocked(kj, jnp.asarray(sc), 120, block_size, m_cap=m_cap)
    got = dis_plan_blocked(kt, torch.from_numpy(sc), 120, block_size, m_cap=m_cap)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-5)
    np.testing.assert_allclose(got.totals.numpy(), np.asarray(want.totals), rtol=1e-5)
    cap = 120 if m_cap is None else m_cap
    assert got.indices.shape == (cap,) and int(got.counts.sum()) == 120


@pytest.mark.parametrize("T,n,m", [(1, 200, 50), (2, 231, 51), (3, 262, 52)])
def test_blocked_plan_at_one_block_is_the_full_plan(T, n, m):
    """``block_size >= n``: the same key chain, masses and draws as
    ``dis_plan_full``, bit for bit, at and past the budget's capacity."""
    sc = torch.from_numpy(_scores(100 + n, T, n))
    key = rng.PRNGKey(T)
    for m_cap in (None, m + 7):
        full = dis_plan_full(key, sc, m, m_cap=m_cap)
        for block_size in (n, n + 1, 10 * n):
            blk = dis_plan_blocked(key, sc, m, block_size, m_cap=m_cap)
            for a, b in zip(full, blk):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("block_size", [1, 7, 64, 500, 2000])
def test_blocked_marginals_match_reference(block_size):
    sc = _scores(2, 3, 500)
    want = j_marginals([jnp.asarray(s) for s in sc], block_size)
    got = dis_blocked_marginals([torch.from_numpy(s) for s in sc], block_size)
    assert got.dtype == np.float64 and got.shape == (500,)
    np.testing.assert_allclose(got, want, rtol=1e-12)


# --------------------------------------------------------------------------
# the streamed sampler
# --------------------------------------------------------------------------

def _port_view(js, device="cpu"):
    """The reference scorer's masses and block scores behind a port
    :class:`StreamScorer`."""
    return StreamScorer(
        T=js.T, n=js.n, nb=js.nb, bs=js.bs,
        masses=torch.from_numpy(np.array(js.masses)),
        dis_key=key_from_numpy(np.asarray(js.dis_key), device),
        score_block=lambda b: torch.from_numpy(np.array(js.score_block(b))),
        data_passes=js.data_passes)


@pytest.mark.parametrize("block_size", BLOCK_SIZES)
@pytest.mark.parametrize("task,params", [("vrlr", {}), ("vkmc", VKMC)])
def test_streamed_sampler_on_reference_scores(task, params, block_size):
    jds, _ = _both()
    kj, _ = _keys(7)
    js = j_scorer(task, kj, jds, block_size, "ref", **params)
    for m in (1, 120):
        want = j_streamed(js, m)
        got = dis_plan_streamed(_port_view(js), m)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.totals.numpy(), np.asarray(want.totals),
                                   rtol=1e-5)


@pytest.mark.parametrize("block_size", BLOCK_SIZES + (2000,))
def test_streamed_sampler_matches_blocked_plan(block_size):
    """Touched-block recomputation changes nothing: ``norm`` scores are
    row-local, so the streamed draws are the in-memory blocked plan's."""
    _, tds = _both(7)
    key = rng.PRNGKey(8)
    sc = norm_scores(tds.stacked(with_labels=True).blocks) + 1.0 / tds.n
    calls = []
    scorer = make_stream_scorer("vrlr", key, tds, block_size, "norm",
                                probe=lambda: calls.append(1), device="cpu")
    assert scorer.data_passes == 1
    assert len(calls) == scorer.nb
    want = dis_plan_blocked(key, sc, 90, block_size)
    got = dis_plan_streamed(scorer, 90)
    for a, b in zip(want[:3], got[:3]):
        if a.dtype == torch.int64:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got.totals, want.totals, rtol=1e-6, atol=0.0)


def test_with_masses_swaps_the_table():
    _, tds = _both()
    scorer = make_stream_scorer("vrlr", rng.PRNGKey(1), tds, 333, "ref", device="cpu")
    delivered = np.asarray(scorer.masses, np.float64) * 2.0
    swapped = with_masses(scorer, delivered)
    assert swapped.masses.dtype == torch.float32
    assert torch.equal(swapped.masses, scorer.masses * 2.0)
    assert swapped.score_block is scorer.score_block
    with pytest.raises(ValueError, match="shape"):
        with_masses(scorer, delivered[:, :2])


# --------------------------------------------------------------------------
# the scorers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", BLOCK_SIZES)
@pytest.mark.parametrize("backend", ["ref", "pallas", "norm"])
def test_vrlr_scorer_matches_reference(backend, block_size):
    """On the CPU ``pallas`` takes the kernels' plain versions."""
    jds, tds = _both(11)
    kj, kt = _keys(12)
    js = j_scorer("vrlr", kj, jds, block_size, "ref" if backend == "pallas" else backend)
    ts = make_stream_scorer("vrlr", kt, tds, block_size, backend, device="cpu")
    assert (ts.T, ts.n, ts.nb, ts.bs, ts.data_passes) == (js.T, js.n, js.nb, js.bs,
                                                          js.data_passes)
    np.testing.assert_array_equal(ts.dis_key.numpy(), np.asarray(js.dis_key))
    np.testing.assert_allclose(ts.masses.numpy(), np.asarray(js.masses), rtol=1e-5)
    for b in range(ts.nb):
        np.testing.assert_allclose(ts.score_block(b).numpy(),
                                   np.asarray(js.score_block(b)), rtol=1e-5, atol=0)
    if backend == "norm":
        assert ts.gram_conds is None and js.gram_conds is None
    else:
        np.testing.assert_allclose(ts.gram_conds.numpy(), np.asarray(js.gram_conds),
                                   rtol=1e-3)


@pytest.mark.parametrize("center_sample", [500, 2000])
def test_vkmc_local_centers_match_reference(center_sample):
    """The subsample (rng.randint) and the k-means key come from each
    party's split key; k-means++ picks the same rows, Lloyd sums in
    another order."""
    jds, tds = _both(13, labels=False)
    kj, kt = _keys(14)
    jc, jk = j_centers(kj, jds, k=4, local_iters=3, center_sample=center_sample)
    tc, tk = vkmc_local_centers(kt, tds, k=4, local_iters=3,
                                center_sample=center_sample, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tc.shape == jc.shape == (3, 4, 5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    assert not bool(tc[1:, :, 4].any())          # the 4-wide parties are padded


@pytest.mark.parametrize("block_size", BLOCK_SIZES)
@pytest.mark.parametrize("backend", ["ref", "norm"])
def test_vkmc_scorer_matches_reference(backend, block_size):
    jds, tds = _both(15, labels=False)
    kj, kt = _keys(16)
    js = j_scorer("vkmc", kj, jds, block_size, backend, **VKMC)
    ts = make_stream_scorer("vkmc", kt, tds, block_size, backend, device="cpu", **VKMC)
    assert (ts.nb, ts.bs, ts.data_passes) == (js.nb, js.bs, js.data_passes)
    np.testing.assert_array_equal(ts.dis_key.numpy(), np.asarray(js.dis_key))
    np.testing.assert_allclose(ts.masses.numpy(), np.asarray(js.masses), rtol=1e-4)
    for b in range(ts.nb):
        np.testing.assert_allclose(ts.score_block(b).numpy(),
                                   np.asarray(js.score_block(b)), rtol=1e-4, atol=0)
    if backend == "ref":
        # Lemma F.2: each party's total is 2 (k + 1) alpha with no empty cluster
        np.testing.assert_allclose(ts.masses.sum(1).numpy(), [2 * 5 * 2.0] * 3,
                                   rtol=1e-4)


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

def _health_equal(got, want):
    assert got is not None and want is not None
    assert (got.finite_fraction, got.zero_mass_parties, got.notes) == (
        want.finite_fraction, want.zero_mass_parties, want.notes)
    np.testing.assert_allclose([got.mass_total, got.max_cell_share],
                               [want.mass_total, want.max_cell_share], rtol=1e-5)
    np.testing.assert_allclose(got.party_shares, want.party_shares, rtol=1e-5)
    if want.gram_conds is None:
        assert got.gram_conds is None
    else:
        np.testing.assert_allclose(got.gram_conds, want.gram_conds, rtol=1e-3)


@pytest.mark.parametrize("entry", ["pipeline", "shim"])
@pytest.mark.parametrize("block_size", [97, 333, N])
@pytest.mark.parametrize("task,backend", [("vrlr", "ref"), ("vrlr", "norm"),
                                          ("vkmc", "norm"), ("uniform", "auto")])
def test_streamed_build_matches_reference(task, backend, block_size, entry):
    jds, tds = _both(17)
    kj, kt = _keys(18)
    params = {} if task == "vrlr" or task == "uniform" else dict(VKMC)
    jl, tl = JLedger(), CommLedger()
    jcs = j_streaming(task, jds, 100, key=kj, backend=backend, block_size=block_size,
                      chunk_blocks=1, prefetch=False, ledger=jl, **params)
    if entry == "pipeline":
        spec = CoresetSpec(task=task, budgets=100, engine="streamed", backend=backend,
                           block_size=block_size, params=params)
        tcs = CoresetPipeline(tds).build(spec, key=kt, ledger=tl, device="cpu")
    else:
        tcs = build_coreset_streaming(task, tds, 100, key=kt, backend=backend,
                                      block_size=block_size, chunk_blocks=1,
                                      prefetch=False, ledger=tl, device="cpu",
                                      **params)
    np.testing.assert_array_equal(tcs.indices.numpy(), np.asarray(jcs.indices))
    np.testing.assert_allclose(tcs.weights.numpy(), np.asarray(jcs.weights), rtol=1e-5)
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits,
                                                      jl.by_tag())
    if task == "uniform":
        assert tcs.health is None and tcs.comm_units == CommSchedule.uniform(3, 100).total
    else:
        assert tcs.comm_units == CommSchedule.dis_total(3, 100)
        _health_equal(tcs.health, jcs.health)


@pytest.mark.parametrize("block_size", [128, 333])
def test_streamed_vkmc_build_by_quality(block_size):
    """The iterated Lloyd of the port's local centers agrees with the
    reference's only to fp tolerance, so the ``vkmc`` build is held by the
    fit it leads to: both coresets, fit and evaluated by each package,
    land within ``REL_GAP`` of each other; the bill is exact."""
    jds, tds = _both(19, labels=False)
    kj, kt = _keys(20)
    jl, tl = JLedger(), CommLedger()
    jcs = j_streaming("vkmc", jds, 120, key=kj, backend="ref", block_size=block_size,
                      chunk_blocks=1, prefetch=False, ledger=jl, **VKMC)
    tcs = build_coreset_streaming("vkmc", tds, 120, key=kt, backend="ref",
                                  block_size=block_size, chunk_blocks=1,
                                  prefetch=False, ledger=tl, device="cpu", **VKMC)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits,
                                                      jl.by_tag())
    assert bool((tcs.weights > 0).all()) and tcs.indices.shape == (120,)
    _health_equal(tcs.health, jcs.health)
    sk_j, sk_t = jax.random.fold_in(kj, 1), rng.fold_in(kt, 1)
    jrep = j_evaluate(jds, j_fit_kmeans(jds, jcs, 4, key=sk_j), key=sk_j)
    trep = evaluate(tds, fit_kmeans(tds, tcs, 4, key=sk_t), key=sk_t)
    assert np.isfinite(trep.rel_error) and trep.rel_error < 0.5
    assert abs(trep.rel_error - jrep.rel_error) <= REL_GAP


# --------------------------------------------------------------------------
# port-only pins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task,params", [("vrlr", {}), ("vkmc", {"k": 4})])
def test_norm_build_at_one_block_is_the_materialized_build(task, params):
    """``block_size >= n`` and row-local scores: the streamed build equals
    the materialized one bit for bit, with the same bill in units."""
    _, tds = _both(21)
    key = rng.PRNGKey(22)
    lm, ls = CommLedger(), CommLedger()
    mat = build_coreset(task, tds, 120, key=key, backend="norm", ledger=lm,
                        device="cpu", **params)
    for block_size in (N, 4 * N):
        st = CoresetPipeline(tds).build(
            CoresetSpec(task=task, budgets=120, engine="streamed", backend="norm",
                        block_size=block_size, params=params),
            key=key, ledger=ls, device="cpu")
        assert torch.equal(st.indices, mat.indices)
        assert torch.equal(st.weights, mat.weights)
        # the same units; the round-1 upload is one float32 per block, not
        # per row: at one block, 32 bits a party instead of 32 n
        assert st.comm_units == mat.comm_units and ls.by_tag() == lm.by_tag()
        assert st.comm_bits == mat.comm_bits - 3 * (N - 1) * 32
        ls = CommLedger()


def test_host_dataset_device_rule_and_probe():
    """The streamed engine reads a CPU dataset for a build on the CPU
    without staging a byte; a probe runs after every block of every pass
    and of the redraw.  Every other engine keeps the dataset-on-device
    rule."""
    _, tds = _both(23)
    calls = []
    spec = CoresetSpec(task="vrlr", budgets=60, engine="streamed", block_size=128)
    a = CoresetPipeline(tds).build(spec, key=rng.PRNGKey(3), device="cpu",
                                   probe=lambda: calls.append(1))
    b = CoresetPipeline(tds).build(spec, key=rng.PRNGKey(3),
                                   device=torch.device("cpu"))
    assert torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)
    assert tds.staged_bytes == 0
    nb = tds.block_geometry(128)[0]
    touched = len({int(i) // 128 for i in a.indices})
    assert len(calls) == 2 * nb + touched
    with pytest.raises(RuntimeError, match="CUDA"):
        CoresetPipeline(tds).build(spec, key=rng.PRNGKey(3))     # the card by default


@pytest.mark.parametrize("engine", ["streamed", "materialized"])
def test_plan_runs_only_on_the_device_it_was_compiled_for(engine):
    """A plan resolves its backend, prefetch default and engine lowering
    for one device; ``build`` refuses to run it on another.  A plan for
    the card is stood in for by the CPU plan with its device replaced,
    since this machine has no card."""
    _, tds = _both(27)
    pipe = CoresetPipeline(tds)
    spec = CoresetSpec(task="vrlr", budgets=20, engine=engine, block_size=128)
    ep = pipe.plan(spec)
    assert ep.device == torch.device("cpu") and ep.backend == "ref"
    assert pipe.plan(spec, device="cpu").device == ep.device
    a = pipe.build(ep, key=rng.PRNGKey(5), device="cpu")
    b = pipe.build(spec, key=rng.PRNGKey(5), device="cpu")
    assert torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)
    on_card = dataclasses.replace(ep, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="compiled for a build on cuda:0"):
        pipe.build(on_card, key=rng.PRNGKey(5), device="cpu")


def test_streamed_vrlr_needs_labels():
    _, tds = _both(24, labels=False)
    for fn in (lambda: build_coreset_streaming("vrlr", tds, 10, key=rng.PRNGKey(0),
                                               chunk_blocks=1, prefetch=False,
                                               device="cpu"),
               lambda: make_stream_scorer("vrlr", rng.PRNGKey(0), tds, 128, "ref",
                                          device="cpu")):
        with pytest.raises(ValueError, match="labels"):
            fn()
    with pytest.raises(ValueError, match="no streaming scorer"):
        make_stream_scorer("uniform", rng.PRNGKey(0), tds, 128, "ref", device="cpu")


def test_pipelined_knobs_raise_naming_the_item():
    """The pipelined knobs (the shim's defaults, ``chunk_blocks > 1``,
    prefetch) compile to the pipelined engine and run, raising nothing,
    and draw the streamed build bit for bit."""
    _, tds = _both(25)
    key = rng.PRNGKey(0)
    want = build_coreset_streaming("vrlr", tds, 10, key=key, block_size=128,
                                   chunk_blocks=1, prefetch=False, device="cpu")
    for kw in (dict(), dict(chunk_blocks=2, prefetch=False),
               dict(chunk_blocks=1, prefetch=True)):
        got = build_coreset_streaming("vrlr", tds, 10, key=key, block_size=128,
                                      device="cpu", **kw)
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.weights, want.weights)
    ep = compile_plan(CoresetSpec(engine="pipelined", block_size=128, chunk_blocks=4), tds)
    assert (ep.engine, ep.chunk_blocks, ep.prefetch) == ("pipelined", 4, False)
    for kw in (dict(chunk_blocks=2), dict(prefetch=True)):
        spec = CoresetSpec(engine="pipelined", block_size=128, **kw)
        assert CoresetPipeline(tds).plan(spec).engine == "pipelined"
        got = CoresetPipeline(tds).build(spec, key=key, device="cpu")
        want = CoresetPipeline(tds).build(spec.replace(engine="streamed"), key=key,
                                          device="cpu")
        assert torch.equal(got.indices, want.indices)
        assert torch.equal(got.weights, want.weights)


@pytest.mark.parametrize("kw", [dict(block_size=0), dict(block_size=2.5),
                                dict(block_size=True), dict(chunk_blocks=0),
                                dict(chunk_blocks=1.5), dict(prefetch=1),
                                dict(prefetch="yes")])
def test_spec_streaming_fields_validate_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        JSpec(**kw)
    with pytest.raises(ValueError) as got:
        CoresetSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec_kw,engine", [
    (dict(engine="streamed", chunk_blocks=4, prefetch=True), "streamed"),
    (dict(engine="pipelined", chunk_blocks=1, prefetch=False), "streamed"),
    (dict(engine="pipelined", chunk_blocks=4, prefetch=False, block_size=4 * N), "streamed"),
    (dict(engine="streamed", block_size=97), "streamed"),
    (dict(engine="materialized"), "materialized"),
    (dict(engine="pipelined", block_size=128), "pipelined"),
    (dict(engine="pipelined", chunk_blocks=4, prefetch=False, block_size=97), "pipelined"),
    (dict(engine="pipelined", chunk_blocks=1, prefetch=True, block_size=97), "pipelined"),
    (dict(engine="pipelined", chunk_blocks=50, prefetch=True, block_size=97), "pipelined"),
    (dict(engine="pipelined", chunk_blocks=3, prefetch=True, block_size=N), "pipelined"),
])
def test_plan_lowering_and_notes_match_reference(spec_kw, engine):
    jds, tds = _both(26)
    kw = dict(dict(task="vrlr", budgets=10), **spec_kw)
    jp = j_compile_plan(JSpec(**kw), jds)
    tp = compile_plan(CoresetSpec(**kw), tds)
    assert tp.engine == jp.engine == engine
    assert tp.notes == jp.notes
    assert (tp.chunk_blocks, tp.prefetch, tp.block_size) == (
        jp.chunk_blocks, jp.prefetch, jp.spec.block_size)
    text = tp.describe()
    assert f"blocks: {jp.nb} x {jp.bs} rows (block_size={jp.spec.block_size})" in text
    assert ("streaming knobs" in text) == (engine in ("streamed", "pipelined"))
    for note in tp.notes:
        assert f"note: {note}" in text
