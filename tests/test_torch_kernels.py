"""The port's kernels: plain versions against the reference's oracles and
its Pallas kernels (interpret mode on the CPU), and — on a CUDA card only —
the hand-written kernels against their plain versions.

Tolerances: every comparison is fp32 against fp32 with another summation
order, so ``rtol=1e-5`` with an ``atol`` per case, scaled to the largest
magnitude the sum can reach (a few fp32 ulps of it).

The k-means kernels (``kmeans_assign``, ``kmeans_assign_update``) are
held as ``tests/test_kernels.py`` holds the Pallas ones: an assignment is
right when its center's distance, recomputed in float64, is within
``KMEANS_TOL`` times max(||x||^2 + ||c||^2) of the row's minimum (index
equality is not required where two distances tie within rounding); ``d2``
agrees at that same absolute tolerance (the expanded form's cancellation
error); csum, wsum and ccost agree with the segment sums of the
assignment itself at ``KMEANS_TOL`` times the largest absolute sum
(``sum_i |w_i| |x_ij|``, ``sum_i |w_i|``, ``sum_i |w_i| d2_i``).
Assignments computed twice on one device are also compared index for
index against the other side wherever no tie is near.

The module imports no JAX at the top, so the ``gpu`` tests run on a card
machine without it: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``.  The reference tests import it inside.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import kmeans_assign as kka
from repro_torch.kernels import kmeans_assign_update as kkau
from repro_torch.kernels import leverage as klev
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_gram as kwg

KMEANS_TOL = 1e-5
#: The largest k whose K2 layout fits in shared memory at d = 64.
KMAX_64 = max(k for k in range(1, 2000)
              if kkau.smem_bytes(k, 64, 32) <= kka.MAX_SMEM_BYTES)

# (batch dims of X, batch dims of the second operand, n, d)
LEV_CASES = [((), (), 1, 1), ((), (), 7, 1), ((), (), 37, 5), ((), (), 513, 16),
             ((3,), (), 129, 8), ((), (2,), 65, 9), ((3,), (3,), 301, 31),
             ((2,), (2,), 1, 4)]
GRAM_CASES = [((), (), 1, 1), ((), (), 7, 1), ((), (), 37, 5), ((), (), 600, 12),
              ((3,), (), 129, 8), ((), (2,), 65, 9), ((3,), (3,), 301, 31),
              ((2,), (2,), 1, 3)]

# (batch dims of X, of C, weights: None | "w" | "wb" (batched) | "zero", n, k, d)
KMEANS_CASES = [((), (), None, 1, 1, 1), ((), (), None, 7, 3, 1),
                ((), (), "w", 37, 1, 5), ((), (), "w", 513, 8, 13),
                ((3,), (), None, 129, 4, 5), ((), (2,), "w", 65, 5, 9),
                ((3,), (3,), "wb", 301, 8, 13), ((), (), "wb2", 200, 6, 4),
                ((2,), (2,), "zero", 200, 6, 4), ((), (), "w", 2000, 8, 13)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers at once; torch's own thread pool on
    top of them oversubscribes the cores, so these tests use one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name):
    """A module of the JAX reference package (needs JAX, which the CPU
    test environment has)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"repro.kernels.{name}")


def _psd(r, batch, d):
    A = r.standard_normal(batch + (d, d)).astype(np.float32)
    return (A @ np.swapaxes(A, -1, -2) / d).astype(np.float32)


def _lev_inputs(seed, xb, mb, n, d):
    r = np.random.default_rng(seed)
    return r.standard_normal(xb + (n, d)).astype(np.float32), _psd(r, mb, d)


def _gram_inputs(seed, xb, wb, n, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal(xb + (n, d)).astype(np.float32),
            r.uniform(0.0, 3.0, wb + (n,)).astype(np.float32))


def _kmeans_inputs(seed, xb, cb, wk, n, k, d):
    """X, C (with a duplicate center when k > 1: a tie takes the first
    index) and w per the case's weight kind."""
    r = np.random.default_rng(seed)
    X = r.standard_normal(xb + (n, d)).astype(np.float32)
    C = r.standard_normal(cb + (k, d)).astype(np.float32)
    if k > 2:
        C[..., 2, :] = C[..., 0, :]
    w = {None: None,
         "w": r.uniform(0.0, 3.0, (n,)),
         "wb": r.uniform(0.0, 3.0, xb + (n,)),
         "wb2": r.uniform(0.0, 3.0, (2, n)),
         "zero": np.zeros((n,))}[wk]
    return X, C, None if w is None else w.astype(np.float32)


def _true_d2(X, C):
    """float64 squared distances (..., n, k)."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    return ((X[..., :, None, :] - C[..., None, :, :]) ** 2).sum(-1)


def _d2_scale(X, C):
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    return float((X ** 2).sum(-1).max() + (C ** 2).sum(-1).max())


def _check_assign(X, C, assign, d2, want_d2):
    """The near-minimal rule and d2 at KMEANS_TOL of the distance scale."""
    full = _true_d2(X, C)
    batch = np.broadcast_shapes(full.shape[:-1], np.shape(assign))
    full = np.broadcast_to(full, batch + full.shape[-1:])
    chosen = np.take_along_axis(full, np.asarray(assign, np.int64)[..., None], -1)[..., 0]
    atol = KMEANS_TOL * _d2_scale(X, C)
    np.testing.assert_allclose(chosen, full.min(-1), rtol=0, atol=atol)
    np.testing.assert_allclose(d2, want_d2, rtol=KMEANS_TOL, atol=atol)


def _check_sums(X, w, assign, d2, k, sums):
    """csum, wsum, ccost against the segment sums of ``assign`` itself."""
    Xt, at, dt = (torch.as_tensor(np.asarray(a)) for a in (X, assign, d2))
    wt = None if w is None else torch.as_tensor(np.asarray(w))
    want = ref.segment_sums(Xt, wt, at, dt, k)
    absw = None if wt is None else wt.abs()
    scale = ref.segment_sums(Xt.abs(), absw, at, dt.abs(), k)
    for got, exp, sc in zip(sums, want, scale):
        atol = KMEANS_TOL * max(float(sc.abs().max()), 1.0)
        np.testing.assert_allclose(np.asarray(got), exp.numpy(), rtol=KMEANS_TOL, atol=atol)


@pytest.mark.parametrize("xb,cb,wk,n,k,d", KMEANS_CASES + [
    # past K2's shared-memory layout, where the card takes its general route
    ((), (), "w", 300, 425, 64), ((), (), "w", 300, 10, 1001)])
def test_kmeans_plain_matches_reference_and_pallas(xb, cb, wk, n, k, d):
    jref = _reference("ref")
    jka, jkau = _reference("kmeans_assign"), _reference("kmeans_assign_update")
    X, C, w = _kmeans_inputs(n * 7 + k + d, xb, cb, wk, n, k, d)
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    wt = None if w is None else torch.from_numpy(w)
    a4, d4 = ref.kmeans_assign(Xt, Ct)
    assert a4.dtype == torch.int32 and d4.dtype == torch.float32
    out = ref.kmeans_assign_update(Xt, Ct, wt)
    a2, d2 = out[:2]
    np.testing.assert_array_equal(np.broadcast_to(a4.numpy(), a2.shape), a2.numpy())
    ja, jd = jref.kmeans_assign(X, C)
    _check_assign(X, C, a4.numpy(), d4.numpy(), np.asarray(jd))
    _check_sums(X, w, a2.numpy(), d2.numpy(), k, out[2:])
    jout = jref.kmeans_assign_update(X, C, w)
    pout = jkau.kmeans_assign_update(X, C, w, interpret=True)
    pa, pd = jka.kmeans_assign(X, C, interpret=True)
    _check_assign(X, C, np.asarray(pa), np.asarray(pd), d4.numpy())
    for other in (jout, pout):
        _check_assign(X, C, np.asarray(other[0]), np.asarray(other[1]), d2.numpy())
        if np.array_equal(np.asarray(other[0]), a2.numpy()):
            _check_sums(X, w, a2.numpy(), d2.numpy(), k,
                        [np.asarray(o) for o in other[2:]])
    # the reference's own tie rule: a duplicate center is never chosen
    if k > 2:
        assert not (a2.numpy() == 2).any() and not (np.asarray(pout[0]) == 2).any()


@pytest.mark.parametrize("xb,mb,n,d", LEV_CASES)
def test_leverage_plain_matches_reference(xb, mb, n, d):
    jref, jlev = _reference("ref"), _reference("leverage")
    X, M = _lev_inputs(n + d, xb, mb, n, d)
    got = ref.leverage(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    atol = 1e-6 * (np.abs(X) ** 2).sum(-1).max() * np.abs(M).max()
    np.testing.assert_allclose(got, np.asarray(jref.leverage(X, M)),
                               rtol=1e-5, atol=atol)
    pallas = np.asarray(jlev.leverage(X, M, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("xb,wb,n,d", GRAM_CASES)
def test_weighted_gram_plain_matches_reference(xb, wb, n, d):
    jref, jwg = _reference("ref"), _reference("weighted_gram")
    X, w = _gram_inputs(n * 3 + d, xb, wb, n, d)
    got = ref.weighted_gram(torch.from_numpy(X), torch.from_numpy(w)).numpy()
    scale = np.asarray(jref.weighted_gram(np.abs(X), w)).max()
    atol = 1e-6 * max(scale, 1.0)
    np.testing.assert_allclose(got, np.asarray(jref.weighted_gram(X, w)),
                               rtol=1e-5, atol=atol)
    pallas = np.asarray(jwg.weighted_gram(X, w, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)


def test_cpu_tensors_take_the_plain_version_without_launching():
    X, M = _lev_inputs(0, (3,), (3,), 50, 6)
    Xt, Mt = torch.from_numpy(X), torch.from_numpy(M)
    before = (klev.leverage.launches, kwg.weighted_gram.launches)
    assert torch.equal(klev.leverage(Xt, Mt), klev.plain(Xt, Mt))
    assert torch.equal(ops.leverage(Xt, Mt), ref.leverage(Xt, Mt))
    w = torch.ones(50)
    assert torch.equal(kwg.weighted_gram(Xt, w), kwg.plain(Xt, w))
    assert torch.equal(ops.weighted_gram(Xt, w, use_kernel=False),
                       ref.weighted_gram(Xt, w))
    assert (klev.leverage.launches, kwg.weighted_gram.launches) == before
    C = Xt[..., :4, :]
    before = (kka.kmeans_assign.launches, kkau.kmeans_assign_update.launches)
    for got, want in zip(kka.kmeans_assign(Xt, C), kka.plain(Xt, C)):
        assert torch.equal(got, want)
    for got, want in zip(ops.kmeans_assign_update(Xt, C, w),
                         ref.kmeans_assign_update(Xt, C, w)):
        assert torch.equal(got, want)
    assert (kka.kmeans_assign.launches, kkau.kmeans_assign_update.launches) == before


def test_kmeans_tile_height_and_shared_memory_limit():
    """The planner keeps the shared-memory layout wherever a tile fits and
    names the global variant past that: K2 at k = 424 / 425 with d = 64,
    and both kernels at d = 2048 whatever k."""
    assert kka.tile_rows(10, 90) == 128 and kkau.tile_rows(10, 90, kkau.smem_bytes) == 128
    assert kkau.smem_bytes(10, 90, 128) == 4 * (90 * 16 + 16 + 900 + 20 + 128 + 128 * 93)
    assert KMAX_64 == 424 and kka.tile_rows(KMAX_64, 64, kkau.smem_bytes) == 32
    assert kka.tile_rows(KMAX_64 + 1, 64, kkau.smem_bytes) == kka.GLOBAL
    assert kka.tile_rows(2000, 64) == kka.GLOBAL and kka.tile_rows(425, 64) == 128
    for k in (1, 10):
        assert kka.tile_rows(k, 2048) == kka.GLOBAL
        assert kka.tile_rows(k, 2048, kkau.smem_bytes) == kka.GLOBAL


def test_kmeans_assign_update_layout_planner():
    """K2's stage 1 takes a ring of two tiles at the main-path shapes, keeps
    a shared-memory layout wherever the earlier one-tile layout (C, the
    tile, three per-row arrays and the sums) fitted, and names the global
    variant past it."""
    assert kkau.layout(10, 90) == (128, 2) and kkau.layout(10, 30) == (128, 2)
    assert kkau.smem_bytes(10, 90, 128, 2) <= kka.MAX_SMEM_BYTES
    assert kkau.layout(KMAX_64, 64) == (32, 1)
    assert kkau.layout(KMAX_64 + 1, 64) == (kka.GLOBAL, 0)
    assert kkau.layout(10, 2048) == (kka.GLOBAL, 0) == kkau.layout(2000, 64)
    for k in (1, 7, 10, 33, 200):
        for d in (1, 2, 5, 30, 64, 90, 127, 300, 1000):
            for rows in kka.TILE_ROWS:
                earlier = kka.common_bytes(k, d, rows) + 4 * (3 * rows + k * d + 2 * k)
                assert kkau.smem_bytes(k, d, rows) == earlier
            if kka.tile_rows(k, d, kkau.smem_bytes) != kka.GLOBAL:
                assert kkau.layout(k, d)[0] != kka.GLOBAL


@pytest.mark.parametrize("k,d,rows", [
    (10, 90, 128), (10, 30, 128), (425, 64, 128), (856, 64, 32),
    (19_336, 2, 16), (29_040, 1, 8), (857, 64, kka.GLOBAL),
    (2000, 64, kka.GLOBAL), (1, 2048, kka.GLOBAL), (10, 2048, kka.GLOBAL),
    (19_344, 2, kka.GLOBAL), (29_048, 1, kka.GLOBAL)])
def test_kmeans_assign_layout_planner(k, d, rows):
    """K4's fast kernel takes the tallest tile of ASSIGN_TILE_ROWS whose
    layout fits in a block's shared memory: 128 rows at the main-path
    shapes and at (425, 64), shorter tiles down to 8 rows at the largest k
    of the earlier one-tile layout, and the global variant past that
    layout's line (at d = 2048 too, where 8 or 16 rows would fit)."""
    assert kka.assign_layout(k, d) == rows
    if rows != kka.GLOBAL:
        assert kka.assign_bytes(k, d, rows) <= kka.MAX_SMEM_BYTES
        taller = [r for r in kka.ASSIGN_TILE_ROWS if r > rows]
        assert all(kka.assign_bytes(k, d, r) > kka.MAX_SMEM_BYTES for r in taller)
    else:
        assert kka.tile_rows(k, d) == kka.GLOBAL


def test_kmeans_assign_layout_keeps_capacity():
    """K4's layout: its bytes at (10, 90), tiles the kernel takes (even,
    half of one dividing its 128 threads), and a shared-memory layout
    exactly where the one-tile layout of the earlier kernel fitted."""
    assert kka.assign_bytes(10, 90, 128) == 4 * (90 * 16 + 16 + 2 * 128 + 128 * 91 + 4)
    assert all(r % 2 == 0 and 128 % (r // 2) == 0 for r in kka.ASSIGN_TILE_ROWS)
    for k in (1, 2, 9, 10, 33, 200, 424, 425, 600, 857, 2000):
        for d in (1, 2, 5, 30, 64, 90, 127, 300, 1000, 1400, 2048):
            rows = kka.assign_layout(k, d)
            assert (rows == kka.GLOBAL) == (kka.tile_rows(k, d) == kka.GLOBAL)
            if rows != kka.GLOBAL:
                assert kka.assign_bytes(k, d, rows) <= kka.MAX_SMEM_BYTES


#: (k, d) where K4's fast layout gives GLOBAL (test_kmeans_assign_layout_planner's).
K4_GLOBAL_KD = [(857, 64), (2000, 64), (1, 2048), (10, 2048), (19_344, 2), (29_048, 1)]


def test_kmeans_assign_routes_by_layout():
    """A user's K4 call takes the fast kernel wherever its layout fits in
    half of a block's shared memory, and the tiled route elsewhere: where
    the layout takes more and wherever it gives GLOBAL.  The main path's
    (10, 90) and (10, 30) stay on the fast kernel; the oracle is never a
    route of its own choosing."""
    assert kka.FAST_LAYOUT_LIMIT == kka.MAX_SMEM_BYTES // 2
    for k in (1, 10, 64, 128, 200, 300, 425, 856, 857, 2000, 19_336, 29_040, 29_048):
        for d in (1, 2, 3, 13, 30, 64, 90, 256, 1001, 2048):
            rows = kka.assign_layout(k, d)
            fast = rows != kka.GLOBAL and kka.assign_bytes(k, d, rows) <= kka.FAST_LAYOUT_LIMIT
            assert kka.route_for(k, d) == ("fast" if fast else "tiled")
    for k, d in K4_GLOBAL_KD:
        assert kka.route_for(k, d) == "tiled"
    # either side of the limit, at shapes chip_smoke.py times
    for k, d in [(10, 90), (10, 30), (96, 90), (128, 90), (256, 64), (300, 30), (300, 13)]:
        assert kka.route_for(k, d) == "fast"
    for k, d in [(200, 90), (300, 90), (425, 64), (856, 64), (10, 256), (65, 256),
                 (10, 1001)]:
        assert kka.assign_layout(k, d) != kka.GLOBAL and kka.route_for(k, d) == "tiled"
    assert kka.ROUTES == {"fast": "kmeans_assign_fast_kernel",
                          "tiled": "kmeans_assign_tiled_kernel",
                          "oracle": "kmeans_assign_global_kernel"}


def test_kmeans_assign_launch_rejects_a_route_without_its_layout():
    X, C = torch.zeros(4, 64), torch.zeros(2000, 64)
    with pytest.raises(ValueError, match="no layout"):
        kka._launch(X, C, route="fast")
    with pytest.raises(ValueError, match="route must be one of"):
        kka._launch(X, C, route="general")


def _tiled_smem_bytes(plan):
    """The tiled assign's layout (csrc's tiled_floats): two stages of the
    row tile and the center tile at the stride kc + 4, then x2 and
    ||c||^2."""
    rows, centers = plan.tile_rows, plan.tile_centers
    return 4 * (2 * (rows + centers) * (plan.kc + 4) + rows + centers)


@pytest.mark.parametrize("k,d", K4_GLOBAL_KD + [(300, 90), (425, 64), (10, 256), (33, 1024)])
@pytest.mark.parametrize("B,n", [(1, 1), (1, 257), (3, 20_001), (1, 100_003), (1, 463_715)])
def test_kmeans_assign_tiled_plan(k, d, B, n):
    """K4's tiled plan wherever a user's call takes the tiled route: K2's
    assign tiles (the narrowest center tile that covers k up to 64, else 64
    centers) at 256 threads, halved while the grid with a group per center
    tile has fewer than TILED_MIN_CTAS CTAs, down to 64 threads and never
    below a tile of as many rows as centers; the center groups cover every
    center tile once; the layout fits in shared memory; copies narrow with
    the operands' alignment."""
    plan = kka.tiled_plan(B, n, k, d)
    assert kka.route_for(k, d) == "tiled"
    assert plan.threads in (256, 128, 64)
    assert plan == kka.assign_tiles(B, n, k, d, threads=plan.threads)
    assert plan.tile_rows == kka.gen_rows(plan.tx, plan.threads) >= plan.tile_centers

    def grid(threads):
        t = kka.assign_tiles(B, n, k, d, threads=threads)
        return -(-n // t.tile_rows) * -(-k // t.tile_centers) * B

    for threads in (256, 128, 64):
        if threads > plan.threads:   # every taller tile left the grid short
            assert grid(threads) < kka.TILED_MIN_CTAS
    if plan.threads > 64 and kka.gen_rows(plan.tx, plan.threads // 2) >= plan.tile_centers:
        assert grid(plan.threads) >= kka.TILED_MIN_CTAS
    assert plan.tile_rows * plan.tx % plan.threads == 0   # whole rows a thread
    nct = -(-k // plan.tile_centers)
    assert (plan.groups - 1) * plan.tiles_per_group < nct <= plan.groups * plan.tiles_per_group
    assert plan.groups <= 65_535
    assert _tiled_smem_bytes(plan) <= kka.MAX_SMEM_BYTES
    assert plan.vec == (4 if d % 4 == 0 else 2 if d % 2 == 0 else 1)
    assert kka.tiled_plan(B, n, k, d, align=8).vec == (2 if d % 2 == 0 else 1)
    assert kka.tiled_plan(B, n, k, d, align=4).vec == 1
    # K2's general route runs the same assign tiles at 256 threads
    tiles = kka.assign_tiles(B, n, k, d)
    assert tiles.threads == kka.GEN_THREADS == 256
    assert tuple(kkau.general_plan(B, n, k, d))[:7] == tiles[:-1]
    assert kkau.ASSIGN_TARGET_CTAS == kka.ASSIGN_TARGET_CTAS == 8 * kkau.TARGET_CTAS


@pytest.mark.parametrize("n,k,d,plan", [
    (20_001, 2000, 64, (8, 128, 64, 64, 4, 16, 2, 256)),
    (20_001, 10, 2048, (2, 32, 16, 64, 4, 1, 1, 64)),
    (463_715, 300, 90, (8, 128, 64, 32, 2, 1, 5, 256)),
    (20_001, 856, 64, (8, 128, 64, 64, 4, 14, 1, 256))])
def test_kmeans_assign_tiled_plan_at_the_timed_shapes(n, k, d, plan):
    """chip_smoke.py's timed shapes: (20001, 64) x (2000, 64) over 16 center
    groups of 2 tiles (K2's tiles; a combine follows), (20001, 2048) x
    (10, 2048) one 16-center tile on 32-row tiles of 64 threads (626 CTAs,
    not 157), and the two near the fast layout's line: K2's tiles, 8-byte
    copies at d = 90, 14 groups of one tile at (856, 64)."""
    assert tuple(kka.tiled_plan(1, n, k, d)) == plan
    with pytest.raises(ValueError, match="tiled assign needs"):
        kka.tiled_plan(1, 0, k, d)


#: (k, d) past K2's shared-memory layout: the paper's d = 90 from k = 299,
#: d = 256 from k = 97, d = 64 from k = 425, a party of 1,024 or more
#: columns at k = 10, d % 4 of 1, 2 and 3, and a huge k at d = 1.
K2_GENERAL_KD = [(299, 90), (300, 90), (97, 256), (425, 64), (2000, 64), (10, 1001),
                 (10, 1024), (10, 2048), (1, 2048), (13, 1001), (40, 1402), (9, 3001),
                 (64, 1000), (65, 1000), (500, 63), (29_048, 1), (5000, 7)]


def test_kmeans_assign_update_routes_by_layout():
    """A user's call takes the fast stage 1 wherever its layout fits and the
    general route wherever it gives GLOBAL; the oracle is never a route of
    its own choosing."""
    for k in (1, 10, 300, KMAX_64, KMAX_64 + 1, 2000):
        for d in (1, 3, 30, 64, 90, 256, 1001, 2048):
            fits = kkau.layout(k, d)[0] != kka.GLOBAL
            assert kkau.route_for(k, d) == ("fast" if fits else "general")
    for k, d in K2_GENERAL_KD:
        assert kkau.route_for(k, d) == "general"
    assert (kkau.route_for(298, 90), kkau.route_for(96, 256)) == ("fast", "fast")
    assert set(kkau.ROUTES) == {"fast", "general", "oracle"}


def test_kmeans_assign_update_launch_rejects_a_route_without_its_layout():
    X, C = torch.zeros(4, 64), torch.zeros(KMAX_64 + 1, 64)
    with pytest.raises(ValueError, match="no layout"):
        kkau._launch(X, C, route="fast")
    with pytest.raises(ValueError, match="route must be one of"):
        kkau._launch(X, C, route="wide")


def _assign_smem_bytes(plan):
    """The assign kernel's layout (csrc's launch_assign_kc): two stages of
    the row tile and the center tile at the stride kc + 4, then x2 and
    ||c||^2."""
    rows, centers = plan.tile_rows, plan.tile_centers
    return 4 * (2 * (rows + centers) * (plan.kc + 4) + rows + centers)


@pytest.mark.parametrize("k,d", K2_GENERAL_KD)
@pytest.mark.parametrize("B,n", [(1, 1), (1, 257), (3, 20_001), (1, 463_715)])
def test_kmeans_assign_update_general_plan(k, d, B, n):
    """The general route's plan over (k, d) past the layout: the narrowest
    center tile that covers k up to 64, else 64 centers; 64-column chunks
    only where they pad d no further and two CTAs' rings fit an SM; copies
    as wide as d allows; the center groups cover every center tile once and
    bring the grid to its target where the rows fall short; both layouts
    fit in shared memory; the fold's chunk a power of two of whole copies."""
    plan = kkau.general_plan(B, n, k, d)
    kp = -(-k // 8) * 8
    assert plan.tx == (min(t for t in (1, 2, 4, 8) if 8 * t >= kp) if kp <= 64 else 8)
    assert (plan.tile_rows, plan.tile_centers) == (256 if plan.tx == 1 else 128, 8 * plan.tx)
    assert 256 % plan.tx == 0 and plan.tile_rows % (256 // plan.tx) == 0
    assert plan.kc in (32, 64)
    if plan.kc == 64:
        assert plan.tile_rows + plan.tile_centers <= 200 and -(-d // 64) == -(-d // 32) / 2
    assert plan.vec == (4 if d % 4 == 0 else 2 if d % 2 == 0 else 1)
    nct = -(-k // plan.tile_centers)
    assert (plan.groups - 1) * plan.tiles_per_group < nct <= plan.groups * plan.tiles_per_group
    row_tiles = -(-n // plan.tile_rows)
    ctas = row_tiles * plan.groups * B
    assert ctas >= min(kkau.ASSIGN_TARGET_CTAS, row_tiles * nct * B)
    if plan.tiles_per_group < nct:   # one tile more a group would fall short
        per = plan.tiles_per_group + 1
        assert row_tiles * -(-nct // per) * B < kkau.ASSIGN_TARGET_CTAS
    assert _assign_smem_bytes(plan) <= kka.MAX_SMEM_BYTES
    fc = plan.fold_cols
    assert fc in (4, 8, 16, 32, 64) and fc % plan.vec == 0 and 256 % (fc // plan.vec) == 0
    p2 = 1 << max(2, (d - 1).bit_length())   # d's power of two, at least 4
    widths = [min(c, p2) for c in (64, 32)]
    fits = [c for c in widths if kkau.fold_bytes(c, k, d, True) <= kka.MAX_SMEM_BYTES]
    assert plan.acc_in_smem == bool(fits) and fc == (fits or widths)[0]
    assert kkau.fold_bytes(fc, k, d, plan.acc_in_smem) <= kka.MAX_SMEM_BYTES


@pytest.mark.parametrize("k,d,plan", [
    (2000, 64, (8, 128, 64, 64, 4, 16, 2, 64, False)),
    (10, 2048, (2, 128, 16, 64, 4, 1, 1, 64, True)),
    (300, 90, (8, 128, 64, 32, 2, 1, 5, 32, True))])
def test_kmeans_assign_update_general_plan_at_the_timed_shapes(k, d, plan):
    """chip_smoke.py's three general-route shapes: (20001, 64) x (2000, 64)
    over 16 center groups of 2 tiles with the sums in the scratch,
    (20001, 2048) x (10, 2048) a 16-center tile, (463715, 90) x (300, 90)
    8-byte copies (d % 4 = 2) and 96 product columns."""
    n = 463_715 if k == 300 else 20_001
    assert tuple(kkau.general_plan(1, n, k, d)) == plan
    # X or C off a 16-byte boundary takes narrower copies, nothing else
    assert kkau.general_plan(1, n, k, d, align=8).vec == (2 if d % 2 == 0 else 1)
    assert kkau.general_plan(1, n, k, d, align=4).vec == 1


def test_kmeans_assign_update_general_plan_rejects_empty_shapes():
    for shape in [(0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0)]:
        with pytest.raises(ValueError, match="general route needs"):
            kkau.general_plan(*shape)


def test_row_split_is_a_function_of_n():
    assert kkau.row_split(1) == (kkau.MIN_ROWS, 1)
    assert kkau.row_split(5000) == (256, 20)
    rows, P = kkau.row_split(463_715)
    assert P <= kkau.TARGET_CTAS and rows * P >= 463_715 > rows * (P - 1)
    assert (rows, P) == (1757, 264)


def test_gram_split_is_a_function_of_n():
    """K3's own split: at least one 32-row stage per range, more ranges
    than the card's 132 SMs at n = 5,000, about two per SM at full n."""
    assert kwg.gram_split(1) == (kwg.GRAM_MIN_ROWS, 1)
    assert kwg.gram_split(5000) == (32, 157)
    rows, P = kwg.gram_split(463_715)
    assert P <= kwg.GRAM_TARGET_CTAS and rows * P >= 463_715 > rows * (P - 1)
    assert (rows, P) == (1757, 264)


def test_leverage_kernel_choice_by_width():
    """M stays whole in shared memory up to s = 238; wider parties take
    the wide kernel, whose X tile shrinks with s."""
    assert klev.SHARED_M_WIDTH == 238
    assert 238 ** 2 * 4 <= klev.MAX_SMEM_BYTES
    assert [klev.wide_rows(s) for s in (239, 256, 512)] == [50, 47, 23]
    assert klev.wide_rows(58_104) == 1
    with pytest.raises(ValueError, match="shared memory"):
        klev.wide_rows(58_105)


@pytest.mark.parametrize("s,kernel", [
    (1, "leverage_reg_kernel"), (31, "leverage_reg_kernel"), (8, "leverage_kernel"),
    (32, "leverage_kernel"), (33, "leverage_kernel"), (238, "leverage_kernel"),
    (239, "leverage_tiled_kernel"), (2048, "leverage_tiled_kernel"),
    (58_105, "leverage_tiled_kernel")])
def test_leverage_route_by_width(s, kernel):
    """s <= 238 keeps the register and shared-memory kernels; every wider s
    takes the tiled product (which has no width limit of its own); the wide
    kernel runs only as the oracle."""
    assert klev.kernel_for(s) == kernel
    assert klev.kernel_for(s, wide=True) == "leverage_wide_kernel"


@pytest.mark.parametrize("n", [1, 256, 20_001, 463_715])
@pytest.mark.parametrize("s", [239, 256, 512, 1001, 2048])
def test_leverage_tiled_plan(s, n):
    """The tiled kernel's plan: T's width s rounded up to 8, the chunks
    covering n in whole 64-row tiles where n is cut, and the scratch never
    above TILED_SCRATCH_FLOATS."""
    plan = klev.tiled_plan(1, n, s)
    sp = -(-s // 8) * 8
    rows = plan.chunk_rows
    assert plan.sp == sp and plan.batches == 1
    assert plan.scratch_floats == rows * sp <= klev.TILED_SCRATCH_FLOATS
    assert rows * plan.chunks >= n > rows * (plan.chunks - 1)
    if plan.chunks == 1:
        assert rows == n
    else:
        assert rows % 64 == 0 and (rows + 64) * sp > klev.TILED_SCRATCH_FLOATS
    want = {(2048, 256): (256, 1), (512, 20_001): (20_001, 1), (2048, 463_715): (8192, 57),
            (1001, 20_001): (16_640, 2)}
    if (s, n) in want:
        assert (rows, plan.chunks) == want[(s, n)]


@pytest.mark.parametrize("B,n,s,batches,rows", [
    (3, 463_715, 2048, 3, 2688), (3, 20_001, 512, 3, 10_880), (2, 257, 256, 2, 257),
    (70_000, 5, 2048, 8192, 1), (70_000, 1, 239, 65_535, 1),
    # the card's batch-group case: the cap binds at 55,188, the grid at 65,535
    (55_189, 1, 300, 55_188, 1), (65_536, 1, 240, 65_535, 1)])
def test_leverage_tiled_plan_batched(B, n, s, batches, rows):
    """Batch entries share a chunk's scratch, up to the grid's 65,535 along
    z and the cap; the C entry runs the rest in later groups."""
    plan = klev.tiled_plan(B, n, s)
    assert (plan.batches, plan.chunk_rows) == (batches, rows)
    assert plan.scratch_floats == batches * rows * plan.sp <= klev.TILED_SCRATCH_FLOATS
    assert plan.chunks == -(-n // rows) * -(-B // batches)


@pytest.mark.parametrize("B,n,s,match", [
    (0, 5, 300, "B, n, s >= 1"), (1, 0, 300, "B, n, s >= 1"), (1, 5, 0, "B, n, s >= 1"),
    (1, 5, 65_535 * 64 + 1, "takes s up to 4194240")])
def test_leverage_tiled_plan_rejects(B, n, s, match):
    with pytest.raises(ValueError, match=match):
        klev.tiled_plan(B, n, s)


def test_leverage_kernel_for_rejects_an_empty_width():
    with pytest.raises(ValueError, match="s >= 1"):
        klev.kernel_for(0)


# --------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xb,mb,n,d", LEV_CASES + [
    ((), (), 4097, 238), ((3,), (3,), 100_003, 31), ((), (), 4097, 239),
    ((2,), (), 1001, 256), ((), (), 777, 512),
    # the tiled kernel: one row, batched X, batched M, s % 4 != 0, the
    # selector's width, two scratch chunks
    ((), (), 1, 239), ((2,), (), 257, 256), ((), (3,), 1001, 512), ((), (), 300, 1001),
    ((), (), 256, 2048), ((), (), 17_000, 1001)])
def test_leverage_kernel_matches_plain(xb, mb, n, d):
    dev = _cuda()
    X, M = (torch.from_numpy(a).to(dev) for a in _lev_inputs(n + d, xb, mb, n, d))
    before = klev.leverage.launches
    got = klev.leverage(X, M)
    again = klev.leverage(X, M)
    assert klev.leverage.launches == before + 2
    want = klev.plain(X, M)
    assert torch.equal(got, again)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("xb,wb,n,d", GRAM_CASES + [((), (), 20_001, 90), ((), (), 777, 200)])
def test_weighted_gram_kernel_matches_plain_and_is_deterministic(xb, wb, n, d):
    dev = _cuda()
    X, w = (torch.from_numpy(a).to(dev) for a in _gram_inputs(n * 3 + d, xb, wb, n, d))
    before = kwg.weighted_gram.launches
    got = kwg.weighted_gram(X, w)
    again = kwg.weighted_gram(X, w)
    assert kwg.weighted_gram.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(-1, -2))   # one triangle, mirrored
    want = kwg.plain(X, w)
    scale = kwg.plain(X.abs(), w.abs()).max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("xb,cb,wk,n,k,d", KMEANS_CASES + [
    ((3,), (3,), None, 100_003, 10, 30), ((), (), "w", 20_001, 10, 90),
    ((), (), "w", 1001, KMAX_64, 64), ((), (), "w", 1001, KMAX_64 + 1, 64),
    ((), (), None, 1001, 2000, 64), ((2,), (2,), "wb", 257, 10, 2048)])
def test_kmeans_kernels_match_plain_and_are_deterministic(xb, cb, wk, n, k, d):
    dev = _cuda()
    X, C, w = _kmeans_inputs(n * 7 + k + d, xb, cb, wk, n, k, d)
    Xt, Ct = torch.from_numpy(X).to(dev), torch.from_numpy(C).to(dev)
    wt = None if w is None else torch.from_numpy(w).to(dev)
    before = (kka.kmeans_assign.launches, kkau.kmeans_assign_update.launches)
    a4, d4 = kka.kmeans_assign(Xt, Ct)
    got = kkau.kmeans_assign_update(Xt, Ct, wt)
    again = kkau.kmeans_assign_update(Xt, Ct, wt)
    assert (kka.kmeans_assign.launches, kkau.kmeans_assign_update.launches) == (
        before[0] + 1, before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert a4.dtype == got[0].dtype == torch.int32
    assert torch.equal(torch.broadcast_to(a4, got[0].shape), got[0])
    pa, pd = kka.plain(Xt, Ct)
    cpu = lambda t: t.cpu().numpy()
    _check_assign(X, C, cpu(got[0]), cpu(got[1]), np.broadcast_to(cpu(pd), got[1].shape))
    _check_sums(X, w, cpu(got[0]), cpu(got[1]), k, [cpu(t) for t in got[2:]])
    if k > 2:
        assert not (cpu(got[0]) == 2).any()


#: The general route's cases: batch on X, on C, on both and on w; w None,
#: ones, random and all zero; every row in one cluster; k not a multiple of
#: 8; d = 1001 (4-byte copies) and d = 90 (8-byte); the timed shapes'
#: (k, d); n = 1, 257 and 100,003.
K2_GENERAL_CASES = [((3,), (), "w", 257, 425, 64), ((), (2,), "w", 1001, 425, 64),
                    ((2,), (2,), None, 300, 2000, 64), ((2,), (2,), "wb", 257, 10, 2048),
                    ((), (), None, 1, 425, 64), ((), (), "ones", 1001, 2000, 64),
                    ((), (), "zero", 777, 500, 64), ((), (), "one", 20_001, 300, 90),
                    ((), (), "w", 300, 13, 1001), ((), (), "w", 100_003, 300, 90),
                    ((), (), "w", 20_001, 10, 2048), ((), (), "ones", 1, 10, 1001),
                    ((), (), "w", 2000, 29_048, 1)]


def _one_cluster_inputs(seed, n, k, d):
    """Every row next to center 3: one cluster holds all rows."""
    r = np.random.default_rng(seed)
    C = r.standard_normal((k, d)).astype(np.float32)
    X = (C[3] + 1e-3 * r.standard_normal((n, d))).astype(np.float32)
    return X, C, r.uniform(0.0, 3.0, (n,)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("xb,cb,wk,n,k,d", KMEANS_CASES + [
    ((3,), (3,), None, 100_003, 10, 30), ((), (), "w", 20_001, 10, 90),
    ((), (), "w", 257, 10, 90), ((), (), "w", 1001, KMAX_64, 64),
    ((), (), "w", 3001, 40, 300), ((), (), "one", 100_003, 10, 90),
    ((), (), "one", 1000, 4, 7)] + K2_GENERAL_CASES)
def test_kmeans_assign_update_equals_its_global_variant(xb, cb, wk, n, k, d):
    """A user's call, on the fast stage 1 or past its layout on the general
    route, gives the global variant's (the oracle's) assign, d2 and sums
    bit for bit (the same fmaf chain for every entry) in one counted launch,
    and two launches agree: ragged last tiles and ranges, a one-row range
    (n = 257), the one-tile layout at k = 424, a 32-row tile at d = 300,
    every row in one cluster, and K2_GENERAL_CASES."""
    dev = _cuda()
    if wk == "one":
        X, C, w = _one_cluster_inputs(n + k + d, n, k, d)
    else:
        X, C, w = _kmeans_inputs(n * 7 + k + d, xb, cb, "w" if wk == "ones" else wk,
                                 n, k, d)
        if wk == "ones":
            w = np.ones_like(w)
    Xt, Ct = torch.from_numpy(X).to(dev), torch.from_numpy(C).to(dev)
    wt = None if w is None else torch.from_numpy(w).to(dev)
    assert kkau.route_for(k, d) == ("fast" if kkau.layout(k, d)[0] != kka.GLOBAL
                                    else "general")
    before = kkau.kmeans_assign_update.launches
    got = kkau.kmeans_assign_update(Xt, Ct, wt)
    again = kkau.kmeans_assign_update(Xt, Ct, wt)
    assert kkau.kmeans_assign_update.launches == before + 2
    oracle = kkau._launch(Xt, Ct, wt, global_variant=True)
    for a, b, c in zip(got, again, oracle):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    if wk == "one":
        assert bool((got[0] == 3).all())
    elif k > 2:
        assert not bool((got[0] == 2).any())


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(1001, KMAX_64, 64), (20_001, 10, 90), (257, 10, 90)])
def test_kmeans_assign_update_general_route_equals_the_fast_stage(n, k, d):
    """Where both can run, the general route forced gives the fast stage
    1's outputs bit for bit: the same row split and the same partials."""
    dev = _cuda()
    X, C, w = (None if a is None else torch.from_numpy(a).to(dev)
               for a in _kmeans_inputs(n + k, (), (), "w", n, k, d))
    assert kkau.route_for(k, d) == "fast"
    fast = kkau._launch(X, C, w, route="fast")
    general = kkau._launch(X, C, w, route="general")
    for a, b in zip(fast, general):
        assert torch.equal(a, b)


#: K4's edges beyond KMEANS_CASES: a short last tile over many CTAs, fewer
#: rows than a tile, k = 9 (a last block of one center), batch on C only,
#: and each shorter tile (32, 16 and 8 rows).
K4_EDGES = [((), (), None, 100_003, 10, 90), ((), (), None, 7, 9, 90),
            ((3,), (), None, 129, 9, 1), ((), (2,), None, 1000, 10, 90),
            ((), (), None, 300, 856, 64), ((), (), None, 300, 19_336, 2),
            ((), (), None, 300, 29_040, 1)]


#: K4's tiled route (k d past the fast layout): K2_GENERAL_KD's GLOBAL (k, d)
#: of K4, then one row; k = 1 at d = 2048; (29,048, 1) and (19,344, 2), whose
#: 32-column chunks are mostly zeros; C[k - 1] = C[0] in another center group
#: ("dup"); a NaN row ("nan"); batch on X, on C and on both; X off a 16-byte
#: boundary ("off4", "off8": 4- and 8-byte copies); many groups at n = 1.
K4_TILED_CASES = [((), (), None, 2001, k, d) for k, d in K2_GENERAL_KD
                  if kka.assign_layout(k, d) == kka.GLOBAL] + [
    ((), (), None, 1, 2000, 64), ((), (), None, 20_001, 2000, 64),
    ((), (), None, 20_001, 10, 2048), ((), (), None, 257, 1, 2048),
    ((), (), None, 300, 29_048, 1), ((), (), None, 300, 19_344, 2),
    ((), (), "dup", 1001, 2000, 64), ((), (), "nan", 1001, 2000, 64),
    ((), (), "nan", 300, 10, 2048), ((3,), (), None, 129, 2000, 64),
    ((), (2,), None, 257, 10, 2048), ((2,), (2,), None, 300, 900, 64),
    ((), (), "off4", 1001, 857, 64), ((), (), "off8", 1001, 10, 2048),
    ((), (), "off4", 777, 9, 3001)]


def _k4_inputs(dev, xb, cb, kind, n, k, d):
    """X and C on the card per the case's kind (see K4_TILED_CASES)."""
    X, C, _ = _kmeans_inputs(n * 7 + k + d, xb, cb, None, n, k, d)
    if kind == "dup":   # a tie across groups, and rows next to it
        C[..., k - 1, :] = C[..., 0, :]
        X[..., :8, :] = C[..., :1, :] + 1e-3 * X[..., :8, :]
    if kind == "nan":
        X[..., n // 2, :] = np.nan
    Xt, Ct = torch.from_numpy(X).to(dev), torch.from_numpy(C).to(dev)
    if kind in ("off4", "off8"):
        off = 1 if kind == "off4" else 2
        buf = torch.empty(Xt.numel() + off, device=dev)
        buf[off:] = Xt.reshape(-1)
        Xt = buf[off:].view(Xt.shape)
        assert Xt.is_contiguous() and Xt.data_ptr() % 16 == 4 * off
    return Xt, Ct


@pytest.mark.gpu
@pytest.mark.parametrize("xb,cb,wk,n,k,d", KMEANS_CASES + K4_EDGES + K4_TILED_CASES)
def test_kmeans_assign_equals_its_global_variant(xb, cb, wk, n, k, d):
    """A user's K4 call, on the fast kernel or on the tiled route, gives the
    global variant's (the oracle's) assign and d2 bit for bit
    (kmeans_common.cuh's bit contract) in one counted launch, and two
    launches agree: KMEANS_CASES, K4_EDGES and K4_TILED_CASES.  Where the
    fast layout fits but the call takes the tiled route (K4_EDGES' short
    tiles), the fast kernel forced gives the same bits."""
    dev = _cuda()
    if wk in (None, "dup", "nan", "off4", "off8"):
        Xt, Ct = _k4_inputs(dev, xb, cb, wk, n, k, d)
    else:
        X, C, _ = _kmeans_inputs(n * 7 + k + d, xb, cb, wk, n, k, d)
        Xt, Ct = torch.from_numpy(X).to(dev), torch.from_numpy(C).to(dev)
    rows = kka.assign_layout(k, d)
    fits = rows != kka.GLOBAL and kka.assign_bytes(k, d, rows) <= kka.FAST_LAYOUT_LIMIT
    assert kka.route_for(k, d) == ("fast" if fits else "tiled")
    before = kka.kmeans_assign.launches
    got = kka.kmeans_assign(Xt, Ct)
    again = kka.kmeans_assign(Xt, Ct)
    assert kka.kmeans_assign.launches == before + 2
    oracle = kka._launch(Xt, Ct, global_variant=True)
    for a, b, c in zip(got, again, oracle):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    if rows != kka.GLOBAL:   # the fast kernel, wherever its layout fits
        for a, c in zip(kka._launch(Xt, Ct, route="fast"), oracle):
            assert torch.equal(a, c)
    if wk == "dup":
        assert not bool((got[0] == k - 1).any())
        assert bool((got[0] == 0).any())
    if wk == "nan":
        assert int(got[0][..., n // 2].max()) == 0 and float(got[1][..., n // 2].max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", [(20_001, 10, 90), (1001, 856, 64), (257, 425, 64),
                                   (300, 29_040, 1), (100_003, 300, 90), (129, 9, 1)])
def test_kmeans_assign_tiled_route_equals_the_fast_kernel(n, k, d):
    """Where the fast layout fits, the two routes forced give the same
    assign and d2 bit for bit, one counted launch each."""
    dev = _cuda()
    X, C = _k4_inputs(dev, (), (), None, n, k, d)
    assert kka.assign_layout(k, d) != kka.GLOBAL
    before = kka.kmeans_assign.launches
    fast = kka._launch(X, C, route="fast")
    tiled = kka._launch(X, C, route="tiled")
    assert kka.kmeans_assign.launches == before + 2
    for a, b in zip(fast, tiled):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kmeans_assign_tiled_entry_rejects_copies_past_the_alignment():
    """The tiled route's C entry refuses 16-byte copies from an X that
    starts 4 bytes off 16 (tiled_plan's vec at align 16) instead of issuing
    misaligned cp.async copies."""
    from repro_torch.kernels._build import library
    dev = _cuda()
    n, k, d = 1001, 2000, 64
    X, C = _k4_inputs(dev, (), (), "off4", n, k, d)
    plan = kka.tiled_plan(1, n, k, d)
    assert plan.vec == 4 and plan.groups > 1
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    d2 = torch.empty(n, device=dev)
    pv = torch.empty((1, plan.groups, n), device=dev)
    pa = torch.empty((1, plan.groups, n), dtype=torch.int32, device=dev)
    code = library().repro_kmeans_assign_tiled(
        X.data_ptr(), C.data_ptr(), assign.data_ptr(), d2.data_ptr(), pv.data_ptr(),
        pa.data_ptr(), 1, n, d, k, plan.tx, plan.tile_rows, plan.kc, plan.groups,
        plan.tiles_per_group, plan.vec, 0, 0, torch.cuda.current_stream().cuda_stream)
    assert code != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("xb,cb,n,k,d,threads", [
    ((), (), 20_001, 2000, 64, 256), ((), (), 1001, 2000, 64, 128),
    ((), (), 20_001, 10, 2048, 64), ((3,), (), 20_001, 10, 2048, 128),
    ((), (), 100_003, 10, 2048, 256), ((), (), 777, 33, 1024, 128),
    ((), (), 1001, 1, 2048, 64), ((2,), (2,), 300, 900, 64, 128),
    ((), (), 300, 29_048, 1, 256)])
def test_kmeans_assign_tiled_route_at_every_cta_size(xb, cb, n, k, d, threads):
    """The tiled route on each CTA size that tiled_plan picks (256, 128 and
    64 threads, by the shapes) gives the oracle's bits."""
    dev = _cuda()
    X, C = _k4_inputs(dev, xb, cb, None, n, k, d)
    B = max(int(np.prod(xb)), int(np.prod(cb)))
    assert kka.tiled_plan(B, n, k, d).threads == threads
    oracle = kka._launch(X, C, global_variant=True)
    for a, c in zip(kka._launch(X, C, route="tiled"), oracle):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("xb,mb,n,d,zero", [c + (None,) for c in LEV_CASES] + [
    ((3,), (3,), 100_003, 31, None), ((), (), 300, 1, None),
    ((2,), (), 1000, 8, None), ((), (2,), 2049, 24, None),
    ((3,), (3,), 4097, 32, None), ((), (), 300, 33, None),
    ((3,), (), 1001, 30, None), ((), (3,), 1001, 28, None),
    ((), (), 513, 238, None), ((3,), (3,), 1001, 31, "row"),
    ((3,), (3,), 1001, 31, "M"),
    ((), (), 1, 239, None), ((2,), (), 257, 256, None), ((), (3,), 1001, 512, None),
    ((), (), 300, 1001, None), ((), (), 256, 2048, None), ((), (), 1001, 512, "row"),
    ((), (), 1001, 512, "M"), ((), (), 17_000, 1001, None)])
def test_leverage_equals_its_wide_variant(xb, mb, n, d, zero):
    """K1's kernel for each width (the register kernel to s = 31, M in
    shared memory at s = 8, 24, 32, 33 and up to 238, the tiled product
    past it, over two scratch chunks at (17000, 1001)) gives the wide
    kernel's output bit for bit, also for an all-zero row and an all-zero M,
    and two launches agree."""
    dev = _cuda()
    if d > klev.SHARED_M_WIDTH:
        assert klev.kernel_for(d) == "leverage_tiled_kernel"
        assert klev.tiled_plan(1, n, d).chunks == (2 if n == 17_000 else 1)
    X, M = _lev_inputs(n + d, xb, mb, n, d)
    if zero == "row":
        X[..., n // 2, :] = 0.0
    if zero == "M":
        M[...] = 0.0
    Xt, Mt = torch.from_numpy(X).to(dev), torch.from_numpy(M).to(dev)
    got = klev.leverage(Xt, Mt)
    again = klev.leverage(Xt, Mt)
    oracle = klev._launch(Xt, Mt, wide=True)
    assert torch.equal(got, again)
    assert torch.equal(got, oracle)


@pytest.mark.gpu
@pytest.mark.parametrize("xb,mb,n,d", [((), (), 256, 2048), ((), (3,), 1001, 512),
                                       ((2,), (), 300, 1001)])
def test_leverage_tiled_kernel_on_a_column_major_M(xb, mb, n, d):
    """A column-major M (as torch.linalg.inv returns it), copied row-major
    by the wrapper, gives the bits of the same M contiguous, and the wide
    kernel's."""
    dev = _cuda()
    X, M = (torch.from_numpy(a).to(dev) for a in _lev_inputs(n + d + 1, xb, mb, n, d))
    Mcol = M.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(Mcol, M) and not Mcol.is_contiguous()
    got = klev.leverage(X, Mcol)
    assert torch.equal(got, klev.leverage(X, M))
    assert torch.equal(got, klev._launch(X, Mcol, wide=True))


@pytest.mark.gpu
def test_leverage_tiled_kernel_over_batch_groups():
    """55,189 parties of one row at s = 300 fill the scratch's cap with
    55,188 a group: the C entry's second group gives the wide kernel's bits
    and the plain version's values, in one counted launch."""
    dev = _cuda()
    B, n, d = 55_189, 1, 300
    plan = klev.tiled_plan(B, n, d)
    assert (plan.batches, plan.chunks) == (55_188, 2)
    X, M = (torch.from_numpy(a).to(dev) for a in _lev_inputs(B + d, (B,), (), n, d))
    before = klev.leverage.launches
    got = klev.leverage(X, M)
    assert klev.leverage.launches == before + 1
    assert torch.equal(got, klev._launch(X, M, wide=True))
    want = klev.plain(X, M)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(scale, 1e-30))


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    with pytest.raises(ValueError):
        klev.leverage(torch.zeros(2, 4, 3, device=dev), torch.zeros(3, 3, 3, device=dev))
    with pytest.raises(ValueError):
        kwg.weighted_gram(torch.zeros(4, 3, device=dev), torch.zeros(5, device=dev))
    with pytest.raises(ValueError):
        kwg.weighted_gram(torch.zeros(4, 3, device=dev), torch.zeros(4))
    with pytest.raises(ValueError):
        kka.kmeans_assign(torch.zeros(4, 3, device=dev), torch.zeros(2, 4, device=dev))
    with pytest.raises(ValueError):
        kkau.kmeans_assign_update(torch.zeros(2, 4, 3, device=dev),
                                  torch.zeros(3, 2, 3, device=dev))
    with pytest.raises(ValueError):
        kkau.kmeans_assign_update(torch.zeros(4, 3, device=dev),
                                  torch.zeros(2, 3, device=dev), torch.ones(5, device=dev))
