"""The ``vkmc`` slice end to end: the task's key chain and scores,
``CoresetPipeline.build`` -> ``fit_kmeans`` -> ``evaluate`` and
``end_to_end(k=)``, against ``repro.core`` with ``backend="ref"``, both on
the CPU, from the same numpy data and key.

Tolerances:

- The DIS key and every bill (units, bits, per-tag ledger) are exact.
- Scores are held at ``rtol=1e-4``: local k-means++ picks the same rows,
  then 15 Lloyd iterations and the scoring pass sum in another order than
  XLA (observed gap about 5e-7 relative on these inputs).
- The draw is exact on the reference's own scores: DIS on shared scores is
  exact by construction (``test_torch_dis.py``).
- ``rel_error`` is held by quality, since iterated Lloyd amplifies fp
  differences: within an absolute ``2e-3`` of the reference's, finite and
  below the ``benchmarks/e2e.py`` gate of 0.5; the identity coreset, fit
  with the baseline's key, gives exactly 0.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core.api import build_coreset as j_build_coreset
from repro.core.api import vkmc_scores as j_vkmc_scores
from repro.core.solve import end_to_end as j_end_to_end
from repro.core.solve import fit_kmeans as j_fit_kmeans
from repro.core.solve import full_data_coreset as j_full_data_coreset
from repro_torch import rng
from repro_torch.convert import (
    centers_from_numpy, coreset_from_numpy, dataset_from_numpy, key_from_numpy)
from repro_torch.core import (
    DEFAULT_SOLVER, CommLedger, CommSchedule, CoresetPipeline, CoresetSpec,
    build_coreset, end_to_end, evaluate, fit_kmeans, full_data_coreset, get_task,
    solver_for)
from repro_torch.core.api import vkmc_scores
from repro_torch.core.dis import dis_plan_full

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


def _both(seed, n=2000, d=13, k=8, T=3):
    """Clustered rows (``chip_smoke.make_data``'s style, small), split
    unevenly when d % T != 0 (d = 13 -> widths 5, 4, 4: the stacked view
    pads two parties)."""
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((k, d)).astype(np.float32)
    X = (centers[r.integers(0, k, n)]
         + r.standard_normal((n, d)).astype(np.float32)).astype(np.float32)
    jds = JDataset.from_dense(X, None, T=T)
    return jds, dataset_from_numpy([np.asarray(p) for p in jds.parts], None, "cpu")


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


@pytest.mark.parametrize("seed,n,d,T,k,m", [(0, 2000, 13, 3, 6, 300),
                                            (1, 901, 12, 4, 4, 97)])
def test_vkmc_task_key_chain_scores_and_draw(seed, n, d, T, k, m):
    jds, tds = _both(seed, n, d, T=T)
    assert tds.stacked().blocks.shape == (T, n, -(-d // T))
    kj, kt = _keys(seed + 40)
    sj, dkj = j_vkmc_scores(kj, jds, backend="ref", k=k)
    for backend in ("ref", "pallas"):        # on the CPU both take the plain path
        st, dkt = vkmc_scores(kt, tds, backend=backend, k=k)
        np.testing.assert_array_equal(dkt.numpy(), np.asarray(dkj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)
    np.testing.assert_allclose(st.sum(1).numpy(), [2 * (k + 1) * 2.0] * T, rtol=1e-5)
    jcs = j_build_coreset("vkmc", jds, m, key=kj, backend="ref", k=k)
    plan = dis_plan_full(dkt, torch.from_numpy(np.array(sj)), m)
    np.testing.assert_array_equal(plan.indices.numpy(), np.asarray(jcs.indices))
    np.testing.assert_allclose(plan.weights.numpy(), np.asarray(jcs.weights), rtol=1e-6)
    tcs = build_coreset("vkmc", tds, m, key=kt, backend="ref", k=k, device="cpu")
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert tcs.comm_units == CommSchedule.dis_total(T, m)
    np.testing.assert_array_equal(tcs.indices.numpy(), np.asarray(jcs.indices))
    # the norm backend returns the DIS key of the same chain
    sn, dkn = vkmc_scores(kt, tds, backend="norm")
    assert torch.equal(dkn, dkt) and sn.shape == (T, n)


@pytest.mark.parametrize("seed,m", [(2, 400), (3, 150)])
def test_end_to_end_vkmc_matches_reference(seed, m):
    jds, tds = _both(seed)
    kj, kt = _keys(seed + 50)
    jl, tl = JLedger(), CommLedger()
    jcs, jfit, jrep = j_end_to_end(
        JSpec(task="vkmc", budgets=m, backend="ref", params={"k": 8}),
        jds, key=kj, k=8, ledger=jl)
    tcs, tfit, trep = end_to_end(CoresetSpec(task="vkmc", budgets=m, params={"k": 8}),
                                 tds, key=kt, k=8, ledger=tl, device="cpu")
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    assert tl.total == CommSchedule.dis_total(3, m) + 2 * m * 3
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert (tfit.task, tfit.k, tfit.params.shape) == ("kmeans", 8, (8, 13))
    assert np.isfinite(trep.rel_error) and trep.rel_error < 0.5
    assert abs(trep.rel_error - jrep.rel_error) <= REL_GAP
    assert (trep.m, trep.n, trep.comm_units) == (jrep.m, jrep.n, jrep.comm_units)
    # against the reference's own full-data baseline, carried across
    sk_j = jax.random.fold_in(kj, 1)
    base_j = j_fit_kmeans(jds, j_full_data_coreset(jds), 8, key=sk_j).params
    rep_b = evaluate(tds, tfit, baseline=centers_from_numpy(np.asarray(base_j), "cpu"))
    assert rep_b.cost_opt == pytest.approx(jrep.cost_opt, rel=1e-4)
    assert abs(rep_b.rel_error - jrep.rel_error) <= REL_GAP
    # the port fits a reference-built coreset like the reference does
    tcs_j = coreset_from_numpy(np.asarray(jcs.indices), np.asarray(jcs.weights),
                               jcs.comm_units, jcs.comm_bits, "cpu")
    fit_j = fit_kmeans(tds, tcs_j, 8, key=rng.fold_in(kt, 1))
    assert fit_j.objective == pytest.approx(jfit.objective, rel=1e-3)


def test_identity_coreset_restarts_and_validation():
    _, tds = _both(4, n=600, d=9)
    kt = rng.PRNGKey(5)
    sk = rng.fold_in(kt, 1)
    full = fit_kmeans(tds, full_data_coreset(tds), 5, key=sk, iters=10)
    rep = evaluate(tds, full, key=sk, iters=10)
    assert rep.rel_error == 0.0 and rep.comm_units == 0 and rep.m == tds.n
    best = fit_kmeans(tds, full_data_coreset(tds), 5, key=sk, iters=10, restarts=3)
    assert best.objective <= full.objective
    with pytest.raises(ValueError, match="restarts"):
        fit_kmeans(tds, full_data_coreset(tds), 5, key=sk, restarts=0)
    with pytest.raises(ValueError, match="key"):
        evaluate(tds, full)
    assert solver_for("vkmc") == DEFAULT_SOLVER["vkmc"] == "kmeans"
    assert solver_for("vrlr") == "ridge" and solver_for("uniform") is None
    assert get_task("vkmc").deterministic_scores is False
    assert get_task("vrlr").deterministic_scores is True
    # the staged path is end_to_end's: same key, same coreset, same error
    m, key = 64, rng.PRNGKey(6)
    cs = CoresetPipeline(tds).build(CoresetSpec(task="vkmc", budgets=m,
                                                params={"k": 5}),
                                    key=key, device="cpu")
    fit = fit_kmeans(tds, cs, 5, key=rng.fold_in(key, 1), iters=10)
    rep = evaluate(tds, fit, key=rng.fold_in(key, 1), iters=10)
    cs_e, _, rep_e = end_to_end(CoresetSpec(task="vkmc", budgets=m, params={"k": 5}),
                                tds, key=key, k=5, iters=10, device="cpu")
    assert torch.equal(cs.indices, cs_e.indices) and rep.rel_error == rep_e.rel_error
