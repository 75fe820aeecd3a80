"""The ported slice end to end: ``end_to_end("vrlr")`` (build -> fit_ridge ->
evaluate) against ``repro.core.solve.end_to_end`` with ``backend="ref"``,
both on the CPU, from the same numpy data and key.

Tolerances: the bill is exact (units and bits).  The draw is exact: the
scores agree to about 1e-5 (two fp32 ``eigh``s), far below any gap the
gumbel-max draw would notice on this data, and on shared scores the DIS
step is exact by construction (``test_torch_dis.py``).  ``theta`` is held
at ``rtol=1e-4`` of its largest entry and ``rel_error`` at an absolute
``1e-5`` (fp32 solves of the same normal equations).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import CommLedger as JLedger
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core.api import build_coreset as j_build_coreset
from repro.core.api import vrlr_scores as j_vrlr_scores
from repro.core.solve import end_to_end as j_end_to_end
from repro.core.solve import fit_ridge as j_fit_ridge
import repro_torch
from repro_torch import rng
from repro_torch.convert import coreset_from_numpy, dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, build_coreset,
    compile_plan, end_to_end, evaluate, fit_ridge, full_data_coreset)
from repro_torch.core.api import vrlr_scores
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vrlr import ridge_closed_form

SRC = Path(__file__).resolve().parents[1] / "src"


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


def _data(seed=3, n=2000, d=12, k=8):
    """benchmarks/e2e.py's clustered regression data, small."""
    r = np.random.default_rng(seed)
    centers = 2.0 * r.standard_normal((k, d)).astype(np.float32)
    X = centers[r.integers(0, k, n)] + r.standard_normal((n, d)).astype(np.float32)
    y = X @ r.standard_normal(d).astype(np.float32) + 0.1 * r.standard_normal(n).astype(np.float32)
    return X, y


def _both(seed=3, n=2000, d=12, T=3):
    X, y = _data(seed, n, d)
    jds = JDataset.from_dense(X, y, T=T)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts], np.asarray(jds.y), "cpu")
    return jds, tds


@pytest.mark.parametrize("seed,m", [(3, 128), (4, 300), (5, 64)])
def test_end_to_end_vrlr_matches_reference(seed, m):
    jds, tds = _both(seed)
    n = jds.n
    key = jax.random.PRNGKey(seed + 10)
    jl, tl = JLedger(), CommLedger()
    jcs, jfit, jrep = j_end_to_end(JSpec(task="vrlr", budgets=m, backend="ref"),
                                   jds, key=key, lam=0.1 * n, ledger=jl)
    tcs, tfit, trep = end_to_end(CoresetSpec(task="vrlr", budgets=m), tds,
                                 key=key_from_numpy(np.asarray(key), "cpu"),
                                 lam=0.1 * n, ledger=tl, device="cpu")
    # the scores agree closely, so the draw is the reference's
    js, _ = j_vrlr_scores(key, jds, backend="ref")
    ts, _ = vrlr_scores(key_from_numpy(np.asarray(key), "cpu"), tds, backend="ref")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(jcs.indices), tcs.indices.numpy())
    np.testing.assert_allclose(tcs.weights.numpy(), np.asarray(jcs.weights), rtol=1e-4)
    assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)
    assert tcs.comm_units == CommSchedule.dis_total(3, m)
    assert (tl.total, tl.total_bits, tl.by_tag()) == (jl.total, jl.total_bits, jl.by_tag())
    theta_j = np.asarray(jfit.params)
    np.testing.assert_allclose(tfit.params.numpy(), theta_j, rtol=0,
                               atol=1e-4 * np.abs(theta_j).max())
    assert abs(trep.rel_error - jrep.rel_error) <= 1e-5
    assert np.isfinite(trep.rel_error) and 0 <= trep.rel_error < 0.5
    assert (trep.m, trep.n, trep.comm_units) == (jrep.m, jrep.n, jrep.comm_units)
    assert tcs.health is not None and tcs.health.healthy


def test_fit_ridge_bills_theorem_2_5_and_fits_a_reference_coreset():
    jds, tds = _both(6)
    key = jax.random.PRNGKey(1)
    jcs = j_build_coreset("vrlr", jds, 200, key=key, backend="ref")
    tcs = coreset_from_numpy(np.asarray(jcs.indices), np.asarray(jcs.weights),
                             jcs.comm_units, jcs.comm_bits, "cpu")
    led = CommLedger()
    tfit = fit_ridge(tds, tcs, 50.0, ledger=led)
    assert led.total == 2 * 200 * 3 and led.by_tag()["materialize/rows_up"] == 600
    jfit = j_fit_ridge(jds, jcs, 50.0)
    theta_j = np.asarray(jfit.params)
    np.testing.assert_allclose(tfit.params.numpy(), theta_j, rtol=0,
                               atol=1e-4 * np.abs(theta_j).max())
    assert tfit.objective == pytest.approx(jfit.objective, rel=1e-4)


def test_identity_coreset_reproduces_the_full_solve():
    _, tds = _both(7)
    lam = 0.1 * tds.n
    full = fit_ridge(tds, full_data_coreset(tds), lam)
    theta = ridge_closed_form(tds.full(), tds.y, lam)
    torch.testing.assert_close(full.params, theta, rtol=1e-5, atol=1e-6)
    rep = evaluate(tds, full)
    assert abs(rep.rel_error) <= 1e-5 and rep.comm_units == 0


@pytest.mark.parametrize("backend", ["ref", "norm"])
def test_backends_and_uniform_task_match_reference(backend):
    jds, tds = _both(8)
    key = jax.random.PRNGKey(2)
    tkey = key_from_numpy(np.asarray(key), "cpu")
    for task in ("vrlr", "uniform"):
        jcs = j_build_coreset(task, jds, 97, key=key, backend=backend)
        tcs = build_coreset(task, tds, 97, key=tkey, backend=backend, device="cpu")
        np.testing.assert_array_equal(np.asarray(jcs.indices), tcs.indices.numpy())
        np.testing.assert_allclose(tcs.weights.numpy(), np.asarray(jcs.weights), rtol=1e-4)
        assert (tcs.comm_units, tcs.comm_bits) == (jcs.comm_units, jcs.comm_bits)


def test_plan_validation_and_unported_engines():
    _, tds = _both(9, n=100)
    ep = compile_plan(CoresetSpec(task="vrlr", budgets=10), tds)
    assert (ep.engine, ep.backend, ep.predicted_comm_units) == (
        "materialized", "ref", CommSchedule.dis_total(3, 10))
    # the streaming engines compile: streamed, and pipelined above one block
    # a superchunk (the default chunk_blocks, 8 of the 10 blocks)
    assert compile_plan(CoresetSpec(engine="streamed"), tds).engine == "streamed"
    ep = compile_plan(CoresetSpec(engine="pipelined", block_size=10), tds)
    assert (ep.engine, ep.chunk_blocks, ep.prefetch) == ("pipelined", 8, False)
    # grids compile to the batched engine
    for spec, grid in ((CoresetSpec(budgets=(10, 20)), (1, 2)),
                       (CoresetSpec(budgets=10, num_seeds=2), (2, 1))):
        ep = compile_plan(spec, tds)
        assert (ep.engine, ep.grid, ep.m_cap) == ("batched", grid, max(spec.budgets))
    for bad in (dict(budgets=0), dict(engine="fast"), dict(backend="cuda"),
                dict(num_seeds=0), dict(task=3)):
        with pytest.raises(ValueError):
            CoresetSpec(**bad)
    # the k-means leg runs on any task's coreset, as the reference's does
    _, fit, rep = end_to_end("vrlr", tds, key=rng.PRNGKey(0), k=4, iters=3,
                             device="cpu")
    assert (fit.task, fit.k, rep.task) == ("kmeans", 4, "kmeans")
    with pytest.raises(ValueError):
        end_to_end("vrlr", tds, key=rng.PRNGKey(0), device="cpu")
    no_labels = VFLDataset(list(tds.parts))
    with pytest.raises(ValueError, match="labels"):
        compile_plan(CoresetSpec(task="vrlr", budgets=10), no_labels)


def test_dataset_ingest_screen_and_device_checks():
    X, y = _data(10, n=50, d=6)
    X[3, 4] = np.nan
    with pytest.raises(ValueError, match=r"\(NaN\) in party 2 at row 3, column 0"):
        VFLDataset.from_dense(X, y, T=3, device="cpu")
    ds = VFLDataset([torch.from_numpy(X)], torch.from_numpy(y), validate=False)
    assert (ds.n, ds.d, ds.T) == (50, 6, 1)
    with pytest.raises(ValueError):
        VFLDataset([torch.zeros(5, 2), torch.zeros(4, 2)])


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    """The card is the default: asked for "cuda" with no CUDA device, the
    entry points raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(11, n=60, d=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VFLDataset.from_dense(X, y, T=3)
    cpu_ds = VFLDataset.from_dense(X, y, T=3, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoresetPipeline(cpu_ds).build(CoresetSpec(budgets=8), key=rng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        end_to_end("vrlr", cpu_ds, key=rng.PRNGKey(0), lam=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert, repro_torch.rng\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.core.vkmc, repro_torch.kernels.kmeans_assign\n"
        "import repro_torch.kernels.kmeans_assign_update\n"
        "import repro_torch.core.faults, repro_torch.core.integrity, torch.distributed\n"
        "import repro_torch.serve, repro_torch.serve.tree\n"
        "import repro_torch.serve.resilience, repro_torch.serve.service\n"
        "import repro_torch.data, repro_torch.data.synthetic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(SRC),
                         "PATH": "/usr/bin:/bin"}, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a CUDA device (and alone in a directory) the chip check exits
    non-zero and prints no result line."""
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for cwd, target in ((script.parent, script), (tmp_path, tmp_path / "chip_smoke.py")):
        if target != script:
            target.write_text(script.read_text())
        env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
        out = subprocess.run([sys.executable, str(target)], cwd=cwd, env=env,
                             capture_output=True, text=True)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
