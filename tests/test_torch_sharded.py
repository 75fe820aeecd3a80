"""Sharded block masses over ``torch.distributed``: the port's
``vrlr_block_masses_sharded`` / ``vkmc_block_masses_sharded``, the
scorers' ``masses=`` branches and the ``sharded_masses`` spec toggle,
against the reference on the CPU from the same numpy data and keys.

Tolerances:

- The tables against the reference's (``make_debug_mesh(1, 1)``), against
  the unsharded scorer's and, in a world of two, against the world-of-one
  table: ``rtol=1e-4, atol=1e-6`` (the reference's own tolerance for
  the sharded table against the block scan).
- Within a world: both ranks' tables bit for bit, two all-reduces each.
- ``sharded_masses`` builds against the reference's: indices and bill
  exact, weights ``rtol=1e-4``.

The world of two runs as two processes on the gloo backend, meeting in a
``FileStore`` under the test's own directory; each process has a time
limit of its own, past which it is killed and the test fails.  The NCCL
world of one on the card is ``chip_smoke.py`` phase 11's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import CoresetPipeline as JPipeline
from repro.core import CoresetSpec as JSpec
from repro.core import VFLDataset as JDataset
from repro.core.streaming import vkmc_block_masses_sharded as j_vkmc_sharded
from repro.core.streaming import vrlr_block_masses_sharded as j_vrlr_sharded
from repro.launch.mesh import make_debug_mesh
from repro_torch.convert import dataset_from_numpy, key_from_numpy
from repro_torch.core import (
    CommLedger, CoresetPipeline, CoresetSpec, make_stream_scorer,
    vkmc_block_masses_sharded, vrlr_block_masses_sharded)

SRC = Path(__file__).resolve().parents[1] / "src"
N, BLOCK, K = 800, 100, 4
RTOL, ATOL = 1e-4, 1e-6
RANK_TIMEOUT_S = 120


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


def _data(seed=19, n=N, d=12):
    r = np.random.default_rng(seed)
    X = r.standard_normal((n, d)).astype(np.float32)
    y = (X @ r.standard_normal(d) + 0.1 * r.standard_normal(n)).astype(np.float32)
    return X, y


def _both(seed=19, n=N, labels=True):
    X, y = _data(seed, n)
    jds = JDataset.from_dense(X, y if labels else None, T=3)
    tds = dataset_from_numpy([np.asarray(p) for p in jds.parts],
                             y if labels else None, "cpu")
    return jds, tds


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, key_from_numpy(np.asarray(kj), "cpu")


class _CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls while installed."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = dist.all_reduce

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(dist, "all_reduce", counted)


# --------------------------------------------------------------------------
# a world of one
# --------------------------------------------------------------------------

def test_vrlr_table_world_of_one_matches_reference_and_scorer(monkeypatch):
    jds, tds = _both()
    count = _CountAllReduce(monkeypatch)
    got = vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
    assert count.calls == 0                 # no group: no collective
    want = np.asarray(j_vrlr_sharded(make_debug_mesh(1, 1), jds, BLOCK))
    assert got.shape == (3, N // BLOCK) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    _, kt = _keys(0)
    scorer = make_stream_scorer("vrlr", kt, tds, BLOCK, "ref", device="cpu")
    np.testing.assert_allclose(got.numpy(), scorer.masses.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_vkmc_table_world_of_one_matches_reference_and_scorer(backend):
    jds, tds = _both(seed=14, labels=False)
    kj, kt = _keys(15)
    got = vkmc_block_masses_sharded(tds, BLOCK, key=kt, k=K, backend=backend,
                                    device="cpu")
    want = np.asarray(j_vkmc_sharded(make_debug_mesh(1, 1), jds, BLOCK, key=kj, k=K,
                                     use_kernel=backend == "pallas"))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    scorer = make_stream_scorer("vkmc", kt, tds, BLOCK, backend, device="cpu", k=K)
    np.testing.assert_allclose(got.numpy(), scorer.masses.numpy(), rtol=RTOL, atol=ATOL)


def test_world_of_one_group_equals_no_group_bit_for_bit(monkeypatch):
    """A gloo world of one runs the two all-reduces and gives the groupless
    table's bits."""
    _, tds = _both()
    _, tvk = _both(seed=14, labels=False)
    _, kt = _keys(15)
    plain_v = vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
    plain_k = vkmc_block_masses_sharded(tvk, BLOCK, key=kt, k=K, backend="ref",
                                        device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        count = _CountAllReduce(monkeypatch)
        v = vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
        assert count.calls == 2
        k = vkmc_block_masses_sharded(tvk, BLOCK, key=kt, k=K, backend="ref",
                                      device="cpu")
        assert count.calls == 4
    finally:
        dist.destroy_process_group()
    assert torch.equal(v, plain_v) and torch.equal(k, plain_k)


def test_group_backend_that_cannot_take_the_tensors_raises(monkeypatch):
    """NCCL takes CUDA tensors only: a table on the CPU under an NCCL
    group raises before any work, and nothing is copied across."""
    _, tds = _both()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="cannot reduce tensors on cpu"):
            vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "cuda:nccl")
        with pytest.raises(ValueError, match="cannot reduce tensors on cpu"):
            vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


@pytest.mark.parametrize("fn", ["vrlr", "vkmc"])
def test_misaligned_grid_raises(fn):
    _, tds = _both(n=101, labels=fn == "vrlr")
    with pytest.raises(ValueError, match="must shard evenly"):
        if fn == "vrlr":
            vrlr_block_masses_sharded(tds, BLOCK, device="cpu")
        else:
            vkmc_block_masses_sharded(tds, BLOCK, key=_keys(0)[1], k=K,
                                      backend="ref", device="cpu")


# --------------------------------------------------------------------------
# a world of two on gloo
# --------------------------------------------------------------------------

_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import dataset_from_numpy
from repro_torch.core import (CoresetPipeline, CoresetSpec,
                              vkmc_block_masses_sharded, vrlr_block_masses_sharded)

rank, world, store_path, data_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
d = np.load(data_path)
ds = dataset_from_numpy([d["p0"], d["p1"], d["p2"]], d["y"], "cpu")
dsk = dataset_from_numpy([d["p0"], d["p1"], d["p2"]], None, "cpu")
key = torch.as_tensor(d["key"].astype(np.int64))
calls = [0]
real = dist.all_reduce
def counted(*a, **kw):
    calls[0] += 1
    return real(*a, **kw)
dist.all_reduce = counted
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
v = vrlr_block_masses_sharded(ds, int(d["block"]), device="cpu")
v_calls = calls[0]
k = vkmc_block_masses_sharded(dsk, int(d["block"]), key=key, k=int(d["k"]),
                              backend="ref", device="cpu")
k_calls = calls[0] - v_calls
# the plan-time grid check at n = 900, block 100, D = 2 (450 rows a shard)
odd = dataset_from_numpy([d["p0"][:900], d["p1"][:900], d["p2"][:900]],
                         d["y"][:900], "cpu")
try:
    CoresetPipeline(odd).plan(CoresetSpec(task="vrlr", budgets=10, engine="streamed",
                                          block_size=100, sharded_masses=True))
    grid = "planned"
except ValueError as e:
    grid = str(e)
dist.destroy_process_group()
np.savez(out_path, vrlr=v.numpy(), vkmc=k.numpy())
print(json.dumps({"vrlr_calls": v_calls, "vkmc_calls": k_calls, "grid": grid}))
'''


def test_world_of_two_on_gloo(tmp_path):
    """Two ranks, 500 rows each: both tables bit for bit equal across the
    ranks, two all-reduces per table, within tolerance of the world-of-one
    table and the unsharded scorer's; the planner refuses n = 900 at block
    100 over two ranks."""
    X, y = _data(seed=19, n=1000)
    _, tds = _both(seed=19, n=1000)
    parts = [p.numpy() for p in tds.parts]
    _, kt = _keys(15)
    data = tmp_path / "data.npz"
    np.savez(data, p0=parts[0], p1=parts[1], p2=parts[2], y=y, key=kt.numpy(),
             block=BLOCK, k=K)
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = {**os.environ, "PYTHONPATH": str(SRC)}     # keeps HOME and TMPDIR
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"), str(data),
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err
            reports.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for rep in reports:
        assert rep["vrlr_calls"] == 2 and rep["vkmc_calls"] == 2
        assert "sharded_masses needs n divisible by the device count" in rep["grid"]
        assert "devices=2, bs=100" in rep["grid"]
    tdk = dataset_from_numpy(parts, None, "cpu")
    one = {"vrlr": vrlr_block_masses_sharded(tds, BLOCK, device="cpu").numpy(),
           "vkmc": vkmc_block_masses_sharded(tdk, BLOCK, key=kt, k=K, backend="ref",
                                             device="cpu").numpy()}
    scorer = {"vrlr": make_stream_scorer("vrlr", kt, tds, BLOCK, "ref", device="cpu"),
              "vkmc": make_stream_scorer("vkmc", kt, tdk, BLOCK, "ref", device="cpu", k=K)}
    for task in ("vrlr", "vkmc"):
        a, b = outs[0][task], outs[1][task]
        assert a.shape == (3, 10)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, one[task], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, scorer[task].masses.numpy(), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the scorers' masses= branches and the sharded_masses builds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task,backend,passes", [
    ("vrlr", "ref", 1), ("vrlr", "pallas", 1), ("vrlr", "norm", 0),
    ("vkmc", "ref", 2), ("vkmc", "norm", 0)])
@pytest.mark.parametrize("chunk_blocks,prefetch", [(1, False), (3, True)])
def test_supplied_masses_skip_the_mass_pass(task, backend, passes, chunk_blocks, prefetch):
    """A supplied table is the scorer's table; the passes that still run
    are counted, and the per-row scores are the scorer's own."""
    _, tds = _both(labels=task == "vrlr")
    _, kt = _keys(3)
    params = {"k": K} if task == "vkmc" else {}
    kw = dict(device="cpu", chunk_blocks=chunk_blocks, prefetch=prefetch, **params)
    own = make_stream_scorer(task, kt, tds, BLOCK, backend, **kw)
    table = torch.rand(3, N // BLOCK, generator=torch.Generator().manual_seed(1))
    given = make_stream_scorer(task, kt, tds, BLOCK, backend, masses=table, **kw)
    assert own.data_passes == passes + 1 and given.data_passes == passes
    assert torch.equal(given.masses, table)
    assert torch.equal(given.dis_key, own.dis_key)
    for b in (0, 7):
        assert torch.equal(given.score_block(b), own.score_block(b))
    with pytest.raises(ValueError, match="supplied mass table has shape"):
        make_stream_scorer(task, kt, tds, BLOCK, backend, masses=table[:, :3], **kw)


@pytest.mark.parametrize("engine", ["streamed", "pipelined"])
@pytest.mark.parametrize("task", ["vrlr", "vkmc"])
def test_sharded_masses_builds_match_reference(engine, task):
    labels = task == "vrlr"
    jds, tds = _both(labels=labels)
    kj, kt = _keys(27)
    params = {"k": K} if task == "vkmc" else {}
    kw = dict(task=task, budgets=40, engine=engine, backend="ref", block_size=BLOCK,
              sharded_masses=True, params=params)
    if engine == "pipelined":
        kw.update(chunk_blocks=3, prefetch=False)
    spec = CoresetSpec(**kw)
    pipe = CoresetPipeline(tds)
    plan = pipe.plan(spec)
    assert "+sharded_masses" in plan.describe()
    led = CommLedger()
    cs = pipe.build(spec, key=kt, ledger=led, device="cpu")
    ref = JPipeline(jds).build(JSpec(**kw), key=kj)
    np.testing.assert_array_equal(cs.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(cs.weights.numpy(), np.asarray(ref.weights), rtol=1e-4)
    assert (cs.comm_units, cs.comm_bits) == (ref.comm_units, ref.comm_bits)
    assert cs.comm_units == led.total == plan.predicted_comm_units


def test_sharded_masses_refusals_match_reference():
    jds, tds = _both()
    cases = [
        dict(engine="materialized"),               # the spec refuses
        dict(engine="batched"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as te:
            CoresetSpec(task="vrlr", budgets=10, block_size=BLOCK, sharded_masses=True, **kw)
        with pytest.raises(ValueError) as je:
            JSpec(task="vrlr", budgets=10, block_size=BLOCK, sharded_masses=True, **kw)
        assert str(te.value) == str(je.value)
    planned = [
        (dict(), tds, jds),                        # auto -> materialized
        (dict(engine="streamed", backend="norm"), tds, jds),
        (dict(engine="streamed", task="uniform"), tds, jds),
    ]
    jodd, todd = _both(n=801)
    planned.append((dict(engine="streamed"), todd, jodd))
    for kw, t, j in planned:
        spec_kw = dict(task="vrlr", budgets=10, block_size=BLOCK, sharded_masses=True)
        spec_kw.update(kw)
        with pytest.raises(ValueError) as te:
            CoresetPipeline(t).plan(CoresetSpec(**spec_kw))
        with pytest.raises(ValueError) as je:
            JPipeline(j).plan(JSpec(**spec_kw))
        assert str(te.value) == str(je.value), kw
        assert "sharded_masses" in str(te.value)
    with pytest.raises(ValueError, match="sharded_masses must be a bool"):
        CoresetSpec(sharded_masses=1)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_sharded_vkmc_build_solves_its_centers_once(monkeypatch, backend):
    """A sharded ``vkmc`` build solves the party-local centers once, for the
    table and the scorer, to the bits of a build whose table and scorer each
    solve them on the same key; a quarantine rebuild solves them again on
    the survivors, whose draw is a build on ``select_parties``."""
    from repro_torch.core import FaultPlan, Transport
    from repro_torch.core import api as tapi
    from repro_torch.core import streaming as tst

    _, tds = _both(labels=False)
    _, kt = _keys(31)
    spec = CoresetSpec(task="vkmc", budgets=40, engine="pipelined", backend=backend,
                       block_size=BLOCK, chunk_blocks=3, prefetch=False,
                       sharded_masses=True, params={"k": K})
    # the old path: the table and the scorer solve the centers each
    table = vkmc_block_masses_sharded(tds, BLOCK, key=kt, k=K, backend=backend,
                                      device="cpu")
    scorer = make_stream_scorer("vkmc", kt, tds, BLOCK, backend, device="cpu", k=K,
                                chunk_blocks=3, masses=table)
    calls = []
    real = tst.vkmc_local_centers

    def counted(*a, **kw):
        calls.append(a[1].T)
        return real(*a, **kw)

    monkeypatch.setattr(tapi, "vkmc_local_centers", counted)
    monkeypatch.setattr(tst, "vkmc_local_centers", counted)
    cs = CoresetPipeline(tds).build(spec, key=kt, device="cpu")
    assert calls == [3]
    want = tst.dis_plan_streamed_batched(scorer, 40)
    assert torch.equal(cs.indices, want.indices) and torch.equal(cs.weights, want.weights)

    calls.clear()
    tr = Transport(FaultPlan(seed=11, silent_corrupt={0: 1.0}, silent_kind="sign"),
                   verify=False)
    got = CoresetPipeline(tds).build(spec.replace(fault_policy="quarantine"), key=kt,
                                     device="cpu", transport=tr)
    assert calls == [3, 2] and got.degraded.surviving == (1, 2)
    sub = CoresetPipeline(tds.select_parties([1, 2])).build(spec, key=kt, device="cpu")
    assert torch.equal(got.indices, sub.indices) and torch.equal(got.weights, sub.weights)
