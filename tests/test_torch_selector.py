"""The port's coreset batch selector (``repro_torch.core.selector``) and its
score and draw primitives (``ridge_leverage_scores``, ``norm_scores``,
``server_plan``) against the reference on the CPU, from the same numpy
features and keys.

The features are the reference trainer's score input: the float32 mean
over S of token embeddings (a 512 x 256 table of fan-in scale, a
``TokenStream`` batch), d = 256.

Tolerances:

- Ridge leverage where B < d: the Gram has rank B, the scores lie near 1
  and the inverse's float32 rounding shows (4.8e-5 measured at B = 64,
  ``torch.linalg.inv`` against ``jnp.linalg.inv``): ``atol=2e-4``.  Where
  B >= 4d: ``rtol=1e-5, atol=5e-6`` (2.1e-6 measured).
- The draw fed the reference's ``g``: indices exact, weights ``rtol=1e-6``
  (G is a float32 sum over B in another order).  ``uniform`` is exact.
  ``select(mode="coreset")`` at B >= 4d, on the port's own scores: indices
  exact.
- The group selector on a gloo world of two, each rank holding half the
  columns: the reduced ``g`` is the sum of the halves' port scores bit for
  bit, both ranks draw the same indices, which are the groupless draw on
  that ``g``.  The ranks are subprocesses meeting in a ``FileStore`` under
  the test's directory, each killed past 120 s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import dis as jdis
from repro.core import selector as jsel
from repro.core import sensitivity as jsens
from repro.data.lm import TokenStream as JStream
from repro_torch.convert import key_from_numpy
from repro_torch.core import norm_scores, ridge_leverage_scores, server_plan
from repro_torch.core import selector as tsel
from repro_torch.kernels import ops as kops

SRC = Path(__file__).resolve().parents[1] / "src"
D = 256
RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False):
        yield


def _feats(B, seed=0, S=16):
    """(B, D) float32 mean-pooled embeddings of a TokenStream batch."""
    rs = np.random.default_rng(seed)
    table = (np.clip(rs.standard_normal((512, D)), -3, 3) / np.sqrt(D)).astype(np.float32)
    toks = np.asarray(next(iter(JStream(vocab=512, seq_len=S, batch_size=B,
                                        seed=seed + B)))["tokens"])
    return table[toks].mean(axis=1).astype(np.float32)


def _keys(seed):
    k = jax.random.PRNGKey(seed)
    return k, key_from_numpy(np.asarray(k), "cpu")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("B", [8, 64, 1024])
def test_ridge_leverage_scores_match_reference(B, use_kernel):
    X = _feats(B)
    want = np.asarray(jsens.ridge_leverage_scores(jnp.asarray(X), 1e-4))
    got = ridge_leverage_scores(torch.from_numpy(X), 1e-4, use_kernel=use_kernel)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    if B < D:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-6)


def test_ridge_leverage_kernel_flag_on_the_cpu_is_the_plain_path():
    """On a CPU tensor ``use_kernel=True`` takes the plain quadratic form:
    the same bits, and no launch counted."""
    X = torch.from_numpy(_feats(300, seed=3))
    before = kops._leverage.launches
    a = ridge_leverage_scores(X, 1e-4, use_kernel=True)
    b = ridge_leverage_scores(X, 1e-4, use_kernel=False)
    assert torch.equal(a, b) and kops._leverage.launches == before


def test_norm_scores_match_reference():
    X = _feats(64, seed=5)
    np.testing.assert_allclose(norm_scores(torch.from_numpy(X)).numpy(),
                               np.asarray(jsens.norm_scores(jnp.asarray(X))),
                               rtol=1e-6, atol=0)
    Xb = X.astype(np.float16)
    assert norm_scores(torch.from_numpy(Xb)).dtype == torch.float32


@pytest.mark.parametrize("score", ["leverage", "norm"])
@pytest.mark.parametrize("B", [64, 1024])
def test_local_scores_match_reference(B, score):
    X = _feats(B, seed=7)
    want = np.asarray(jsel.local_scores(jnp.asarray(X), score, 1e-4))
    got = tsel.local_scores(torch.from_numpy(X), score, 1e-4).numpy()
    atol = 2e-4 if (score == "leverage" and B < D) else 5e-6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("B,m,seed", [(64, 16, 0), (1024, 256, 1), (8, 1, 2), (333, 97, 3)])
def test_server_plan_and_sample_coreset_on_the_reference_g(B, m, seed):
    g = np.asarray(jsel.local_scores(jnp.asarray(_feats(B, seed=seed)), "leverage", 1e-4))
    kj, kt = _keys(100 + seed)
    Sj, wj = jdis.server_plan(kj, jnp.asarray(g), m)
    for fn in (server_plan, tsel.sample_coreset):
        S, w = fn(kt, torch.from_numpy(g.copy()), m)
        assert S.dtype == torch.int64 and w.dtype == torch.float32
        np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-6, atol=0)
        gt = torch.from_numpy(g.copy())
        assert torch.equal(w, gt.sum() / (m * torch.clamp_min(gt[S], 1e-30)))


def test_server_plan_clamps_zero_scores():
    """A zero score is never drawn (log 1e-30) and weights stay finite."""
    g = np.zeros(50, np.float32)
    g[[3, 17, 40]] = [1.0, 2.0, 0.5]
    kj, kt = _keys(9)
    Sj, wj = jdis.server_plan(kj, jnp.asarray(g), 20)
    S, w = server_plan(kt, torch.from_numpy(g), 20)
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    assert set(S.tolist()) <= {3, 17, 40} and bool(torch.isfinite(w).all())
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,fraction", [(64, 0.25), (1024, 0.1), (7, 0.01)])
def test_select_uniform_exact(B, fraction):
    X = _feats(B, seed=11)
    kj, kt = _keys(B)
    cfg_j = jsel.SelectorConfig(mode="uniform", fraction=fraction)
    cfg_t = tsel.SelectorConfig(mode="uniform", fraction=fraction)
    Sj, wj = jsel.select(kj, jnp.asarray(X), cfg_j)
    S, w = tsel.select(kt, torch.from_numpy(X), cfg_t)
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))


@pytest.mark.parametrize("score", ["leverage", "norm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_coreset_indices_exact_at_four_d(seed, score):
    """At B = 4d the port's scores are within 2e-6 of the reference's and
    the draw on them is the reference's."""
    X = _feats(4 * D, seed=seed)
    kj, kt = _keys(50 + seed)
    cfg_j = jsel.SelectorConfig(mode="coreset", fraction=0.25, score=score)
    cfg_t = tsel.SelectorConfig(mode="coreset", fraction=0.25, score=score)
    Sj, wj = jsel.select(kj, jnp.asarray(X), cfg_j)
    S, w = tsel.select(kt, torch.from_numpy(X), cfg_t)
    assert S.shape == (256,)
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-5, atol=0)


@pytest.mark.parametrize("fraction,B", [(0.25, 256), (0.25, 3), (0.001, 100), (0.5, 5),
                                        (1.0, 9), (0.125, 4)])
def test_m_of_matches_reference(fraction, B):
    assert (tsel.SelectorConfig(fraction=fraction).m_of(B)
            == jsel.SelectorConfig(fraction=fraction).m_of(B))


def test_config_defaults_match_reference():
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(tsel.SelectorConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jsel.SelectorConfig)])


def test_select_mode_none_raises_the_reference_error():
    X = torch.from_numpy(_feats(16))
    _, kt = _keys(0)
    with pytest.raises(ValueError, match=r"select\(\) called with mode='none'"):
        tsel.select(kt, X, tsel.SelectorConfig(mode="none"))
    with pytest.raises(ValueError, match=r"select\(\) called with mode='none'"):
        jsel.select(jax.random.PRNGKey(0), jnp.asarray(X.numpy()),
                    jsel.SelectorConfig(mode="none"))


def test_weighted_token_loss_matches_reference():
    rs = np.random.default_rng(4)
    loss = rs.random(32).astype(np.float32) * 5
    w = rs.random(32).astype(np.float32) * 3
    want = np.asarray(jsel.weighted_token_loss(jnp.asarray(loss), jnp.asarray(w)))
    got = tsel.weighted_token_loss(torch.from_numpy(loss), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    zero = tsel.weighted_token_loss(torch.from_numpy(loss), torch.zeros(32))
    assert float(zero) == 0.0


def test_group_selector_outside_a_group_is_select():
    """No process group: the group selector is the groupless select."""
    assert not dist.is_initialized()
    X = torch.from_numpy(_feats(200, seed=2))
    _, kt = _keys(3)
    cfg = tsel.SelectorConfig()
    a = tsel.make_mesh_selector(cfg)(kt, X)
    b = tsel.select(kt, X, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_group_selector_world_of_one_on_gloo(monkeypatch):
    """A gloo world of one runs one all-reduce and gives the groupless
    selection's bits."""
    X = torch.from_numpy(_feats(300, seed=6))
    _, kt = _keys(8)
    cfg = tsel.SelectorConfig()
    want = tsel.select(kt, X, cfg)
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = tsel.make_mesh_selector(cfg)(kt, X)
    finally:
        dist.destroy_process_group()
    assert len(calls) == 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import selector as tsel

rank, world, store_path, data_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
d = np.load(data_path)
X = torch.from_numpy(d["X"])
cols = X.shape[1] // world
local = X[:, rank * cols:(rank + 1) * cols].contiguous()
key = torch.as_tensor(d["key"].astype(np.int64))
cfg = tsel.SelectorConfig(mode="coreset", fraction=0.25)
seen = {}
real = dist.all_reduce
def counted(t, *a, **kw):
    out = real(t, *a, **kw)
    seen["g"] = t.clone()
    return out
dist.all_reduce = counted
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
S, w = tsel.make_mesh_selector(cfg)(key, local)
dist.destroy_process_group()
np.savez(out_path, S=S.numpy(), w=w.numpy(), g=seen["g"].numpy())
print(json.dumps({"rank": rank, "m": int(S.shape[0])}))
'''


def test_group_selector_world_of_two_on_gloo(tmp_path):
    """Two ranks, 128 columns each: the reduced g is the sum of the halves'
    port scores bit for bit; both ranks draw the same indices and weights,
    the groupless draw on that g."""
    X = _feats(512, seed=12)
    _, kt = _keys(77)
    data = tmp_path / "data.npz"
    np.savez(data, X=X, key=kt.numpy())
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = {**os.environ, "PYTHONPATH": str(SRC)}     # keeps HOME and TMPDIR
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"), str(data),
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err
            assert json.loads(out.strip().splitlines()[-1])["m"] == 128
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    Xt = torch.from_numpy(X)
    halves = [tsel.local_scores(Xt[:, r * 128:(r + 1) * 128].contiguous(), "leverage", 1e-4)
              for r in range(2)]
    g = halves[0] + halves[1]
    for o in outs:
        assert np.array_equal(o["g"], g.numpy())
    assert np.array_equal(outs[0]["S"], outs[1]["S"])
    assert np.array_equal(outs[0]["w"], outs[1]["w"])
    S, w = tsel.sample_coreset(kt, g, 128)
    assert np.array_equal(outs[0]["S"], S.numpy()) and np.array_equal(outs[0]["w"], w.numpy())


def test_group_selector_refuses_nccl_with_cpu_features(monkeypatch):
    """The group's backend must take the features' device: NCCL with CPU
    features raises, nothing is copied across."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    X = torch.from_numpy(_feats(16))
    _, kt = _keys(0)
    with pytest.raises(ValueError, match="cannot reduce tensors on cpu"):
        tsel.make_mesh_selector(tsel.SelectorConfig())(kt, X)


def test_cuda_entry_raises_without_a_card(monkeypatch):
    from repro_torch.data import TokenStream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(vocab=16, seq_len=4, batch_size=2)
