"""The port's train step (``repro_torch.train.trainer``) against the
reference's ``make_train_step`` on the CPU, on reduced ``llama3.2-1b``
(float32), both started from one state (``convert.train_state_from_numpy``
of the reference's ``train_state_init``) and fed the same
``TokenStream`` batches and keys.

Tolerances (float32; what this file measured in brackets):

- loss and ``ce`` ``rtol=1e-5`` (1.4e-7); gradients per leaf within
  ``1e-4`` of the leaf's largest |g| (2.0e-6); the AdamW moments within
  ``1e-4`` of the leaf's largest after one step (1.4e-6), ``1e-3`` after
  three (4.3e-4: the parameters the second step starts from differ).
- The selected rows exactly: ``uniform`` draws the reference's indices,
  ``coreset`` is fed the reference's scores through the trainer's
  ``local_scores`` (``torch.linalg.inv`` and ``jnp.linalg.inv`` differ by
  up to 1e-4 on these features) and draws its indices and weights.
- Parameters after n steps: AdamW moves an element by about lr a step
  whatever its gradient's size, so an element whose gradient is near zero
  may move differently in the two packages.  Every element lies within
  ``2 * lr * n + 1e-5`` of the reference's, and at most 0.5% of a leaf's
  elements lie beyond ``1e-5`` (after one step at most 25 of 262,144, 9.7e-4
  at worst; after three steps 0.15% of a leaf).
- ``remat`` on and off: the loss and gradients equal bit for bit (the
  recomputed layer runs the same CPU ops on the same inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import dis as jdis
from repro.core import selector as jsel
from repro.data.lm import TokenStream as JStream
from repro.models import api as japi
from repro.optim import schedules as jsched
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import key_from_numpy, train_state_from_numpy, train_state_to_numpy
from repro_torch.core.selector import SelectorConfig, local_scores, sample_coreset
from repro_torch.data import TokenStream
from repro_torch.models import api
from repro_torch.optim.schedules import constant, cosine_with_warmup
from repro_torch.train import make_eval_step, make_train_step, train_state_init
from repro_torch.train import trainer

CPU = "cpu"
ARCH = "llama3.2-1b"
LR = 1e-3
B, S = 8, 24
FRACTION = 0.5


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


_JSTEPS = {}


def _jstep(jc, mode):
    """The reference's jitted step at constant(LR), one per (config, mode)."""
    tag = (jc, mode)
    if tag not in _JSTEPS:
        _JSTEPS[tag] = jax.jit(jtrainer.make_train_step(
            jc, jsched.constant(LR), jsel.SelectorConfig(mode=mode, fraction=FRACTION)))
    return _JSTEPS[tag]


def _tstep(tc, mode, sched=None):
    sel = None if mode == "none" else SelectorConfig(mode=mode, fraction=FRACTION)
    return make_train_step(tc, sched or constant(LR), sel)


_STATES = {}


def _pair(**replace):
    """(jax cfg, torch cfg, the reference's state, a fresh port copy of it);
    the reference's state (PRNGKey(0)) is made once per config."""
    tag = tuple(sorted(replace.items()))
    if tag not in _STATES:
        jc = dataclasses.replace(j_get_arch(ARCH).reduced(), **replace)
        js = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(0))
        _STATES[tag] = (jc, js, jax.tree_util.tree_map(np.asarray, js))
    jc, js, tree = _STATES[tag]
    tc = dataclasses.replace(get_arch(ARCH).reduced(), **replace)
    return jc, tc, js, train_state_from_numpy(tree, tc, CPU)


def _batches(jc, n, seed=0):
    it = iter(JStream(vocab=jc.vocab_size, seq_len=S, batch_size=B, seed=seed))
    out = []
    for _ in range(n):
        jb = next(it)
        out.append((jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}))
    return out


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_numpy(model):
    from repro_torch.convert import _stacked

    return _stacked((n, p.grad.numpy()) for n, p in model.named_parameters())


_JGRADS = {}


def _reference_grads(jc, js, jb, mode, key, g=None):
    """(grads, indices) of the reference step's loss on its own selection."""
    weights, batch, idx = None, jb, None
    if mode == "uniform":
        idx, weights = jdis.uniform_plan(key, B, round(FRACTION * B))
    elif mode == "coreset":
        idx, weights = jsel.sample_coreset(key, g, round(FRACTION * B))
    if idx is not None:
        batch = jtrainer._select_rows(jb, idx)
    if jc not in _JGRADS:
        _JGRADS[jc] = jax.jit(lambda p, b, w: jax.grad(
            lambda q: japi.loss_fn(q, jc, b, example_weights=w)[0])(p))
    return _JGRADS[jc](js["params"], batch, weights), idx


class _Spy:
    """Feeds the trainer the reference's scores and records its rows."""

    def __init__(self, monkeypatch, g=None):
        self.g, self.idx, self.feats = g, [], []
        real_select = trainer._select_rows

        def select_rows(batch, idx):
            self.idx.append(idx)
            return real_select(batch, idx)

        def scores(feats, score, ridge):
            self.feats.append(feats)
            return torch.from_numpy(np.array(self.g)) if self.g is not None else \
                local_scores(feats, score, ridge)

        monkeypatch.setattr(trainer, "_select_rows", select_rows)
        monkeypatch.setattr(trainer, "local_scores", scores)


def _assert_grads_close(tgrads, jgrads):
    tg, jg = _flat(tgrads), _flat(jgrads)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-4 * np.abs(jg[k]).max(),
                                   err_msg=k)


def _assert_params_close(tstate, jstate, steps):
    mom_tol = 1e-4 if steps == 1 else 1e-3
    tp, jp = _flat(train_state_to_numpy(tstate)["params"]), _flat(jstate["params"])
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2 * LR * steps + 1e-5, (k, d.max())
        assert (d > 1e-5).mean() <= 0.005, (k, (d > 1e-5).mean())
    for part in ("m", "v"):
        tm = _flat(train_state_to_numpy(tstate)["opt"][part])
        jm = _flat(jstate["opt"][part])
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=0,
                                       atol=mom_tol * np.abs(jm[k]).max(), err_msg=f"{part} {k}")


# --------------------------------------------------------------------------
# one step per mode against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "uniform", "coreset"])
def test_train_step_matches_reference(mode, monkeypatch):
    jc, tc, js, ts = _pair()
    (jb, tb), = _batches(jc, 1)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    g = None
    if mode == "coreset":
        g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
    jgrads, jidx = _reference_grads(jc, js, jb, mode, key, g)
    js2, jm = _jstep(jc, mode)(js, jb, key)
    spy = _Spy(monkeypatch, g)
    ts2, tm = _tstep(tc, mode)(ts, tb, key_from_numpy(np.asarray(key), CPU))
    assert ts2 is ts and int(ts["step"]) == 1 and int(ts["opt"]["step"]) == 1
    assert all(v.shape == () and v.dtype == torch.float32 for v in tm.values())
    for name in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0 and float(tm["lr"]) == float(jm["lr"])
    if mode == "none":
        assert spy.idx == []
    else:
        assert len(spy.idx) == 1 and spy.idx[0].tolist() == np.asarray(jidx).tolist()
    if mode == "coreset":
        feats = spy.feats[0]
        assert not feats.requires_grad
        np.testing.assert_allclose(
            feats.numpy(), np.asarray(jtrainer._score_features(js["params"], jc, jb)),
            rtol=0, atol=1e-6)
    _assert_grads_close(_grads_numpy(ts["params"]), jgrads)
    _assert_params_close(ts, js2, 1)


def test_coreset_step_embedding_gradient_equals_reference(monkeypatch):
    """The selection is not differentiated: the importance weights are
    constants of the loss, as the reference's ``value_and_grad`` closes over
    them.  Scoring with grad on would add a term through the features."""
    jc, tc, js, ts = _pair()
    (jb, tb), = _batches(jc, 1, seed=1)
    key = jax.random.PRNGKey(11)
    g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
    jgrads, jidx = _reference_grads(jc, js, jb, "coreset", key, g)
    want = np.asarray(jgrads["embed"])
    tol = 1e-4 * np.abs(want).max()

    # with the scoring under grad, the weights carry a graph into the table
    model = ts["params"]
    feats = trainer._score_features(model, tc, tb)
    weights = local_scores(feats, "leverage", 1e-4)
    idx, w = sample_coreset(key_from_numpy(np.asarray(key), CPU), weights, B // 2)
    assert w.requires_grad
    model.zero_grad()
    api.loss_fn(model, tc, trainer._select_rows(tb, idx), example_weights=w)[0].backward()
    assert np.abs(model.embed.grad.numpy() - want).max() > 10 * tol

    _Spy(monkeypatch, g)
    _tstep(tc, "coreset")(ts, tb, key_from_numpy(np.asarray(key), CPU))
    np.testing.assert_allclose(model.embed.grad.numpy(), want, rtol=0, atol=tol)


def test_coreset_step_on_its_own_scores(monkeypatch):
    """Without the seam: the port's own scores are the reference's within
    2e-4, and the step's loss is the reference loss on the rows it drew."""
    jc, tc, js, ts = _pair()
    (jb, tb), = _batches(jc, 1, seed=2)
    spy = _Spy(monkeypatch)
    _, tm = _tstep(tc, "coreset")(ts, tb, key_from_numpy(np.asarray(jax.random.PRNGKey(3)), CPU))
    jfeats = jtrainer._score_features(js["params"], jc, jb)
    jg = np.asarray(jsel.local_scores(jfeats, "leverage", 1e-4))
    tg = local_scores(spy.feats[0], "leverage", 1e-4).numpy()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=2e-4)
    idx = spy.idx[0].numpy()
    w = tg.sum() / (len(idx) * tg[idx])
    ref, _ = japi.loss_fn(js["params"], jc, jtrainer._select_rows(jb, jnp.asarray(idx)),
                          example_weights=jnp.asarray(w, jnp.float32))
    np.testing.assert_allclose(float(tm["loss"]), float(ref), rtol=1e-5)


@pytest.mark.parametrize("mode", ["none", "uniform", "coreset"])
def test_three_steps_match_reference(mode, monkeypatch):
    jc, tc, js, ts = _pair()
    spy = _Spy(monkeypatch)
    tstep, jstep = _tstep(tc, mode), _jstep(jc, mode)
    for i, (jb, tb) in enumerate(_batches(jc, 3, seed=3)):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        if mode == "coreset":
            spy.g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb),
                                      "leverage", 1e-4)
        js, jm = jstep(js, jb, key)
        ts, tm = tstep(ts, tb, key_from_numpy(np.asarray(key), CPU))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    _assert_params_close(ts, js, 3)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

def test_remat_on_and_off_give_the_same_loss_and_gradients():
    jc, tc, js, ts = _pair()
    (jb, tb), = _batches(jc, 1, seed=4)
    on = dataclasses.replace(tc, remat=True)
    out = {}
    for c in (tc, on):
        model = ts["params"]
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, c, tb)
        loss.backward()
        out[c.remat] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(out[True][1][n], out[False][1][n]) for n in out[False][1])
    # and they are the reference's (remat changes no arithmetic there)
    jgrads, _ = _reference_grads(jc, js, jb, "none", None)
    _assert_grads_close(_grads_numpy(ts["params"]), jgrads)


def test_remat_recomputes_each_layer_under_grad_only(monkeypatch):
    from repro_torch.models import lm

    calls = []
    real = lm._layer_fwd

    def counted(*a):
        calls.append(torch.is_grad_enabled())
        return real(*a)

    monkeypatch.setattr(lm, "_layer_fwd", counted)
    _, tc, _, ts = _pair()
    on = dataclasses.replace(tc, remat=True)
    (_, tb), = _batches(get_arch(ARCH).reduced(), 1)
    loss, _ = api.loss_fn(ts["params"], on, tb)
    assert len(calls) == 2
    loss.backward()
    assert len(calls) == 4                    # each layer again in backward
    with torch.no_grad():
        api.loss_fn(ts["params"], on, tb)
    assert len(calls) == 6                    # no checkpoint without grad


# --------------------------------------------------------------------------
# the reference's tests/test_trainer.py, restated
# --------------------------------------------------------------------------

def _setup(mode, seed=0):
    cfg = get_arch(ARCH).reduced()
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(seed), device=CPU)
    sel = None if mode == "none" else SelectorConfig(mode=mode, fraction=FRACTION)
    step = make_train_step(cfg, cosine_with_warmup(2e-3, 5, 50), sel)
    stream = TokenStream(vocab=cfg.vocab_size, seq_len=S, batch_size=B, seed=seed, device=CPU)
    return cfg, state, step, iter(stream)


@pytest.mark.parametrize("mode", ["none", "uniform", "coreset"])
def test_training_reduces_loss(mode):
    from repro_torch import rng

    cfg, state, step, it = _setup(mode)
    key = rng.PRNGKey(0)
    losses = []
    for i in range(12):
        state, m = step(state, next(it), rng.fold_in(key, i))
        losses.append(float(m["ce"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), (mode, losses)


def test_weighted_loss_unbiased_estimate():
    """Coreset gradient signal: the weighted subsample CE approximates the
    full-batch CE in expectation."""
    from repro_torch import rng

    cfg, state, _, it = _setup("none")
    batch = next(it)
    with torch.no_grad():
        full, _ = api.loss_fn(state["params"], cfg, batch)
        feats = trainer._score_features(state["params"], cfg, batch)
        g = local_scores(feats, "leverage", 1e-4)
        ests = []
        for s in range(30):
            idx, w = sample_coreset(rng.PRNGKey(s), g, 4)
            est, _ = api.loss_fn(state["params"], cfg, trainer._select_rows(batch, idx),
                                 example_weights=w)
            ests.append(float(est))
    assert abs(np.mean(ests) - float(full)) / float(full) < 0.15


def test_eval_step_is_the_reference_ce():
    jc, tc, js, ts = _pair()
    (jb, tb), = _batches(jc, 1, seed=5)
    ce = make_eval_step(tc)(ts["params"], tb)
    assert ce.shape == () and not ce.requires_grad
    np.testing.assert_allclose(float(ce), float(jtrainer.make_eval_step(jc)(js["params"], jb)),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "starcoder2-3b",
                                  "phi3-medium-14b", "internvl2-26b", "granite-moe-3b-a800m"])
def test_reduced_coreset_train_step_every_ported_family(arch):
    """The reference's ``tests/test_models_smoke.py`` train-step smoke for
    the families the port has: one coreset-selected step, loss and
    parameters finite; a VLM batch's prefix embeddings join the score
    features as in the reference's ``_score_features``."""
    from repro_torch import rng
    from repro_torch.utils.tree import tree_finite

    cfg = get_arch(arch).reduced()
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(2), device=CPU)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16), generator=g,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (8, 16), generator=g,
                                     dtype=torch.int32)}
    if cfg.frontend != "none":
        batch["prefix_embeds"] = torch.randn(8, cfg.num_prefix, cfg.d_model, generator=g)
        jc = j_get_arch(arch).reduced()
        params = jax.tree_util.tree_map(np.asarray, train_state_to_numpy(state)["params"])
        want = jtrainer._score_features(params, jc, {k: jnp.asarray(v.numpy())
                                                     for k, v in batch.items()})
        got = trainer._score_features(state["params"], cfg, batch).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    step = make_train_step(cfg, constant(1e-3), SelectorConfig(mode="coreset", fraction=0.5))
    state, m = step(state, batch, rng.PRNGKey(5))
    assert np.isfinite(float(m["loss"])) and bool(tree_finite(state["params"]))
    assert (float(m["aux"]) > 0) == cfg.is_moe


def test_train_state_init_layout():
    cfg = get_arch(ARCH).reduced()
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    names = [n for n, _ in state["params"].named_parameters()]
    assert list(state["opt"]["m"]) == names and list(state["opt"]["v"]) == names
    for t in (state["step"], state["opt"]["step"]):
        assert t.shape == () and t.dtype == torch.int32 and int(t) == 0
    ref = jax.eval_shape(lambda k: jtrainer.train_state_init(k, j_get_arch(ARCH).reduced()),
                         jax.random.PRNGKey(0))
    got = _flat(train_state_to_numpy(state))
    assert {k: v.shape for k, v in got.items()} == {
        jax.tree_util.keystr(p): l.shape for p, l in jax.tree_util.tree_flatten_with_path(ref)[0]}


def test_train_state_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_init(get_arch(ARCH).reduced())
