"""The MoE family of the port's ``models.lm`` (reduced
``granite-moe-3b-a800m``, float32) against the reference on the CPU, from
the same numpy weights (``convert.lm_params_from_numpy`` of the
reference's init) and tokens: forward, logits and loss with the aux term
(``kloop``, ``einsum`` and a shared expert), decode against forward,
``remat``, and a coreset-selected AdamW train step.

Tolerances (float32): hidden states and logits ``atol=1e-4``, losses and
aux ``rtol=1e-5``; decode against forward at ``capacity_factor=8.0`` (no
token dropped) ``atol=1e-4``; the train step as
``tests/test_torch_train.py`` holds it (gradients and moments within 1e-4
of the leaf's largest, parameters within 2 lr + 1e-5 and at most 0.5% of a
leaf beyond 1e-5); ``remat`` on and off bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import selector as jsel
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import schedules as jsched
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import (
    key_from_numpy,
    lm_params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.core.selector import SelectorConfig
from repro_torch.models import api, lm
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, trainer

CPU = "cpu"
ARCH = "granite-moe-3b-a800m"
ATOL = 1e-4


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


def _cfgs(**replace):
    return (dataclasses.replace(j_get_arch(ARCH).reduced(), **replace),
            dataclasses.replace(get_arch(ARCH).reduced(), **replace))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# the reduced granite model
# --------------------------------------------------------------------------

_MODELS = {}


def _pair(**replace):
    tag = tuple(sorted(replace.items()))
    if tag not in _MODELS:
        jc, tc = _cfgs(**replace)
        params = jax.jit(lambda k: japi.init_params(k, jc))(jax.random.PRNGKey(3))
        _MODELS[tag] = (jc, tc, params,
                        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU))
    return _MODELS[tag]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("replace", [{}, {"shared_d_ff": 64}, {"moe_dispatch": "einsum"}])
def test_forward_logits_loss_match_reference(replace):
    jc, tc, params, model = _pair(**replace)
    assert ("ffn" in dict(model.layers[0].named_children())) == bool(tc.shared_d_ff)
    toks, labels = _tokens(tc, 2, 16), _tokens(tc, 2, 16, seed=1)
    h_j, aux_j = jlm.forward(params, jc, jnp.asarray(toks))
    with torch.no_grad():
        h_t, aux_t = lm.forward(model, tc, _t(toks))
        lt = lm.logits_of(model, tc, h_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(jlm.logits_of(params, jc, h_j)),
                               atol=ATOL, rtol=0)
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": _t(toks), "labels": _t(labels)}
    with torch.no_grad():
        tot_t, m_t = api.loss_fn(model, tc, batch_t)
    tot_j, m_j = japi.loss_fn(params, jc, batch_j)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["aux"]), float(m_j["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tot_t), float(m_t["ce"]) + 0.01 * float(m_t["aux"]),
                               rtol=1e-6)


def test_decode_matches_forward_at_ample_capacity():
    """The reference's ``tests/test_decode_consistency.py`` for the MoE
    family: with capacity 8.0 no token drops, so the (B, 1) decode groups
    route as the (B, S) forward's."""
    jc, tc, params, model = _pair(capacity_factor=8.0)
    B, S = 2, 8
    toks = _tokens(tc, B, S, seed=2)
    with torch.no_grad():
        h, _ = lm.forward(model, tc, _t(toks))
        fwd = lm.logits_of(model, tc, h)
    cache = api.init_cache(tc, B, 32, device=CPU)
    jcache = jlm.init_cache(jc, B, 32)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    for t in range(S):
        step, cache = api.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        jlogits, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(step[:, 0].numpy(), fwd[:, t].numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(step.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)


def test_coreset_train_step_matches_reference(monkeypatch):
    jc, tc = _cfgs()
    js = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(6))
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), tc, CPU)
    rng_ = np.random.default_rng(6)
    toks = rng_.integers(0, tc.vocab_size, (8, 16)).astype(np.int32)
    labels = rng_.integers(0, tc.vocab_size, (8, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    key = jax.random.PRNGKey(7)
    g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
    monkeypatch.setattr(trainer, "local_scores", lambda f, s, r: _t(g))
    sel = jsel.SelectorConfig(mode="coreset", fraction=0.5)
    js2, jm = jax.jit(jtrainer.make_train_step(jc, jsched.constant(1e-3), sel))(js, jb, key)
    _, tm = make_train_step(tc, constant(1e-3), SelectorConfig(mode="coreset", fraction=0.5))(
        ts, tb, key_from_numpy(np.asarray(key), CPU))
    assert float(tm["aux"]) > 0
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    got = train_state_to_numpy(ts)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    tp, jp = flat(got["params"]), flat(js2["params"])
    assert "['layers']['moe']['router']" in jp
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2e-3 + 1e-5 and (d > 1e-5).mean() <= 0.005, (k, d.max())
    tm_, jm_ = flat(got["opt"]["m"]), flat(js2["opt"]["m"])
    for k in jm_:
        np.testing.assert_allclose(tm_[k], jm_[k], rtol=0, atol=1e-4 * np.abs(jm_[k]).max(),
                                   err_msg=k)


def test_remat_on_and_off_agree_with_moe():
    _, tc, _, model = _pair()
    toks = _t(_tokens(tc, 2, 16, seed=3))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for c in (tc, dataclasses.replace(tc, remat=True)):
        model.zero_grad(set_to_none=True)
        loss, m = api.loss_fn(model, c, batch)
        loss.backward()
        out.append((loss.detach(), m["aux"].detach(),
                    [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))
    model.zero_grad(set_to_none=True)


