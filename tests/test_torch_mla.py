"""MLA (``repro_torch.models.attention.mla_attention``) and the reduced
``deepseek-v2-236b`` (MLA + MoE, float32) against the reference on the
CPU, from the same numpy weights (the reference's init, copied) and
inputs made from a seed: the non-absorbed prefill, the absorbed decode
over a ring that wraps, the model's forward, loss and every gradient
leaf, decode against forward, ``ServeEngine.generate`` token for token,
a coreset-selected train step, and the parameter counts.

Tolerances (float32; measured in brackets):

* ``mla_attention``: prefill output and caches, and each absorbed decode
  step with the ring's contents, ``atol=1e-5`` against the reference
  (prefill 4.8e-7 and its caches 1.1e-6, decode 9.5e-7; the largest
  |value| 2 to 4); the port's absorbed decode against its own prefill
  ``atol=1e-5`` (8.3e-7).
* The model: hidden states and logits ``atol=1e-4`` (4.0e-6 at max
  |logit| 4), loss and aux ``rtol=1e-5`` (1.1e-7); every gradient leaf
  within ``1e-4`` of the leaf's largest |g| (1.7e-6); decode against
  forward and against the reference's decode at ``capacity_factor=8.0``
  (no token dropped) ``atol=1e-4`` (4.4e-6).
* ``generate``: the tokens equal, greedy and at temperature 0.8.
* The train step as ``tests/test_torch_train.py`` holds it: the rows
  exactly, loss ``rtol=1e-5``, parameters within 2 lr + 1e-5 with at most
  0.5 % of a leaf beyond 1e-5, the first moments within 1e-4 of the
  leaf's largest (1.8e-6).
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
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.lm_serve import ServeEngine as JServeEngine
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
from repro_torch.models import api, attention as attn, lm
from repro_torch.models.lm_serve import ServeEngine
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, trainer

CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b"
MIX_ATOL = 1e-5
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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfgs(**replace):
    return (dataclasses.replace(j_get_arch(ARCH).reduced(), **replace),
            dataclasses.replace(get_arch(ARCH).reduced(), **replace))


# --------------------------------------------------------------------------
# mla_attention
# --------------------------------------------------------------------------

def _mla(seed=0):
    jc, tc = _cfgs()
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jc)
    # norm gains that are not ones
    r = np.random.default_rng(seed)
    jp = dict(jp, q_ln=jnp.asarray(r.uniform(0.5, 1.5, jc.q_lora_rank), jnp.float32),
              kv_ln=jnp.asarray(r.uniform(0.5, 1.5, jc.kv_lora_rank), jnp.float32))
    mod = attn.init_mla(tc, device="meta").to_empty(device=CPU)
    names = dict(mod.named_parameters())
    assert list(names) == list(jp)
    with torch.no_grad():
        for n, p in names.items():
            p.copy_(_t(jp[n]))
    return jc, tc, jp, mod


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_init_mla_names_shapes_and_dtypes(monkeypatch):
    jc, tc = _cfgs(param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jc)
    mod = attn.init_mla(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    got = {n: (tuple(p.shape), p.dtype) for n, p in mod.named_parameters()}
    assert got == {n: (tuple(a.shape), torch.bfloat16) for n, a in jp.items()}
    assert bool((mod.q_ln == 1).all()) and bool((mod.kv_ln == 1).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attn.init_mla(tc)


@pytest.mark.parametrize("chunk", [8, 4])
def test_mla_prefill_matches_reference(chunk):
    jc, tc, jp, mod = _mla()
    x = _x(tc, 2, 8, 1)
    pos = np.arange(8)
    jout, (jc_kv, jk_pe) = jattn.mla_attention(jp, jc, jnp.asarray(x), jnp.asarray(pos),
                                               chunk=chunk)
    with torch.no_grad():
        out, (c_kv, k_pe) = attn.mla_attention(mod, tc, _t(x), _t(pos), chunk=chunk)
    assert c_kv.shape == (2, 8, tc.kv_lora_rank) and k_pe.shape == (2, 8, tc.qk_rope_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=MIX_ATOL)
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(jc_kv), rtol=0, atol=MIX_ATOL)
    np.testing.assert_allclose(k_pe.numpy(), np.asarray(jk_pe), rtol=0, atol=MIX_ATOL)


def _decode(fn_mla, fn_kpos, params, cfg, x, ring, to, frm):
    """Decode ``x`` (B, S, D) one token at a time over a ring of ``ring``
    slots; returns the outputs (B, S, D) and the final caches as numpy."""
    B, S, _ = x.shape
    cc = to(np.zeros((B, ring, cfg.kv_lora_rank), np.float32))
    cpe = to(np.zeros((B, ring, cfg.qk_rope_dim), np.float32))
    kpos = to(np.full((ring,), lm.KPOS_EMPTY, np.int32))
    outs = []
    for t in range(S):
        positions = to(np.array([t], np.int32))
        kpos = fn_kpos(kpos, positions)
        out, (cc, cpe) = fn_mla(params, cfg, to(x[:, t:t + 1]), positions, kv_cache=(cc, cpe),
                                cache_positions=kpos)
        outs.append(frm(out))
    return np.concatenate(outs, axis=1), frm(cc), frm(cpe)


def test_mla_absorbed_decode_over_a_wrapping_ring():
    """10 tokens through a ring of 4: each step's output and the ring's
    contents against the reference's absorbed decode."""
    jc, tc, jp, mod = _mla(seed=1)
    x = _x(tc, 2, 10, 2)
    want = _decode(jattn.mla_attention, jattn.update_kpos, jp, jc, x, 4, jnp.asarray,
                   np.asarray)
    with torch.no_grad():
        got = _decode(attn.mla_attention, attn.update_kpos, mod, tc, x, 4, _t,
                      lambda t: t.numpy().copy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=MIX_ATOL)


def test_absorbed_decode_equals_the_prefill():
    """The absorbed form over a ring that holds every token is the
    non-absorbed prefill at every position."""
    _, tc, _, mod = _mla(seed=2)
    x = _x(tc, 2, 8, 3)
    with torch.no_grad():
        full, _ = attn.mla_attention(mod, tc, _t(x), torch.arange(8), chunk=4)
        steps, _, _ = _decode(attn.mla_attention, attn.update_kpos, mod, tc, x, 16, _t,
                              lambda t: t.numpy().copy())
    np.testing.assert_allclose(steps, full.numpy(), rtol=0, atol=MIX_ATOL)


# --------------------------------------------------------------------------
# the reduced deepseek model
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


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_forward_loss_and_gradients_match_reference():
    jc, tc, params, model = _pair()
    assert {n.split(".")[2] for n, _ in model.named_parameters() if n.startswith("layers.")} \
        == {"attn_norm", "ffn_norm", "mla", "moe", "ffn"}
    toks, labels = _tokens(tc, 2, 16), _tokens(tc, 2, 16, seed=1)
    h_j, aux_j = jlm.forward(params, jc, jnp.asarray(toks))
    with torch.no_grad():
        h_t, aux_t = lm.forward(model, tc, _t(toks))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lm.logits_of(model, tc, h_t).detach().numpy(),
                               np.asarray(jlm.logits_of(params, jc, h_j)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (tot_j, m_j), g_j = jax.value_and_grad(lambda p: japi.loss_fn(p, jc, jb), has_aux=True)(
        params)
    model.zero_grad(set_to_none=True)
    tot_t, m_t = api.loss_fn(model, tc, {"tokens": _t(toks), "labels": _t(labels)})
    tot_t.backward()
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), rtol=1e-5)
    from repro_torch.convert import _stacked

    tg = _flat(_stacked((n, p.grad.numpy()) for n, p in model.named_parameters()))
    jg = _flat(g_j)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-4 * np.abs(jg[k]).max(),
                                   err_msg=k)
    model.zero_grad(set_to_none=True)


def test_decode_matches_forward_and_the_reference():
    """The reference's ``tests/test_decode_consistency.py`` for MLA + MoE:
    at capacity 8.0 no token drops, so decode routes as the forward."""
    jc, tc, params, model = _pair(capacity_factor=8.0)
    B, S = 2, 8
    toks = _tokens(tc, B, S, seed=2)
    with torch.no_grad():
        fwd = model(_t(toks))
    cache = api.init_cache(tc, B, 32, device=CPU)
    assert set(cache["layers"]) == {"c_kv", "k_pe"} and cache["kpos"].shape == (32,)
    assert cache["layers"]["c_kv"].shape == (tc.num_layers, B, 32, tc.kv_lora_rank)
    jcache = jlm.init_cache(jc, B, 32)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    for t in range(S):
        step, cache = api.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        jlogits, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(step[:, 0].numpy(), fwd[:, t].numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(step.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    for k in ("c_kv", "k_pe"):
        np.testing.assert_allclose(cache["layers"][k].numpy(), np.asarray(jcache["layers"][k]),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_reference(temperature):
    jc, tc, params, model = _pair()
    prompts = _tokens(tc, 2, 5, seed=4)
    key = jax.random.PRNGKey(9)
    want = JServeEngine(jc, params, cache_len=16).generate(
        jnp.asarray(prompts), max_new_tokens=6, temperature=temperature, key=key)
    got = ServeEngine(tc, model, cache_len=16).generate(
        _t(prompts), max_new_tokens=6, temperature=temperature,
        key=key_from_numpy(np.asarray(key), CPU))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coreset_train_step_matches_reference(monkeypatch):
    jc, tc = _cfgs()
    js = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(6))
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), tc, CPU)
    r = np.random.default_rng(6)
    toks = r.integers(0, tc.vocab_size, (8, 16)).astype(np.int32)
    labels = r.integers(0, tc.vocab_size, (8, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    key = jax.random.PRNGKey(7)
    g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
    jidx, _ = jsel.sample_coreset(key, g, 4)
    rows = []
    real_select = trainer._select_rows
    monkeypatch.setattr(trainer, "local_scores", lambda f, s, r_: _t(g))
    monkeypatch.setattr(trainer, "_select_rows",
                        lambda b, i: rows.append(i) or real_select(b, i))
    sel = jsel.SelectorConfig(mode="coreset", fraction=0.5)
    js2, jm = jax.jit(jtrainer.make_train_step(jc, jsched.constant(1e-3), sel))(js, jb, key)
    _, tm = make_train_step(tc, constant(1e-3), SelectorConfig(mode="coreset", fraction=0.5))(
        ts, {"tokens": _t(toks), "labels": _t(labels)}, key_from_numpy(np.asarray(key), CPU))
    assert len(rows) == 1 and rows[0].tolist() == np.asarray(jidx).tolist()
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    got = train_state_to_numpy(ts)
    tp, jp = _flat(got["params"]), _flat(js2["params"])
    assert "['layers']['mla']['w_uk']" in jp
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2e-3 + 1e-5 and (d > 1e-5).mean() <= 0.005, (k, d.max())
    tm_, jm_ = _flat(got["opt"]["m"]), _flat(js2["opt"]["m"])
    for k in jm_:
        np.testing.assert_allclose(tm_[k], jm_[k], rtol=0, atol=1e-4 * np.abs(jm_[k]).max(),
                                   err_msg=k)


def test_parameter_counts():
    """The reduced model's counts are the reference's; at the published
    width 6 of the 160 routed experts are active a token."""
    jc, tc, params, model = _pair()
    assert api.param_count(model) == japi.param_count(params)
    assert api.active_param_count(tc, model) == japi.active_param_count(jc, params)
    cfg = get_arch(ARCH)
    meta = api.init_params(cfg, device="meta")
    total = api.param_count(meta)
    experts = cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff
    assert api.active_param_count(cfg, meta) == int(total - experts + experts * 6 / 160)
    one = api.param_count(api.init_params(dataclasses.replace(cfg, num_layers=1),
                                          device="meta"))
    assert one == 5_020_697_600
    assert api.param_count(api.init_params(dataclasses.replace(cfg, num_layers=4),
                                           device="meta")) == 16_937_047_040


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch(ARCH).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
