"""The SSM and hybrid families of the port's ``models.lm`` — reduced
``rwkv6-3b`` (RWKV-6) and ``hymba-1.5b`` (sliding-window GQA beside a
Mamba branch), float32 — against the reference on the CPU, from the same
numpy weights (``convert.lm_params_from_numpy`` of the reference's init)
and tokens: forward, loss and every gradient leaf, decode against forward
(and Hymba with a window of 4, its ring wrapping beside the Mamba state),
``ServeEngine.generate``, and remat.  ``tests/test_torch_ssm_train.py``
holds their train steps, ``tests/test_torch_ssm_convert.py`` their
weights, caches and checkpoints across the packages.

Tolerances (float32; measured in brackets):

* hidden states and logits ``atol=1e-4`` (2.0e-5 at max |logit| 4.9);
  loss ``rtol=1e-5`` (7.2e-8); every gradient leaf within ``1e-4`` of
  the leaf's largest |g| (2.1e-5, Hymba's ``dt_bias``, a sum over every
  token; the mixers' own gradients agree to 1.1e-5,
  ``tests/test_torch_ssm.py``);
* decode against forward and against the reference's decode, and the
  cache's state leaves, ``atol=1e-4`` (1.9e-5, the windowed Hymba);
* ``generate``: the tokens equal, greedy and at temperature 0.8;
* remat on and off bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as japi
from repro.models import lm as jlm
from repro.models.lm_serve import ServeEngine as JServeEngine
from repro_torch.configs import all_arch_names, get_arch
from repro_torch.convert import (
    _stacked,
    key_from_numpy,
    lm_params_from_numpy,
)
from repro_torch.models import api, lm
from repro_torch.models.lm_serve import ServeEngine

CPU = "cpu"
ARCHS = ["rwkv6-3b", "hymba-1.5b"]
ATOL = 1e-4
B, S = 8, 16


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


def _cfgs(arch, **replace):
    return (dataclasses.replace(j_get_arch(arch).reduced(), **replace),
            dataclasses.replace(get_arch(arch).reduced(), **replace))


_MODELS = {}


def _pair(arch, **replace):
    tag = (arch,) + tuple(sorted(replace.items()))
    if tag not in _MODELS:
        jc, tc = _cfgs(arch, **replace)
        params = jax.jit(lambda k: japi.init_params(k, jc))(jax.random.PRNGKey(3))
        # a decay and a bonus that are not the init's constants
        if "rwkv" in params["layers"]:
            r = np.random.default_rng(1)
            rw = dict(params["layers"]["rwkv"])
            rw["decay_base"] = jnp.asarray(r.uniform(-2.0, 1.0, rw["decay_base"].shape),
                                           jnp.float32)
            rw["bonus_u"] = jnp.asarray(r.standard_normal(rw["bonus_u"].shape), jnp.float32)
            params = dict(params, layers=dict(params["layers"], rwkv=rw))
        _MODELS[tag] = (jc, tc, params,
                        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU))
    return _MODELS[tag]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# the models against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    jc, tc, params, model = _pair(arch)
    mixers = {n.split(".")[2] for n, _ in model.named_parameters() if n.startswith("layers.")}
    assert mixers == ({"attn_norm", "ffn_norm", "rwkv", "ffn"} if arch == "rwkv6-3b"
                      else {"attn_norm", "ffn_norm", "attn", "mamba", "ffn"})
    toks, labels = _tokens(tc, 2, S), _tokens(tc, 2, S, seed=1)
    h_j, _ = jlm.forward(params, jc, jnp.asarray(toks))
    with torch.no_grad():
        h_t, aux = lm.forward(model, tc, _t(toks))
        lt = lm.logits_of(model, tc, h_t)
    assert float(aux) == 0.0
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(jlm.logits_of(params, jc, h_j)),
                               atol=ATOL, rtol=0)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (tot_j, _), g_j = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(p, jc, jb),
                                                 has_aux=True))(params)
    model.zero_grad(set_to_none=True)
    tot_t, _ = api.loss_fn(model, tc, {"tokens": _t(toks), "labels": _t(labels)})
    tot_t.backward()
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    tg = _flat(_stacked((n, p.grad.numpy()) for n, p in model.named_parameters()))
    jg = _flat(g_j)
    assert tg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-4 * np.abs(jg[k]).max(),
                                   err_msg=k)
    model.zero_grad(set_to_none=True)


def _decode_both(jc, tc, params, model, toks, cache_len):
    """Decode ``toks`` in both packages; yields (t, port logits, reference
    logits) and leaves the caches in the returned dict."""
    b, s = toks.shape
    cache = api.init_cache(tc, b, cache_len, device=CPU)
    jcache = jlm.init_cache(jc, b, cache_len)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    out = []
    for t in range(s):
        step, cache = api.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        jlogits, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        out.append((step.numpy().copy(), np.asarray(jlogits)))
    return out, cache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_and_the_reference(arch):
    """The reference's ``tests/test_decode_consistency.py``: decode at every
    position is the forward's logits, and the reference's decode."""
    jc, tc, params, model = _pair(arch)
    toks = _tokens(tc, 2, 8, seed=2)
    with torch.no_grad():
        fwd = model(_t(toks)).numpy()
    steps, cache, jcache = _decode_both(jc, tc, params, model, toks, 32)
    for t, (got, want) in enumerate(steps):
        np.testing.assert_allclose(got[:, 0], fwd[:, t], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert cache["layers"].keys() == jcache["layers"].keys()
    assert ("kpos" in cache) == ("kpos" in jcache) == (arch != "rwkv6-3b")
    for k, v in cache["layers"].items():
        assert v.dtype == (torch.float32 if k in ("wkv", "mamba_h") else tc.param_dtype)
        np.testing.assert_allclose(v.numpy(), np.asarray(jcache["layers"][k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    assert int(cache["pos"]) == 8


def test_hymba_window_ring_wraps_beside_the_mamba_state():
    """A window of 4 over 10 tokens: the attention ring wraps while the
    Mamba state carries every token; decode is the windowed forward, and
    the reference's decode."""
    jc, tc, params, model = _pair("hymba-1.5b", sliding_window=4)
    toks = _tokens(tc, 1, 10, seed=3)
    with torch.no_grad():
        fwd = model(_t(toks)).numpy()
    steps, cache, jcache = _decode_both(jc, tc, params, model, toks, 64)
    assert cache["layers"]["k"].shape[2] == 4 and cache["kpos"].shape == (4,)
    for t, (got, want) in enumerate(steps):
        np.testing.assert_allclose(got[:, 0], fwd[:, t], atol=ATOL, rtol=0, err_msg=str(t))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=str(t))
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    np.testing.assert_allclose(cache["layers"]["mamba_h"].numpy(),
                               np.asarray(jcache["layers"]["mamba_h"]), atol=ATOL, rtol=0)



@pytest.mark.parametrize("arch", ARCHS)
def test_float64_copy_tells_rounding_from_a_decode_fault(arch):
    """A float64 copy (``layers.wide``: every step the reference runs in
    float32 runs in float64, the decode state too) of 16 reduced layers:
    decode meets the forward within 1e-9 x max |logit| (measured 1.2e-14
    Hymba, 2.4e-14 RWKV), and the float32 decode lies no farther from the
    float64 decode than 4x the float32 forward from the float64 forward
    (0.78x, 0.85x): ``chip_smoke.py`` phases 20 and 21 (b) at the
    published width."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), num_layers=16)
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64)
    m32 = api.init_params(cfg, generator=torch.Generator().manual_seed(5), device=CPU)
    m64 = api.init_params(c64, device="meta").to_empty(device=CPU)
    with torch.no_grad():
        for q, p in zip(m64.parameters(), m32.parameters()):
            q.copy_(p)
    assert {p.dtype for p in m64.parameters()} == {torch.float64}
    toks = _t(_tokens(cfg, 2, 16, seed=6))
    out = []
    for c, model in ((cfg, m32), (c64, m64)):
        with torch.no_grad():
            fwd = model(toks)
        cache = api.init_cache(c, 2, 16, device=CPU)
        assert {v.dtype for v in cache["layers"].values()} == {c.param_dtype}
        steps = [api.decode_step(model, c, cache, toks[:, t:t + 1])[0][:, 0]
                 for t in range(16)]
        out.append((fwd, torch.stack(steps, dim=1)))
    (f32, d32), (f64, d64) = out
    assert f64.dtype == d64.dtype == torch.float64
    scale = float(f64.abs().max())
    assert float((d64 - f64).abs().max()) <= 1e-9 * scale
    assert float((d32 - d64).abs().max()) <= 4 * float((f32 - f64).abs().max())

@pytest.mark.parametrize("arch,temperature", [(a, t) for a in ARCHS for t in (0.0, 0.8)])
def test_generate_matches_reference(arch, temperature):
    jc, tc, params, model = _pair(arch)
    prompts = _tokens(tc, 2, 5, seed=4)
    key = jax.random.PRNGKey(9)
    want = JServeEngine(jc, params, cache_len=16).generate(
        jnp.asarray(prompts), max_new_tokens=6, temperature=temperature, key=key)
    got = ServeEngine(tc, model, cache_len=16).generate(
        _t(prompts), max_new_tokens=6, temperature=temperature,
        key=key_from_numpy(np.asarray(key), CPU))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_agree(arch):
    _, tc, _, model = _pair(arch)
    toks = _t(_tokens(tc, 2, S, seed=8))
    out = []
    for c in (tc, dataclasses.replace(tc, remat=True)):
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, c, {"tokens": toks, "labels": toks})
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("arch", all_arch_names())
def test_every_config_inits_serves_and_trains(arch):
    """Every catalog config at ``reduced()`` through ``models.api`` on the
    CPU: init, ``generate`` (frames for the encoder-decoder), one AdamW
    step with a finite loss that moves every matrix."""
    from repro_torch import rng
    from repro_torch.optim.schedules import constant
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_arch(arch).reduced()
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(4), device=CPU)
    model = state["params"]
    gen = np.random.default_rng(4)
    toks = _t(gen.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    if cfg.frontend != "none" or cfg.kind == "encdec":
        batch["prefix_embeds"] = _t(gen.standard_normal(
            (2, cfg.num_prefix, cfg.d_model)).astype(np.float32))
    out = ServeEngine(cfg, model, cache_len=16).generate(
        toks[:, :2], max_new_tokens=3,
        prefix_embeds=batch.get("prefix_embeds") if cfg.kind == "encdec" else None)
    assert out.shape == (2, 3) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, met = make_train_step(cfg, constant(1e-3))(state, batch, rng.PRNGKey(4))
    assert np.isfinite(float(met["loss"]))
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters()
               if p.dim() >= 2), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch(arch).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
