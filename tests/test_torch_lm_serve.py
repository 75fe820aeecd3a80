"""The port's LM decode and serving (``repro_torch.models.lm.decode_step``,
``models.lm_serve.ServeEngine``), its init, parameter counts and weight
conversion, against the reference on the CPU from the same numpy weights
(``convert.lm_params_from_numpy`` of the reference's init) and tokens.

Tolerances: decode logits ``atol=1e-4`` against the reference's
``decode_step`` and the port's own forward at every position (float32 at
the reduced widths, max |logit| about 4; the reference's own decode
against forward gap is 2.4e-6, and its test allows 2e-2).  Greedy tokens
are compared after checking that every step's top-2 logit margin exceeds
twice the logit tolerance, so equal tokens are implied by the tolerance;
sampling at a temperature is bit for bit.  The init's stds are held within
five standard errors of a +-3 std truncated normal's.
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
from repro.models.lm_serve import ServeEngine as JEngine
from repro_torch.configs import get_arch
from repro_torch.convert import (key_from_numpy, lm_cache_from_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data import TokenStream
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.lm_serve import ServeEngine, make_serve_step
from repro_torch.serve import ServeEngine as DeprecatedServeEngine
from repro_torch.serve.engine import ServeEngine as EngineModuleServeEngine

CPU = "cpu"
ATOL = 1e-4
LLAMA_1B_PARAMS = 1_235_814_400


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False), torch.no_grad():
        yield


_MODELS = {}


def _pair(arch, seed=3, **replace):
    """(jax cfg, torch cfg, reference params, port model) of a reduced arch,
    the port's weights copied from the reference's init."""
    tag = (arch, seed, tuple(sorted(replace.items())))
    if tag not in _MODELS:
        jc = dataclasses.replace(j_get_arch(arch).reduced(), **replace)
        tc = dataclasses.replace(get_arch(arch).reduced(), **replace)
        params = japi.init_params(jax.random.PRNGKey(seed), jc)
        model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
        _MODELS[tag] = (jc, tc, params, model)
    return _MODELS[tag]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,replace,B,S,cache_len", [
    ("llama3.2-1b", {}, 2, 8, 32),              # gqa ring cache
    ("qwen3-14b", {}, 2, 8, 32),                # qk_norm
    ("starcoder2-3b", {}, 2, 8, 16),            # untied-head family, G = 2
    ("llama3.2-1b", {"sliding_window": 4}, 1, 10, 64),   # the ring overwrites
    ("llama3.2-1b", {"learned_pos": 64}, 2, 8, 32)])
def test_decode_step_matches_reference_and_forward(arch, replace, B, S, cache_len):
    """Step by step: the port's logits against the reference's decode_step
    and the port's own forward at every position; the ring buffer of the
    windowed config is min(cache_len, window)."""
    jc, tc, params, model = _pair(arch, **replace)
    toks = _tokens(tc, B, S, seed=5)
    h_t, _ = lm.forward(model, tc, _t(toks))
    fwd = lm.logits_of(model, tc, h_t)
    jcache = jlm.init_cache(jc, B, cache_len)
    cache = api.init_cache(tc, B, cache_len, device=CPU)
    eff = min(cache_len, tc.sliding_window) if tc.sliding_window else cache_len
    assert cache["layers"]["k"].shape == (tc.num_layers, B, eff, tc.num_kv_heads, tc.head_dim)
    assert cache["kpos"].dtype == torch.int32 and int(cache["kpos"][0]) == lm.KPOS_EMPTY
    step = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    serve_step = make_serve_step(tc)
    for t in range(S):
        lj, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        lt, cache = serve_step(model, cache, _t(toks[:, t:t + 1]))
        assert lt.shape == (B, 1, tc.vocab_size) and int(cache["pos"]) == t + 1
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0,
                                   err_msg=f"{arch} against the reference at t={t}")
        np.testing.assert_allclose(lt[:, 0].numpy(), fwd[:, t].numpy(), atol=ATOL, rtol=0,
                                   err_msg=f"{arch} against forward at t={t}")
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))
    np.testing.assert_allclose(cache["layers"]["k"].numpy(), np.asarray(jcache["layers"]["k"]),
                               atol=1e-5, rtol=0)


def test_decode_resumes_from_a_reference_cache():
    """A reference cache taken mid-sequence, converted, decodes on in the
    port as in the reference."""
    jc, tc, params, model = _pair("llama3.2-1b")
    toks = _tokens(tc, 2, 6, seed=8)
    jcache = jlm.init_cache(jc, 2, 16)
    for t in range(4):
        _, jcache = jlm.decode_step(params, jc, jcache, jnp.asarray(toks[:, t:t + 1]))
    cache = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), CPU)
    for t in range(4, 6):
        lj, jcache = jlm.decode_step(params, jc, jcache, jnp.asarray(toks[:, t:t + 1]))
        lt, cache = lm.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _greedy_margin_ok(model, cfg, prompts, n):
    """Every greedy step's top-2 logit margin, on the port's own decode,
    exceeds twice the logit tolerance (so tokens equal within tolerance
    are the same tokens)."""
    B, P = prompts.shape
    cache = lm.init_cache(cfg, B, 64, device=CPU)
    logits = None
    for t in range(P):
        logits, cache = lm.decode_step(model, cfg, cache, prompts[:, t:t + 1])
    margins = []
    for _ in range(n):
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        logits, cache = lm.decode_step(model, cfg, cache, tok)
    return min(margins)


@pytest.mark.parametrize("arch,seed", [("llama3.2-1b", 0), ("starcoder2-3b", 1)])
def test_generate_greedy_matches_reference(arch, seed):
    jc, tc, params, model = _pair(arch, seed=seed)
    prompts = _tokens(tc, 2, 3, seed=seed + 10)
    assert _greedy_margin_ok(model, tc, _t(prompts), 6) > 2 * ATOL
    want = np.asarray(JEngine(jc, params, cache_len=64).generate(jnp.asarray(prompts),
                                                                 max_new_tokens=6))
    eng = ServeEngine(tc, model, cache_len=64)
    got = eng.generate(_t(prompts), max_new_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(eng.generate(_t(prompts), max_new_tokens=6), got)   # greedy
    assert int(got.max()) < tc.vocab_size                                  # pad-mask
    one = eng.generate(_t(prompts[:1]), max_new_tokens=6)                 # batch-consistent
    assert torch.equal(one, got[:1])


def test_generate_sampled_matches_reference():
    """Temperature sampling with a key: the reference's tokens, given the
    same logits (checked by the greedy margin on the prompt's last step)."""
    jc, tc, params, model = _pair("llama3.2-1b")
    prompts = _tokens(tc, 2, 3, seed=21)
    k = jax.random.PRNGKey(4)
    want = np.asarray(JEngine(jc, params, cache_len=64).generate(
        jnp.asarray(prompts), max_new_tokens=4, temperature=0.8, key=k))
    got = ServeEngine(tc, model, cache_len=64).generate(
        _t(prompts), max_new_tokens=4, temperature=0.8, key=key_from_numpy(np.asarray(k), CPU))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,i", [(0.8, 0), (0.8, 5), (1.7, 3), (0.1, 1)])
def test_sample_at_a_temperature_is_bit_for_bit(temperature, i):
    logits = (3 * np.random.default_rng(i).standard_normal((3, 1, 700))).astype(np.float32)
    logits[..., 600:] = -1e30
    k = jax.random.PRNGKey(i + 17)
    want = np.asarray(JEngine._sample(jnp.asarray(logits), temperature, k, i))
    got = ServeEngine._sample(_t(logits), temperature, key_from_numpy(np.asarray(k), CPU), i)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = ServeEngine._sample(_t(logits), 0.0, key_from_numpy(np.asarray(k), CPU), i)
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(JEngine._sample(jnp.asarray(logits), 0.0, k, i)))


def test_greedy_ties_take_the_first_index():
    logits = torch.zeros(2, 1, 10)
    logits[0, 0, [3, 7]] = 5.0
    logits[1, 0, [9, 2]] = 1.0
    assert ServeEngine._sample(logits, 0.0, None, 0).ravel().tolist() == [3, 2]


def test_serve_engine_reexports():
    assert DeprecatedServeEngine is ServeEngine and EngineModuleServeEngine is ServeEngine


# --------------------------------------------------------------------------
# init, conversion, counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b", "starcoder2-3b",
                                  "phi3-medium-14b", "internvl2-26b"])
def test_init_params_tree_shapes_dtypes_and_stds(arch):
    jc = j_get_arch(arch).reduced()
    tc = get_arch(arch).reduced()
    ref = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
    model = api.init_params(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    tree = lm_params_to_numpy(model)
    flat_r = {jax.tree_util.keystr(p): (l.shape, str(l.dtype))
              for p, l in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_t = {jax.tree_util.keystr(p): (l.shape, str(l.dtype))
              for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat_t == flat_r
    assert api.param_count(model) == sum(int(np.prod(s)) for s, _ in flat_r.values())
    assert api.active_param_count(tc, model) == api.param_count(model)
    d, f = tc.d_model, tc.d_ff
    for name, std in [("embed", 1 / np.sqrt(d)), ("layers.0.attn.wq", 1 / np.sqrt(d)),
                      ("layers.1.ffn.w_down", 1 / np.sqrt(f))]:
        w = dict(model.named_parameters())[name].detach()
        n = w.numel()
        # a +-3 std truncated normal has std 0.98658 std; the sample std of
        # n draws is within 5 of its standard errors (about std / sqrt(2n))
        assert abs(float(w.std()) - 0.98658 * std) < 5 * std / np.sqrt(2 * n)
        assert float(w.abs().max()) <= 3 * std * (1 + 1e-6)
    assert torch.equal(model.layers[0].attn_norm, torch.ones(d))
    again = api.init_params(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_param_count_of_the_published_llama_on_meta():
    cfg = get_arch("llama3.2-1b")
    model = api.init_params(cfg, device="meta")
    assert api.param_count(model) == LLAMA_1B_PARAMS
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16
               for p in model.parameters())
    assert sum(p.numel() * p.element_size() for p in model.parameters()) == 2 * LLAMA_1B_PARAMS
    cache = jax.eval_shape(lambda: jlm.init_cache(j_get_arch("llama3.2-1b"), 4, 4096))
    assert sum(int(np.prod(l.shape)) * l.dtype.itemsize
               for l in jax.tree_util.tree_leaves(cache["layers"])) == 536_870_912


def test_params_round_trip_through_numpy():
    _, tc, params, model = _pair("qwen3-14b")
    back = lm_params_to_numpy(model)
    ref = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    broken = dict(ref)
    broken["final_norm"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(broken, tc, CPU)


def test_params_from_numpy_takes_bfloat16_leaves():
    jc = dataclasses.replace(j_get_arch("llama3.2-1b").reduced(), param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_arch("llama3.2-1b").reduced(), param_dtype=torch.bfloat16)
    params = japi.init_params(jax.random.PRNGKey(1), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  np.asarray(params["embed"].astype(jnp.float32)))


def test_encoder_decoder_generate_matches_reference():
    """whisper-medium (reduced): the frames through ``prefill_cross``, then
    greedy generation token for token the reference's, each step's top-2
    margin past twice the logit tolerance."""
    from repro_torch.models import encdec

    jc, tc, params, model = _pair("whisper-medium", seed=2)
    prompts = _tokens(tc, 2, 3, seed=12)
    frames = np.random.default_rng(13).standard_normal(
        (2, tc.num_prefix, tc.d_model)).astype(np.float32)
    cache = encdec.prefill_cross(model, tc, api.init_cache(tc, 2, 64, device=CPU), _t(frames))
    for t in range(3):
        logits, cache = api.decode_step(model, tc, cache, _t(prompts[:, t:t + 1]))
    for _ in range(6):
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 2 * ATOL
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
        logits, cache = api.decode_step(model, tc, cache, tok)
    want = np.asarray(JEngine(jc, params, cache_len=64).generate(
        jnp.asarray(prompts), max_new_tokens=6, prefix_embeds=jnp.asarray(frames)))
    got = ServeEngine(tc, model, cache_len=64).generate(_t(prompts), max_new_tokens=6,
                                                       prefix_embeds=_t(frames))
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attn.init_gqa(cfg)
    assert attn.init_gqa(cfg, device=CPU).wq.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(vocab=16, seq_len=4, batch_size=2)
