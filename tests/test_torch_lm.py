"""The port's LM building blocks (``repro_torch.configs``, ``data.lm``,
``models.layers`` and the GQA attention) against the reference on the CPU, from the same numpy
weights (``convert.lm_params_from_numpy`` of the reference's init) and
tokens.  The forward, logits and loss are ``tests/test_torch_lm_forward.py``'s,
decode and serving ``tests/test_torch_lm_serve.py``'s.

Tolerances: the layers and the attention ``atol=1e-5`` (float32 at the
reduced widths); bf16 attention ``atol=2e-2`` (one bf16 rounding of
an O(1) output).  The configs, the token stream and ``lm_batch`` are
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import all_arch_names as j_all_arch_names
from repro.configs import get_arch as j_get_arch
from repro.data.lm import TokenStream as JStream
from repro.data.lm import lm_batch as j_lm_batch
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import INPUT_SHAPES, all_arch_names, get_arch
from repro_torch.convert import key_from_numpy, lm_params_from_numpy
from repro_torch.data import TokenStream, lm_batch
from repro_torch.models import attention as attn
from repro_torch.models import layers

CPU = "cpu"


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


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["param_dtype"] = str(np.dtype(cfg.param_dtype)) if not isinstance(
        cfg.param_dtype, torch.dtype) else str(cfg.param_dtype).replace("torch.", "")
    return out


def test_config_registry_matches_reference():
    assert all_arch_names() == j_all_arch_names()
    assert len(all_arch_names()) == 10
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(j_all_arch_names()))
def test_config_field_by_field(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for jv, tv in [(j, t), (j.reduced(), t.reduced()),
                   (j.for_shape(J_SHAPES["long_500k"]), t.for_shape(INPUT_SHAPES["long_500k"])),
                   (j.for_shape(J_SHAPES["train_4k"]), t.for_shape(INPUT_SHAPES["train_4k"]))]:
        assert _fields(tv) == _fields(jv)
        assert (tv.vocab_pad, tv.is_moe, tv.dec_layers, tv.supports_long_context()) == (
            jv.vocab_pad, jv.is_moe, jv.dec_layers, jv.supports_long_context())
    assert t.param_dtype == torch.bfloat16 and t.reduced().param_dtype == torch.float32


# --------------------------------------------------------------------------
# token stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,S,B,seed", [(512, 16, 4, 0), (128256, 8, 3, 7), (50, 1, 9, 2)])
def test_token_stream_matches_reference(vocab, S, B, seed):
    js = iter(JStream(vocab=vocab, seq_len=S, batch_size=B, seed=seed))
    ts = iter(TokenStream(vocab=vocab, seq_len=S, batch_size=B, seed=seed, device=CPU))
    for _ in range(2):
        a, b = next(js), next(ts)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


@pytest.mark.parametrize("seed", [0, 9, 12345])
def test_lm_batch_matches_reference(seed):
    k = jax.random.PRNGKey(seed)
    a = j_lm_batch(k, 4, 8, 300)
    b = lm_batch(key_from_numpy(np.asarray(k), CPU), 4, 8, 300, device=CPU)
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(b[name].numpy(), np.asarray(a[name]))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_layers_match_reference():
    rs = np.random.default_rng(1)
    x = rs.standard_normal((2, 5, 3, 64)).astype(np.float32)
    gamma = (1 + 0.1 * rs.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rs.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(layers.rms_norm(_t(x), _t(gamma)).numpy(),
                               np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(gamma))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        layers.layer_norm(_t(x), _t(gamma), _t(beta)).numpy(),
        np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))),
        atol=1e-5, rtol=0)
    pos = np.arange(5, dtype=np.int32) * 700
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            layers.apply_rope(_t(x), _t(pos)[None, :], theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None, :], theta)),
            atol=1e-5, rtol=0)
        np.testing.assert_allclose(layers.rope_freqs(64, theta).numpy(),
                                   np.asarray(jlayers.rope_freqs(64, theta)), rtol=1e-6)
    logits = (3 * rs.standard_normal((4, 6, 97))).astype(np.float32)
    labels = rs.integers(0, 97, (4, 6)).astype(np.int32)
    np.testing.assert_allclose(
        layers.cross_entropy(_t(logits), _t(labels)).numpy(),
        np.asarray(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        atol=1e-5, rtol=0)


def test_rms_norm_keeps_bf16_and_computes_in_f32():
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    g = torch.full((8,), 1.5, dtype=torch.bfloat16)
    out = layers.rms_norm(x, g)
    xf = x.float()
    want = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) * 1.5).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)


def test_mlp_and_unembed_match_reference():
    jc, tc, params, model = _pair("llama3.2-1b")
    rs = np.random.default_rng(2)
    x = rs.standard_normal((2, 3, tc.d_model)).astype(np.float32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ffn"])
    np.testing.assert_allclose(layers.mlp(model.layers[0].ffn, _t(x)).numpy(),
                               np.asarray(jlayers.mlp(p0, jnp.asarray(x))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        layers.unembed(_t(x), model.embed, True).numpy(),
        np.asarray(jlayers.unembed(jnp.asarray(x), params["embed"], True)), atol=1e-5, rtol=0)
    jc2, tc2, params2, model2 = _pair("starcoder2-3b", tie_embeddings=False)
    np.testing.assert_allclose(
        layers.unembed(_t(x), model2.head, False).numpy(),
        np.asarray(jlayers.unembed(jnp.asarray(x), params2["head"], False)), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,window", [("llama3.2-1b", None), ("qwen3-14b", None),
                                         ("starcoder2-3b", None), ("llama3.2-1b", 4)])
def test_gqa_attention_matches_reference(arch, window):
    jc, tc, params, model = _pair(arch)
    S = 16
    x = np.random.default_rng(4).standard_normal((2, S, tc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    want, (jk, jv) = jattn.gqa_attention(p0, jc, jnp.asarray(x), jnp.asarray(pos),
                                         window=window, chunk=jc.attn_chunk)
    got, (k, v) = attn.gqa_attention(model.layers[0].attn, tc, _t(x), _t(pos),
                                     window=window, chunk=tc.attn_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def test_gqa_head_grouping_maps_query_head_to_kv_head_h_div_g():
    """Query head h reads KV head h // G: with every KV head but one zeroed
    in V, only that head's G query heads see a nonzero output."""
    _, tc, _, model = _pair("llama3.2-1b")
    B, S, KV, G, hd = 1, 8, tc.num_kv_heads, tc.num_heads // tc.num_kv_heads, tc.head_dim
    q = torch.randn(B, S, KV, G, hd, generator=torch.Generator().manual_seed(0))
    k = torch.randn(B, S, KV, hd, generator=torch.Generator().manual_seed(1))
    v = torch.zeros(B, S, KV, hd)
    v[:, :, 1] = 1.0
    pos = torch.arange(S)
    out = attn._sdpa_chunked(q, k, v, pos, pos, 0, 8).reshape(B, S, KV * G, hd)
    hit = out.abs().sum(dim=(0, 1, 3)) > 0
    assert hit.tolist() == [h // G == 1 for h in range(KV * G)]


def test_sdpa_chunk_arithmetic_mirrors_reference():
    """Sq splits into max(Sq // chunk, 1) chunks, which must be equal: 12
    queries at chunk 8 (one chunk of 12) run; 20 queries at chunk 8 (two
    chunks of 10) run; 18 at chunk 4 (four of 4.5) raise as the
    reference's reshape does."""
    q = torch.randn(1, 20, 2, 2, 16, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 20, 2, 16, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(20)
    for Sq, chunk in [(12, 8), (20, 8), (20, 1)]:
        out = attn._sdpa_chunked(q[:, :Sq], k[:, :Sq], k[:, :Sq], pos[:Sq], pos[:Sq], 0, chunk)
        want = jattn._sdpa_chunked(jnp.asarray(q[:, :Sq].numpy()), jnp.asarray(k[:, :Sq].numpy()),
                                   jnp.asarray(k[:, :Sq].numpy()), jnp.arange(Sq), jnp.arange(Sq),
                                   0, chunk)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="do not split"):
        attn._sdpa_chunked(q[:, :18], k[:, :18], k[:, :18], pos[:18], pos[:18], 0, 4)
    with pytest.raises(TypeError):
        jattn._sdpa_chunked(jnp.asarray(q[:, :18].numpy()), jnp.asarray(k[:, :18].numpy()),
                            jnp.asarray(k[:, :18].numpy()), jnp.arange(18), jnp.arange(18),
                            0, 4)


def test_sdpa_bf16_mixed_precision():
    """bf16 operands: float32 scores and PV sums, probabilities cast to
    bf16 before the second product, the result bf16 — the reference's
    preferred_element_type arithmetic, within a bf16 rounding."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 8, 2, 2, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 8, 2, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 8, 2, 16, generator=g).to(torch.bfloat16)
    pos = torch.arange(8)
    out = attn._sdpa_chunked(q, k, v, pos, pos, 0, 8)
    assert out.dtype == torch.bfloat16
    as_f32 = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = jattn._sdpa_chunked(as_f32(q), as_f32(k), as_f32(v), jnp.arange(8), jnp.arange(8),
                               0, 8)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)
