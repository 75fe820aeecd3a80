"""The port's encoder-decoder (``repro_torch.models.encdec``: the
``whisper-medium`` family) against the reference's on the CPU, at
``whisper-medium``'s ``reduced()`` (float32; 2 encoder and 2 decoder
layers, d 256, 8 frames), from the same numpy weights
(``convert.lm_params_from_numpy`` of the reference's init), frames and
tokens.

Tolerances: the forward's hidden states, the logits, the loss and every
decode step's logits ``atol=1e-4`` (float32, max |logit| about 4; the
port's own decode against its forward too); every gradient leaf within
``1e-4`` of its largest |g|; the cross K/V written by ``prefill_cross``
``atol=1e-5``.  Greedy tokens are compared after checking that each step's
top-2 logit margin exceeds twice the logit tolerance; sampling at a
temperature is bit for bit.  The bf16 encoder and decoder blocks are held
to the reference's block compiled with ``xla_allow_excess_precision`` off
(``tests/test_torch_lm_bf16.py``) at two bf16 ulps of the largest |y|
(``BLOCK_TOL``), with at least ``EXACT_ROWS`` of the token rows bit for
bit.  Checkpoints cross byte for byte.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models.layers import mlp as jmlp
from repro.models.layers import rms_norm as jrms
from repro.models.lm_serve import ServeEngine as JEngine
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import (key_from_numpy, lm_cache_from_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import api, encdec
from repro_torch.models.lm_serve import ServeEngine
from repro_torch.train import load_checkpoint, save_checkpoint, train_state_init

CPU = "cpu"
ARCH = "whisper-medium"
ATOL = 1e-4
WHISPER_PARAMS = 1_027_954_688
BLOCK_TOL = 2.0 ** -6
EXACT_ROWS = 0.5
B, S = 2, 16


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


_MODELS = {}


def _pair(seed=3, **replace):
    """(jax cfg, torch cfg, reference params, port model) of reduced
    whisper, the port's weights copied from the reference's init."""
    tag = (seed, tuple(sorted(replace.items())))
    if tag not in _MODELS:
        jc = dataclasses.replace(j_get_arch(ARCH).reduced(), **replace)
        tc = dataclasses.replace(get_arch(ARCH).reduced(), **replace)
        params = japi.init_params(jax.random.PRNGKey(seed), jc)
        model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
        _MODELS[tag] = (jc, tc, params, model)
    return _MODELS[tag]


def _inputs(cfg, b=B, s=S, seed=0):
    """(tokens (b, s) int32, frames (b, num_prefix, d) float32) from numpy."""
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rs.standard_normal((b, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    return toks, frames


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def test_param_count_of_the_published_whisper_on_meta():
    model = api.init_params(get_arch(ARCH), device="meta")
    assert isinstance(model, encdec.EncDecLM)
    assert api.param_count(model) == WHISPER_PARAMS
    assert len(model.enc_layers) == len(model.layers) == 24


def test_init_tree_is_the_reference_tree():
    """Names, stacked shapes and dtypes of the port's init are the
    reference's (``jax.eval_shape``), for the published config."""
    jc, tc = j_get_arch(ARCH), get_arch(ARCH)
    jshape = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    from repro_torch.sharding.specs import flat_specs, stacked_shapes

    model = api.init_params(tc, device="meta")
    dtypes = {}
    for name, p in model.named_parameters():
        path = name.split(".")
        key = path[0] if path[0] not in ("layers", "enc_layers") else path[0] + "/" + \
            "/".join(path[2:])
        dtypes[key] = str(p.dtype).replace("torch.", "")
    got = {"".join(f"['{k}']" for k in path.split("/")): (shape, dtypes[path])
           for path, shape in flat_specs(stacked_shapes(model)).items()}
    assert got == want


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------

def test_forward_and_loss_match_reference():
    jc, tc, params, model = _pair()
    toks, frames = _inputs(tc)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "prefix_embeds": frames}
    (h_j, aux_j), enc_j, (lj, _) = jax.jit(lambda p, b: (
        jed.forward(p, jc, b["tokens"], b["prefix_embeds"]),
        jed.encode(p, jc, b["prefix_embeds"]), japi.loss_fn(p, jc, b)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        h_t, aux_t = encdec.forward(model, tc, _t(toks), _t(frames))
        logits = model(_t(toks), _t(frames))
        enc = encdec.encode(model, tc, _t(frames))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), atol=ATOL, rtol=0)
    assert float(aux_t) == float(aux_j) == 0.0
    assert logits.shape == (B, S, tc.vocab_size) and logits.dtype == torch.float32
    with torch.no_grad():
        lt, mt = api.loss_fn(model, tc, {k: _t(v) for k, v in batch.items()})
        h_sel = api.forward_hidden(model, tc, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(lt), float(lj), atol=ATOL, rtol=0)
    assert float(mt["ce"]) == float(lt) and float(mt["aux"]) == 0.0
    assert torch.equal(h_sel, h_t)


@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_reference(weighted):
    jc, tc, params, model = _pair()
    toks, frames = _inputs(tc, seed=1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1), "prefix_embeds": frames}
    w = np.array([0.25, 1.75], np.float32) if weighted else None
    jgrads = jax.jit(jax.grad(lambda p, b, w: japi.loss_fn(p, jc, b, example_weights=w)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        None if w is None else jnp.asarray(w))
    model.zero_grad(set_to_none=True)
    loss, _ = api.loss_fn(model, tc, {k: _t(v) for k, v in batch.items()},
                          example_weights=None if w is None else _t(w))
    loss.backward()
    from repro_torch.convert import _stacked

    got = _stacked((n, p.grad.numpy()) for n, p in model.named_parameters())
    model.zero_grad(set_to_none=True)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    g, j = flat(got), flat(jgrads)
    assert g.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(g[k], j[k], rtol=0, atol=1e-4 * np.abs(j[k]).max(), err_msg=k)


def test_remat_on_and_off_agree_bit_for_bit():
    _, tc, _, model = _pair()
    toks, frames = _inputs(tc, seed=2)
    batch = {"tokens": _t(toks), "labels": _t(toks), "prefix_embeds": _t(frames)}
    out = []
    for c in (tc, dataclasses.replace(tc, remat=True)):
        model.zero_grad(set_to_none=True)
        loss, _ = api.loss_fn(model, c, batch)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone() for p in model.parameters()]))
    model.zero_grad(set_to_none=True)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_remat_recomputes_each_encoder_and_decoder_layer(monkeypatch):
    calls = []
    for name in ("_enc_layer", "_dec_layer"):
        real = getattr(encdec, name)

        def counted(*a, real=real, name=name):
            calls.append(name)
            return real(*a)

        monkeypatch.setattr(encdec, name, counted)
    _, tc, _, model = _pair()
    toks, frames = _inputs(tc, seed=2)
    batch = {"tokens": _t(toks), "labels": _t(toks), "prefix_embeds": _t(frames)}
    loss, _ = api.loss_fn(model, dataclasses.replace(tc, remat=True), batch)
    assert calls.count("_enc_layer") == 2 and calls.count("_dec_layer") == 2
    loss.backward()
    model.zero_grad(set_to_none=True)
    assert calls.count("_enc_layer") == 4 and calls.count("_dec_layer") == 4


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [32, 8])
def test_prefill_cross_then_decode_matches_reference_and_forward(cache_len):
    """The encoder once, its cross K/V in the cache, then the tokens one by
    one: the logits against the reference's decode and the port's own
    forward at every position (a ring of 8 wraps past position 7, where
    the forward, which sees every token, parts from it)."""
    jc, tc, params, model = _pair()
    toks, frames = _inputs(tc, seed=4)
    with torch.no_grad():
        fwd = model(_t(toks), _t(frames))
    jcache = jed.prefill_cross(params, jc, jed.init_cache(jc, B, cache_len), jnp.asarray(frames))
    cache = api.init_cache(tc, B, cache_len, device=CPU)
    assert cache["layers"]["cross_k"].shape == (tc.num_layers, B, tc.num_prefix,
                                                tc.num_heads, tc.head_dim)
    cache = encdec.prefill_cross(model, tc, cache, _t(frames))
    for part in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache["layers"][part].numpy(),
                                   np.asarray(jcache["layers"][part]), atol=1e-5, rtol=0)
    step = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    for t in range(S):
        lj, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        lt, cache = api.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        assert lt.shape == (B, 1, tc.vocab_size) and int(cache["pos"]) == t + 1
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0,
                                   err_msg=f"against the reference at t={t}")
        if t < cache_len:
            np.testing.assert_allclose(lt[:, 0].numpy(), fwd[:, t].numpy(), atol=ATOL, rtol=0,
                                       err_msg=f"against forward at t={t}")
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(jcache["kpos"]))


def test_decode_resumes_from_a_reference_cache():
    jc, tc, params, model = _pair()
    toks, frames = _inputs(tc, seed=5)
    jcache = jed.prefill_cross(params, jc, jed.init_cache(jc, B, 16), jnp.asarray(frames))
    step = jax.jit(lambda p, c, t: jed.decode_step(p, jc, c, t))
    for t in range(3):
        _, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
    cache = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), CPU)
    assert set(cache["layers"]) == {"k", "v", "cross_k", "cross_v"} and int(cache["pos"]) == 3
    for t in range(3, 6):
        lj, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        lt, cache = encdec.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)


def test_decode_reads_nothing_on_the_host(monkeypatch):
    """The position comes from the cache's device ``pos``: a decode step
    calls no ``.item()`` / ``.tolist()``."""
    _, tc, _, model = _pair()
    toks, frames = _inputs(tc, seed=6)
    cache = encdec.prefill_cross(model, tc, api.init_cache(tc, B, 8, device=CPU), _t(frames))

    def refuse(*a, **k):
        raise AssertionError("a host read in decode")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    api.decode_step(model, tc, cache, _t(toks[:, :1]))


def test_generate_sampled_matches_reference_bit_for_bit():
    jc, tc, params, model = _pair()
    toks, frames = _inputs(tc, s=4, seed=7)
    key = jax.random.PRNGKey(9)
    want = JEngine(jc, params, cache_len=32).generate(
        jnp.asarray(toks), max_new_tokens=6, temperature=0.8, key=key,
        prefix_embeds=jnp.asarray(frames))
    got = ServeEngine(tc, model, cache_len=32).generate(
        _t(toks), max_new_tokens=6, temperature=0.8, key=key_from_numpy(np.asarray(key), CPU),
        prefix_embeds=_t(frames))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_greedy_is_repeatable_and_needs_frames():
    _, tc, _, model = _pair()
    toks, frames = _inputs(tc, s=4, seed=8)
    eng = ServeEngine(tc, model, cache_len=32)
    a = eng.generate(_t(toks), max_new_tokens=5, prefix_embeds=_t(frames))
    assert torch.equal(a, eng.generate(_t(toks), max_new_tokens=5, prefix_embeds=_t(frames)))
    with pytest.raises(ValueError, match="frame embeddings"):
        eng.generate(_t(toks), max_new_tokens=2)


# --------------------------------------------------------------------------
# bf16 blocks against the reference's strict compile
# --------------------------------------------------------------------------

def _bf16(a) -> torch.Tensor:
    words = np.array(np.asarray(a)).view(np.int16)
    return torch.from_numpy(words).view(torch.bfloat16)


def _f32(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def test_bf16_encoder_and_decoder_blocks_match_the_reference():
    """Each bf16 block fed the reference's own bf16 input: the encoder
    layers (bidirectional), then the decoder layers over the reference's
    bf16 encoder output."""
    jc = dataclasses.replace(j_get_arch(ARCH).reduced(), param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_arch(ARCH).reduced(), param_dtype=torch.bfloat16)
    params = japi.init_params(jax.random.PRNGKey(3), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    toks, frames = _inputs(tc, seed=9)
    P = tc.num_prefix
    layer = lambda tree, i: jax.tree_util.tree_map(lambda a: a[i], tree)

    def enc_block(x, p):           # the body of the reference's encode scan
        h = jrms(x, p["attn_norm"])
        out, _ = jattn.gqa_attention(p["attn"], jc, h, jnp.arange(P) * 0 + (P - 1), window=0,
                                     chunk=jc.attn_chunk)
        x = x + out
        return x + jmlp(p["ffn"], jrms(x, p["ffn_norm"]))

    def dec_block(x, p, mem):      # the body of the reference's forward scan
        h = jrms(x, p["attn_norm"])
        out, _ = jattn.gqa_attention(p["attn"], jc, h, jnp.arange(S), chunk=jc.attn_chunk)
        x = x + out
        h = jrms(x, p["cross_norm"])
        k, v = jed.cross_kv(p["cross"], jc, mem)
        x = x + jed.cross_attention(p["cross"], jc, h, k, v)
        return x + jmlp(p["ffn"], jrms(x, p["ffn_norm"]))

    rows = exact = 0

    def check(got, want, what):
        nonlocal rows, exact
        g, w = _f32(got), _f32(want)
        gap = float(np.abs(g - w).max()) / float(np.abs(w).max())
        assert got.dtype == torch.bfloat16 and gap <= BLOCK_TOL, f"{what}: {gap:.3e}"
        same = np.all(g == w, axis=-1)
        rows, exact = rows + same.size, exact + int(same.sum())

    x = jnp.asarray(frames).astype(jnp.bfloat16) + params["enc_pos_embed"][None, :P]
    fwd = _strict(enc_block, x, layer(params["enc_layers"], 0))
    with torch.no_grad():
        for i, p_t in enumerate(model.enc_layers):
            y = fwd(x, layer(params["enc_layers"], i))
            check(encdec._enc_layer(tc, _bf16(x), p_t), y, f"encoder layer {i}")
            x = y
    mem = jrms(x, params["enc_final_norm"])
    x = params["embed"][toks] + params["pos_embed"][jnp.arange(S)][None]
    fwd = _strict(dec_block, x, layer(params["layers"], 0), mem)
    with torch.no_grad():
        for i, p_t in enumerate(model.layers):
            y = fwd(x, layer(params["layers"], i), mem)
            check(encdec._dec_layer(tc, _bf16(x), p_t, torch.arange(S), _bf16(mem)), y,
                  f"decoder layer {i}")
            x = y
    assert exact >= EXACT_ROWS * rows, f"{exact} of {rows} rows bit for bit"


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_float32_checkpoint_crosses_both_ways_byte_for_byte(tmp_path):
    """The reference's reduced float32 train state through its
    ``save_checkpoint``, read by the port and written again: every array
    the same bytes; and the port's file read by the reference's
    ``load_checkpoint`` into the same leaves."""
    jc, tc = j_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jstate = jtrainer.train_state_init(jax.random.PRNGKey(2), jc)
    jpath = str(tmp_path / "ref")
    jckpt.save_checkpoint(jpath, jstate, step=4)
    like = train_state_init(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    restored, step_no = load_checkpoint(jpath, like)
    assert step_no == 4
    path = str(tmp_path / "port")
    save_checkpoint(path, restored, step=4)
    with np.load(os.path.join(path, "step00000004.npz")) as a, \
            np.load(os.path.join(jpath, "step00000004.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("params|enc_layers|") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    back, step_back = jckpt.load_checkpoint(path, jstate)
    assert step_back == 4
    for (pa, va), (pb, vb) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                  jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert pa == pb and np.asarray(va).tobytes() == np.asarray(vb).tobytes(), pa


def test_params_round_trip_through_numpy():
    _, tc, params, model = _pair()
    back = lm_params_to_numpy(model)
    assert set(back) == set(params) and set(back["enc_layers"]) == set(params["enc_layers"])
    for (pa, va), (pb, vb) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                  jax.tree_util.tree_flatten_with_path(params)[0]):
        assert pa == pb
        np.testing.assert_array_equal(va, np.asarray(vb))
