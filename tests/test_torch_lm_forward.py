"""The port's LM forward, logits and loss (``repro_torch.models.lm``) on
the dense, qk-norm, untied, padded-vocabulary, windowed, learned-position
and VLM-prefix configs, against the reference on the CPU from the same
numpy weights (``convert.lm_params_from_numpy`` of the reference's init)
and tokens.

Tolerances: logits and hidden states ``atol=1e-4`` (float32 at the
reduced widths, max |logit| about 4); the losses ``rtol=1e-5``.
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
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import api, lm

CPU = "cpu"
ATOL = 1e-4


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
# forward, logits, loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,replace", [
    ("llama3.2-1b", {}), ("qwen3-14b", {}), ("starcoder2-3b", {}), ("phi3-medium-14b", {}),
    ("llama3.2-1b", {"vocab_size": 500}), ("starcoder2-3b", {"tie_embeddings": False,
                                                             "vocab_size": 500}),
    ("llama3.2-1b", {"sliding_window": 4}), ("llama3.2-1b", {"learned_pos": 64})])
def test_forward_logits_loss_match_reference(arch, replace):
    jc, tc, params, model = _pair(arch, **replace)
    B, S = 2, 16
    toks = _tokens(tc, B, S)
    labels = _tokens(tc, B, S, seed=1)
    h_j, _ = jlm.forward(params, jc, jnp.asarray(toks))
    lj = np.asarray(jlm.logits_of(params, jc, h_j))
    h_t, aux = lm.forward(model, tc, _t(toks))
    lt = lm.logits_of(model, tc, h_t)
    assert float(aux) == 0.0 and lt.dtype == torch.float32
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy(), lj, atol=ATOL, rtol=0)
    assert torch.equal(model(_t(toks)), lt)
    if tc.vocab_pad != tc.vocab_size:
        assert tc.vocab_pad == 512 and bool((lt[..., tc.vocab_size:] == -1e30).all())
    w = np.asarray([0.25, 1.75], np.float32)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": _t(toks), "labels": _t(labels)}
    for ew in (None, w):
        tot_j, m_j = japi.loss_fn(params, jc, batch_j,
                                  example_weights=None if ew is None else jnp.asarray(ew))
        tot_t, m_t = api.loss_fn(model, tc, batch_t,
                                 example_weights=None if ew is None else _t(ew))
        np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
        np.testing.assert_allclose(float(m_t["ce"]), float(m_j["ce"]), rtol=1e-5)
    assert torch.equal(api.forward_hidden(model, tc, batch_t), h_t)


def test_vlm_prefix_embeds_match_reference():
    jc, tc, params, model = _pair("internvl2-26b")
    B, S = 2, 8
    toks, labels = _tokens(tc, B, S), _tokens(tc, B, S, seed=1)
    prefix = np.random.default_rng(3).standard_normal((B, tc.num_prefix, tc.d_model)).astype(
        np.float32)
    h_j, _ = jlm.forward(params, jc, jnp.asarray(toks), jnp.asarray(prefix))
    h_t, _ = lm.forward(model, tc, _t(toks), _t(prefix))
    assert h_t.shape == (B, tc.num_prefix + S, tc.d_model)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL, rtol=0)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
               "prefix_embeds": jnp.asarray(prefix)}
    batch_t = {"tokens": _t(toks), "labels": _t(labels), "prefix_embeds": _t(prefix)}
    tot_j, _ = japi.loss_fn(params, jc, batch_j)
    tot_t, _ = api.loss_fn(model, tc, batch_t)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=1e-5)
    hid_t = api.forward_hidden(model, tc, batch_t)
    assert hid_t.shape == (B, S, tc.d_model)
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(japi.forward_hidden(params, jc, batch_j)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(model(_t(toks), _t(prefix)).numpy(),
                               np.asarray(jlm.logits_of(params, jc, h_j[:, tc.num_prefix:])),
                               atol=ATOL, rtol=0)
