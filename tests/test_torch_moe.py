"""The port's mixture-of-experts layers (``repro_torch.models.moe``)
against the reference on the CPU, from the same numpy weights and inputs:
``moe_ffn`` in both dispatch forms, with and without dropped tokens, the
MoE init and parameter counts, and the converters with the ``moe`` leaves.
``tests/test_torch_moe_lm.py`` holds the reduced ``granite-moe-3b-a800m``
model, ``tests/test_torch_mla.py`` the reduced ``deepseek-v2-236b``.

Tolerances (float32; measured in brackets): ``moe_ffn``'s output and the
input's gradient ``atol=1e-5`` (1.0e-6), aux ``rtol=1e-6``, the parameters'
gradients within ``1e-4`` of each leaf's largest |g| (5.5e-6); the expert
ids exactly (asserted before any output is compared: ``torch.topk`` and
``jax.lax.top_k`` could order ties differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import api, moe

CPU = "cpu"
ARCH = "granite-moe-3b-a800m"


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
# moe_ffn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["kloop", "einsum"])
@pytest.mark.parametrize("capacity", [1.0, 8.0])
def test_moe_ffn_matches_reference(dispatch, capacity):
    jc, tc = _cfgs(moe_dispatch=dispatch)
    assert (tc.num_experts, tc.num_experts_per_tok) == (4, 2)
    p = jmoe.init_moe(jax.random.PRNGKey(1), jc)
    m = moe.init_moe(tc, device="meta").to_empty(device=CPU)
    with torch.no_grad():
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(m, k).copy_(_t(p[k]))
    assert m.router.dtype == torch.float32
    x = np.random.default_rng(0).standard_normal((2, 16, tc.d_model)).astype(np.float32)
    probe = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    # the expert ids first
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(1, 32, -1) @ p["router"], axis=-1)
    _, jids = jax.lax.top_k(jprobs, jc.num_experts_per_tok)
    _, _, tids = moe.route(m, tc, _t(x).reshape(1, 32, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    counts = np.bincount(np.asarray(jids).ravel(), minlength=4)
    C = int(np.ceil(32 * 2 / 4 * capacity))
    assert (counts.max() > C) == (capacity == 1.0)       # 1.0 drops tokens, 8.0 none

    def jf(params, xx):
        out, aux = jmoe.moe_ffn(params, jc, xx, capacity)
        return jnp.sum(out * probe) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        p, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out, aux = moe.moe_ffn(m, tc, xt, capacity)
    (torch.sum(out * _t(probe)) + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0, atol=1e-5)
    for k in ("router", "w_gate", "w_up", "w_down"):
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(getattr(m, k).grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_moe_aux_counts_the_chosen_experts_without_gradient():
    """aux = E * sum(me * ce): ce (the chosen experts' share) carries no
    gradient, me (the mean router probability) does."""
    _, tc = _cfgs()
    m = moe.init_moe(tc, torch.Generator().manual_seed(0), device=CPU)
    x = torch.randn(1, 8, tc.d_model, generator=torch.Generator().manual_seed(1))
    _, aux = moe.moe_ffn(m, tc, x)
    probs, _, ids = moe.route(m, tc, x.reshape(1, 8, -1))
    ce = torch.bincount(ids.reshape(-1), minlength=4).float() / (8 * 2)
    me = probs.reshape(8, 4).mean(0)
    assert torch.allclose(aux, 4 * torch.sum(me * ce.detach()))
    (g,) = torch.autograd.grad(aux, m.router)
    (want,) = torch.autograd.grad(4 * torch.sum(me * ce.detach()), m.router)
    assert torch.allclose(g, want)


def test_pick_group_and_one_hot_out_of_range():
    assert moe._pick_group(4, 256) == 4 and moe._pick_group(2048, 256) == 256
    assert moe._pick_group(24, 256) == 24 and moe._pick_group(300, 256) == 150
    oh = moe._one_hot(torch.tensor([0, 2, 3, 5]), 3, torch.float32)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(
        jax.nn.one_hot(jnp.asarray([0, 2, 3, 5]), 3)))


# --------------------------------------------------------------------------
# init, converters, counts, the families still waiting
# --------------------------------------------------------------------------

def test_init_params_tree_and_counts_match_reference():
    jc, tc = _cfgs()
    ref = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
    model = api.init_params(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    flat_r = {jax.tree_util.keystr(p): (l.shape, str(l.dtype))
              for p, l in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_t = {jax.tree_util.keystr(p): (l.shape, str(l.dtype))
              for p, l in jax.tree_util.tree_flatten_with_path(lm_params_to_numpy(model))[0]}
    assert flat_t == flat_r
    jparams = jax.jit(lambda k: japi.init_params(k, jc))(jax.random.PRNGKey(0))
    assert api.param_count(model) == japi.param_count(jparams)
    assert api.active_param_count(tc, model) == japi.active_param_count(jc, jparams)
    assert api.active_param_count(tc, model) < api.param_count(model)
    w = model.layers[0].moe.w_down.detach()
    assert float(w.abs().max()) <= 3 / np.sqrt(tc.moe_d_ff) * (1 + 1e-6)


def test_published_granite_on_meta():
    cfg = get_arch(ARCH)
    model = api.init_params(cfg, device="meta")
    ref = jax.eval_shape(lambda k: japi.init_params(k, j_get_arch(ARCH)), jax.random.PRNGKey(0))
    want = sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(ref))
    assert api.param_count(model) == want
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.w_up.dtype == torch.bfloat16


def test_converters_carry_the_moe_leaves_in_bf16():
    jc, tc = _cfgs(param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    params = japi.init_params(jax.random.PRNGKey(1), jc)
    assert params["layers"]["moe"]["router"].dtype == jnp.float32
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    assert model.layers[1].moe.router.dtype == torch.float32
    assert model.layers[1].moe.w_gate.dtype == torch.bfloat16
    back = lm_params_to_numpy(model)
    for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = back
        for k in p:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf.astype(jnp.float32)))


def test_init_moe_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init_moe(_cfgs()[1])
