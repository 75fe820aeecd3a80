"""The port's attention-free mixers (``repro_torch.models.ssm``) against
the reference's ``repro.models.ssm`` on the CPU, float32, from the same
numpy weights (the reference's init, copied) and inputs made from a seed.

Tolerances (float32; measured in brackets):

* ``_chunked_wkv`` in both packages against a serial recurrence written
  here in float64, ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``y_t =
  r_t^T (S_{t-1} + diag(u) k_t v_t^T)``, and port against reference: y and
  the final state within ``WKV_TOL`` = 2e-6 of the serial y's largest
  |y|, 15 to 45 here (port 7.8e-6 absolute at chunk 16, 5.2e-7 of it;
  reference 4.9e-6; port against reference 8.1e-6).
* ``rwkv6_mixer`` and ``mamba_mixer``, out and state, port against
  reference: ``atol=1e-5``, the outputs' largest |y| 2 to 3 (rwkv 1.9e-6
  and its state 3.3e-6; mamba 1.5e-6 and its state 6.0e-7).
* Carried step by step at ``chunk=1`` against the chunked pass, in the
  port: ``atol=1e-5`` (rwkv 8.3e-7, mamba 4.8e-7).
* The mixers' gradients (input and every parameter, for one cotangent)
  against ``jax.grad`` of the reference's: within ``1e-4`` of the leaf's
  largest |g|, as the models' gradients are held (rwkv 9.3e-7; mamba
  1.4e-6, and 1.1e-5 on the scalar ``dt_bias``, a sum over every token).
* The Mamba chunk's scan (``_linear_scan``) is the odd/even recursion of
  ``jax.lax.associative_scan``: against jax's on the same inputs
  ``rtol=1e-6`` (bit for bit at every length tried: the same combines in
  the same order).
* ``softplus`` against ``jax.nn.softplus`` over [-30, 30]: ``rtol=1e-6``
  (1.7e-7; 94 % of the values bit for bit: ``torch.log1p`` is not XLA's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.models import ssm

CPU = torch.device("cpu")
ATOL = 1e-5
WKV_TOL = 2e-6


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfgs(arch, **replace):
    return (dataclasses.replace(j_get_arch(arch).reduced(), **replace),
            dataclasses.replace(get_arch(arch).reduced(), **replace))


def _module(kind, tc, jparams):
    """The port's module of ``kind`` holding the reference's parameters."""
    mod = {"rwkv": ssm.init_rwkv6, "mamba": ssm.init_mamba}[kind](tc, device="meta")
    mod = mod.to_empty(device=CPU)
    names = dict(mod.named_parameters())
    assert names.keys() == jparams.keys()
    for name, p in names.items():
        p.data.copy_(_t(jparams[name]))
    return mod


def _serial_wkv(r, k, v, logw, u, s0):
    """The WKV6 recurrence one token at a time, float64."""
    r, k, v, w, u, S = (np.asarray(a, np.float64) for a in (r, k, v, np.exp(logw), u, s0))
    B, T, H, hd = r.shape
    y = np.zeros((B, T, H, hd))
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                 # (B,H,hd,hd)
        y[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv)
        S = w[:, t, :, :, None] * S + kv
    return y, S


def _wkv_inputs(seed, B=2, S=16, H=2, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32) for _ in range(3))
    logw = -rng.uniform(0.0, ssm.DECAY_CLAMP, (B, S, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_chunked_wkv_matches_the_serial_recurrence(chunk):
    args = _wkv_inputs(chunk)
    y_ref, s_ref = _serial_wkv(*args)
    y_t, s_t = ssm._chunked_wkv(*(_t(a) for a in args), chunk)
    y_j, s_j = jssm._chunked_wkv(*(jnp.asarray(a) for a in args), chunk)
    assert y_t.dtype == s_t.dtype == torch.float32
    tol = WKV_TOL * np.abs(y_ref).max()
    for got in ((y_t.numpy(), s_t.numpy()), (np.asarray(y_j), np.asarray(s_j))):
        np.testing.assert_allclose(got[0], y_ref, rtol=0, atol=tol)
        np.testing.assert_allclose(got[1], s_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=tol)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=tol)


def test_chunked_wkv_refuses_unequal_chunks():
    """7 positions at chunk 2 are 3 chunks of 2 and one left over: the
    reference's reshape fails there too."""
    args = [_t(a) for a in _wkv_inputs(0, S=7)]
    with pytest.raises(ValueError, match="do not split"):
        ssm._chunked_wkv(*args, 2)
    _, tc, _, mod = _mamba()
    with pytest.raises(ValueError, match="do not split"):
        ssm.mamba_mixer(mod, tc, torch.zeros(1, 7, tc.d_model), chunk=2)


def test_softplus_is_jax_softplus():
    x = np.linspace(-30.0, 30.0, 20001, dtype=np.float32)
    got = ssm.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 32])
def test_linear_scan_is_jax_associative_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.2, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def comb(l, r):
        return l[0] * r[0], r[1] + r[0] * l[1]

    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = ssm._linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
    h = np.zeros((2, 3, 4), np.float64)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(tb[:, -1].numpy(), h, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# the mixers against the reference's
# --------------------------------------------------------------------------

def _rwkv(seed=0, **replace):
    jc, tc = _cfgs("rwkv6-3b", **replace)
    jp = jssm.init_rwkv6(jax.random.PRNGKey(seed), jc)
    # a data-dependent decay and a bonus that are not the init's constants
    rng = np.random.default_rng(seed + 1)
    jp = dict(jp, decay_base=jnp.asarray(rng.uniform(-2.0, 1.0, jc.d_model), jnp.float32),
              bonus_u=jnp.asarray(rng.standard_normal(jp["bonus_u"].shape), jnp.float32))
    return jc, tc, jp, _module("rwkv", tc, jp)


def _mamba(seed=0, **replace):
    jc, tc = _cfgs("hymba-1.5b", **replace)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jc)
    jp = dict(jp, dt_bias=jnp.asarray([-1.5], jnp.float32))
    return jc, tc, jp, _module("mamba", tc, jp)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mixer_matches_reference(with_state):
    jc, tc, jp, mod = _rwkv()
    x = _x(tc, 2, 16, 3)
    state = None
    if with_state:
        rng = np.random.default_rng(4)
        H, hd = tc.num_heads, tc.d_model // tc.num_heads
        state = {"wkv": rng.standard_normal((2, H, hd, hd)).astype(np.float32),
                 "shift": rng.standard_normal((2, tc.d_model)).astype(np.float32)}
    jout, jst = jssm.rwkv6_mixer(jp, jc, jnp.asarray(x), None if state is None else
                                 {k: jnp.asarray(v) for k, v in state.items()}, chunk=4)
    tout, tst = ssm.rwkv6_mixer(mod, tc, _t(x), None if state is None else
                                {k: _t(v) for k, v in state.items()}, chunk=4)
    assert tst.keys() == jst.keys() == {"wkv", "shift"}
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tst["wkv"].numpy(), np.asarray(jst["wkv"]), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tst["shift"].numpy(), x[:, -1])


def test_rwkv6_decode_steps_equal_the_chunked_mixer():
    """Token by token at chunk 1 with the carried state is the chunked pass."""
    _, tc, _, mod = _rwkv(seed=2)
    x = _t(_x(tc, 2, 8, 5))
    full, fst = ssm.rwkv6_mixer(mod, tc, x, chunk=4)
    st, outs = None, []
    for t in range(8):
        o, st = ssm.rwkv6_mixer(mod, tc, x[:, t:t + 1], st, chunk=1)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st["wkv"].numpy(), fst["wkv"].numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk,with_state", [(4, False), (8, False), (4, True)])
def test_mamba_mixer_matches_reference(chunk, with_state):
    jc, tc, jp, mod = _mamba()
    x = _x(tc, 2, 8, 6)
    h0 = None
    if with_state:
        h0 = np.random.default_rng(7).standard_normal(
            (2, tc.mamba_d_inner, tc.ssm_state)).astype(np.float32)
    jout, jh = jssm.mamba_mixer(jp, jc, jnp.asarray(x), None if h0 is None else jnp.asarray(h0),
                                chunk=chunk)
    tout, th = ssm.mamba_mixer(mod, tc, _t(x), None if h0 is None else _t(h0), chunk=chunk)
    assert th.dtype == torch.float32 and th.shape == (2, tc.mamba_d_inner, tc.ssm_state)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=ATOL)


def test_mamba_chunked_equals_stepwise():
    """The chunked scan against ``chunk=1`` carried step by step, in both
    packages."""
    jc, tc, jp, mod = _mamba(seed=1)
    x = _x(tc, 2, 12, 8)
    full, hf = ssm.mamba_mixer(mod, tc, _t(x), chunk=4)
    jfull, jhf = jssm.mamba_mixer(jp, jc, jnp.asarray(x), chunk=4)
    h, jh, outs, jouts = None, None, [], []
    for t in range(12):
        o, h = ssm.mamba_mixer(mod, tc, _t(x[:, t:t + 1]), h, chunk=1)
        jo, jh = jssm.mamba_mixer(jp, jc, jnp.asarray(x[:, t:t + 1]), jh, chunk=1)
        outs.append(o.numpy())
        jouts.append(np.asarray(jo))
    np.testing.assert_allclose(np.concatenate(outs, 1), full.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), hf.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.concatenate(jouts, 1), np.asarray(jfull), rtol=0, atol=ATOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_mixer_gradients_match_reference(kind):
    jc, tc, jp, mod = _rwkv() if kind == "rwkv" else _mamba()
    jfn, tfn = ((jssm.rwkv6_mixer, ssm.rwkv6_mixer) if kind == "rwkv"
                else (jssm.mamba_mixer, ssm.mamba_mixer))
    x = _x(tc, 2, 16, 9)
    ct = _x(tc, 2, 16, 10)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jfn(p, jc, x, chunk=4)[0] * ct),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    with torch.enable_grad():
        (tfn(mod, tc, xt, chunk=4)[0] * _t(ct)).sum().backward()
    got = dict(mod.named_parameters())
    for name, want in list(jg[0].items()) + [("x", jg[1])]:
        g = (xt if name == "x" else got[name]).grad.numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=name)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_init_names_shapes_and_float32_leaves(kind):
    """The reference's names, shapes and dtypes, in bf16 with its float32
    leaves, and the init's constants."""
    arch = "rwkv6-3b" if kind == "rwkv" else "hymba-1.5b"
    jc, tc = _cfgs(arch)
    jc, tc = (dataclasses.replace(jc, param_dtype=jnp.bfloat16),
              dataclasses.replace(tc, param_dtype=torch.bfloat16))
    jinit = jssm.init_rwkv6 if kind == "rwkv" else jssm.init_mamba
    tinit = ssm.init_rwkv6 if kind == "rwkv" else ssm.init_mamba
    jp = jinit(jax.random.PRNGKey(0), jc)
    mod = tinit(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1]) for n, p in mod.named_parameters()}
    want = {n: (tuple(a.shape), str(a.dtype)) for n, a in jp.items()}
    assert got == want
    f32 = {n for n, p in mod.named_parameters() if p.dtype == torch.float32}
    assert f32 == ({"decay_base", "bonus_u"} if kind == "rwkv" else {"dt_bias", "A_log", "D"})
    for n, p in mod.named_parameters():
        if p.dim() == 1 or n in ("bonus_u", "A_log"):
            np.testing.assert_array_equal(p.float().numpy(), np.asarray(jp[n], np.float32),
                                          err_msg=n)
        else:
            assert float(p.float().std()) > 0, n


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.init_rwkv6(get_arch("rwkv6-3b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.init_mamba(get_arch("hymba-1.5b").reduced())
