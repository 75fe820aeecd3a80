"""The port's training in bfloat16 (``param_dtype=torch.bfloat16``, the
dtype phases 17 and 18 of ``chip_smoke.py`` train in) against the
reference's bfloat16 training on the CPU, from the same bf16 weights and
tokens: reduced ``llama3.2-1b`` and reduced ``granite-moe-3b-a800m``
(``kloop`` and ``einsum`` dispatch).

The reference is compiled with ``xla_allow_excess_precision`` off, which
rounds every bf16 op as its eager evaluation does and as the port does.
Its default compile keeps float32 between fused bf16 ops; on reduced
granite that moves the router's input enough to flip a top-2 choice, and
its own default and strict steps then differ by 2.4e-3 in the loss and by
0.69 of a leaf's largest gradient.  Autograd and XLA still round the
backward pass at other points (the widened einsums, ``silu``'s four
steps), so gradients are held at bf16-scale bounds, taken from what this
file measured (in brackets):

* **One block's backward, op for op.**  Each block is fed the
  reference's own bf16 input and one bf16 cotangent, against ``jax.vjp``
  of the reference's block: the input's gradient and every parameter's
  (the float32 router's too) within ``BLOCK_TOL`` = 2**-6 of the leaf's
  largest |g| (1.08e-2).
* **One train step.**  The port's ``make_train_step`` against the
  reference's, from one bf16 state (``train_state_from_numpy`` of the
  reference's ``train_state_init``), one mode per case, the selected rows
  exactly (``coreset`` fed the reference's scores through the trainer's
  ``local_scores`` seam).  ``loss`` and ``ce`` within ``LOSS_RTOL`` = 2e-4
  (6.6e-5), ``aux`` within ``AUX_RTOL`` = 1e-3 (2.9e-5); the gradients the
  step hands AdamW within ``GRAD_TOL`` = 2**-5 of each leaf's largest |g|
  (1.43e-2) of ``jax.grad`` of the reference's ``loss_fn`` on the same
  rows, which is what its step differentiates (the step leaves them in
  ``.grad``); the parameters after the
  step within 2 lr + ``PARAM_ULPS`` bf16 ulps of the reference's (AdamW
  moves an element by about lr whatever its gradient's size; 2.44e-3 at
  lr 1e-3).
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
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import schedules as jsched
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import (
    _stacked,
    key_from_numpy,
    lm_params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.core.selector import SelectorConfig
from repro_torch.models import lm
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, trainer

CPU = "cpu"
BLOCK_TOL = 2.0 ** -6
LOSS_RTOL = 2e-4
AUX_RTOL = 1e-3
GRAD_TOL = 2.0 ** -5
PARAM_ULPS = 2
LR = 1e-3
B, S = 8, 16
FRACTION = 0.5
CASES = [("llama3.2-1b", {}, "none"),
         ("granite-moe-3b-a800m", {}, "coreset"),
         ("granite-moe-3b-a800m", {"moe_dispatch": "einsum"}, "uniform")]


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


def _cfgs(arch, **replace):
    return (dataclasses.replace(j_get_arch(arch).reduced(), param_dtype=jnp.bfloat16, **replace),
            dataclasses.replace(get_arch(arch).reduced(), param_dtype=torch.bfloat16, **replace))


def _bf16(a) -> torch.Tensor:
    """A jax bf16 array as a torch bf16 tensor, through its 16-bit words."""
    words = np.array(np.asarray(a)).view(np.int16)
    return torch.from_numpy(words).view(torch.bfloat16)


def _f32(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(p): _f32(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _strict(fn, *args):
    """``fn`` compiled for ``args``' shapes with every bf16 op rounded (no
    excess precision kept between fused ops)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _gap(got, want) -> float:
    """max |got - want| over the leaf's largest |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,replace", [(a, r) for a, r, _ in CASES])
def test_bf16_block_backward_matches_the_reference(arch, replace):
    jc, tc = _cfgs(arch, **replace)
    params = japi.init_params(jax.random.PRNGKey(3), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (2, S)).astype(np.int32)
    x = params["embed"][toks]
    layer = lambda i: jax.tree_util.tree_map(lambda a: a[i], params["layers"])
    block = lambda x, p: jlm._layer_fwd(jc, x, p, jnp.arange(S))[0]

    def pull(x, p, ct):
        return jax.vjp(block, x, p)[1](ct)

    cts = jax.random.normal(jax.random.PRNGKey(1), (jc.num_layers,) + x.shape, jnp.bfloat16)
    pull = _strict(pull, x, layer(0), cts[0])
    block = _strict(block, x, layer(0))
    for i, p_t in enumerate(model.layers):
        gx, gp = pull(x, layer(i), cts[i])
        xt = _bf16(x).requires_grad_(True)
        y, _ = lm._layer_fwd(tc, xt, p_t, torch.arange(S))
        y.backward(_bf16(cts[i]))
        gaps = {"x": _gap(xt.grad, gx)}
        for name, p in p_t.named_parameters():
            want = gp
            for part in name.split("."):
                want = want[part]
            gaps[name] = _gap(p.grad, want)
        bad = {k: v for k, v in gaps.items() if not v <= BLOCK_TOL}
        assert not bad, f"{arch} {replace} layer {i}: beyond {BLOCK_TOL}: {bad}"
        x = block(x, layer(i))


@pytest.mark.parametrize("arch,replace,mode", CASES)
def test_bf16_train_step_matches_the_reference(arch, replace, mode, monkeypatch):
    jc, tc = _cfgs(arch, **replace)
    js = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(6))
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), tc, CPU)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    key = jax.random.PRNGKey(7)

    # the reference: its step, and the gradient of its loss on its rows
    sel = jsel.SelectorConfig(mode=mode, fraction=FRACTION)
    jstep = jtrainer.make_train_step(jc, jsched.constant(LR), sel)
    js2, jm = _strict(jstep, js, jb, key)(js, jb, key)
    m = sel.m_of(B)
    idx = weights = None
    rows = jb
    if mode == "uniform":
        idx, weights = jdis.uniform_plan(key, B, m)
    elif mode == "coreset":
        g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
        idx, weights = jsel.sample_coreset(key, g, m)
        monkeypatch.setattr(trainer, "local_scores", lambda f, s, r: torch.from_numpy(np.array(g)))
    if idx is not None:
        rows = jtrainer._select_rows(jb, idx)
    jgrad = jax.grad(lambda p: japi.loss_fn(p, jc, rows, example_weights=weights)[0])
    jgrads = _strict(jgrad, js["params"])(js["params"])

    picked = []
    real_select = trainer._select_rows
    monkeypatch.setattr(trainer, "_select_rows",
                        lambda batch, i: picked.append(i) or real_select(batch, i))
    step = make_train_step(tc, constant(LR), None if mode == "none" else SelectorConfig(
        mode=mode, fraction=FRACTION))
    _, tm = step(ts, tb, key_from_numpy(np.asarray(key), CPU))

    assert [i.tolist() for i in picked] == ([] if idx is None else [np.asarray(idx).tolist()])
    for name in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL, err_msg=name)
    if tc.is_moe:
        assert float(tm["aux"]) > 0
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=AUX_RTOL)
    tg = _flat(_stacked((n, p.grad.float().numpy()) for n, p in ts["params"].named_parameters()))
    jg = _flat(jgrads)
    assert tg.keys() == jg.keys()
    worst = {k: _gap(tg[k], jg[k]) for k in jg}
    bad = {k: v for k, v in worst.items() if not v <= GRAD_TOL}
    assert not bad, f"{arch} {mode}: gradients beyond {GRAD_TOL} of a leaf's largest: {bad}"

    tp, jp = _flat(train_state_to_numpy(ts)["params"]), _flat(js2["params"])
    for k in jp:
        ulp = np.abs(jp[k]) * 2.0 ** -7                 # a bf16 ulp or more
        excess = np.abs(tp[k] - jp[k]) - (2 * LR + PARAM_ULPS * ulp)
        assert excess.max() <= 0, (k, float(excess.max()))
