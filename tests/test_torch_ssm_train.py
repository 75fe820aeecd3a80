"""The port's train step on the SSM and hybrid families — reduced
``rwkv6-3b`` and ``hymba-1.5b``, float32 — against the reference's
``make_train_step`` on the CPU, one step per selector mode, both started
from one state (``convert.train_state_from_numpy`` of the reference's
``train_state_init``) and fed the same tokens and key.

Held as ``tests/test_torch_train.py`` holds llama (measured in brackets):
the selected rows exactly (``coreset`` fed the reference's scores
through the trainer's ``local_scores`` seam); loss and ``ce``
``rtol=1e-5``; parameters within 2 lr + 1e-5 of the reference's with at
most 0.5 % of a leaf beyond 1e-5 (AdamW moves an element by about lr
whatever its gradient's size); both moments within 1e-4 of the leaf's
largest (rwkv: m 4.5e-6, v 9.0e-6; hymba: m 3.6e-5, v 7.1e-5, the
squared gradients twice the gradients' 2e-5 relative spread through the
model, ``tests/test_torch_ssm_lm.py``); loss 7.0e-8.
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
from repro.optim import schedules as jsched
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import (
    key_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.core.selector import SelectorConfig
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, trainer

CPU = "cpu"
ARCHS = ["rwkv6-3b", "hymba-1.5b"]
LR = 1e-3
B, S = 8, 16
FRACTION = 0.5


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


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# one step per selector mode against the reference
# --------------------------------------------------------------------------

_STATES = {}


def _reference_state(jc):
    """The reference's ``train_state_init`` of ``jc`` at PRNGKey(6), once."""
    if jc not in _STATES:
        _STATES[jc] = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(6))
    return _STATES[jc]


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in ("none", "uniform", "coreset")])
def test_train_step_matches_reference(arch, mode, monkeypatch):
    jc, tc = _cfgs(arch)
    js = _reference_state(jc)
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), tc, CPU)
    toks, labels = _tokens(tc, B, S, seed=6), _tokens(tc, B, S, seed=7)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    key = jax.random.PRNGKey(7)
    m = round(FRACTION * B)
    jidx = None
    if mode == "uniform":
        jidx, _ = jdis.uniform_plan(key, B, m)
    elif mode == "coreset":
        g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
        jidx, _ = jsel.sample_coreset(key, g, m)
        monkeypatch.setattr(trainer, "local_scores", lambda f, s, r: _t(g))
    rows = []
    real_select = trainer._select_rows
    monkeypatch.setattr(trainer, "_select_rows",
                        lambda b, i: rows.append(i) or real_select(b, i))
    sel = jsel.SelectorConfig(mode=mode, fraction=FRACTION)
    js2, jm = jax.jit(jtrainer.make_train_step(jc, jsched.constant(LR), sel))(js, jb, key)
    tsel = None if mode == "none" else SelectorConfig(mode=mode, fraction=FRACTION)
    _, tm = make_train_step(tc, constant(LR), tsel)(
        ts, {"tokens": _t(toks), "labels": _t(labels)}, key_from_numpy(np.asarray(key), CPU))
    assert [r.tolist() for r in rows] == ([] if jidx is None else [np.asarray(jidx).tolist()])
    for name in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    got = train_state_to_numpy(ts)
    tp, jp = _flat(got["params"]), _flat(js2["params"])
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2 * LR + 1e-5 and (d > 1e-5).mean() <= 0.005, (k, d.max())
    for part in ("m", "v"):
        tm_, jm_ = _flat(got["opt"][part]), _flat(js2["opt"][part])
        for k in jm_:
            np.testing.assert_allclose(tm_[k], jm_[k], rtol=0, atol=1e-4 * np.abs(jm_[k]).max(),
                                       err_msg=f"{part} {k}")


