"""The port's train step on the encoder-decoder (reduced ``whisper-medium``,
float32) against the reference's on the CPU, in each selector mode, from
one state (``convert.train_state_from_numpy`` of the reference's
``train_state_init``), the same ``TokenStream`` batch with frames from
numpy, and the same key.

The reference side is its loss and gradient (``jax.value_and_grad`` of
``models.api.loss_fn``, jitted) on the rows its own selection draws, then
its ``adamw_update``: the body of its ``make_train_step``.  Tolerances as
``tests/test_torch_train.py``: the loss ``rtol=1e-5``; gradients per leaf
within ``1e-4`` of its largest |g|; the selected rows and their weights
exactly (``coreset`` fed the reference's scores through the trainer's
``local_scores`` seam); parameters within ``2 lr + 1e-5`` with at most
0.5% of a leaf beyond ``1e-5`` (AdamW's first step moves an element by
about lr whatever its gradient's size); the moments within ``1e-4`` of a
leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import dis as jdis
from repro.core import selector as jsel
from repro.data.lm import TokenStream as JStream
from repro.models import api as japi
from repro.optim.adamw import adamw_update as j_adamw_update
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import key_from_numpy, train_state_from_numpy, train_state_to_numpy
from repro_torch.core.selector import SelectorConfig, local_scores
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, trainer

CPU = "cpu"
ARCH = "whisper-medium"
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


_REF = {}


def _reference():
    """(jax cfg, the reference's state, its numpy tree, the jitted
    value-and-grad), made once."""
    if not _REF:
        jc = j_get_arch(ARCH).reduced()
        js = jax.jit(lambda k: jtrainer.train_state_init(k, jc))(jax.random.PRNGKey(0))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, w: japi.loss_fn(p, jc, b, example_weights=w)[0]))
        _REF.update(jc=jc, js=js, tree=jax.tree_util.tree_map(np.asarray, js), vg=vg)
    return _REF["jc"], _REF["js"], _REF["tree"], _REF["vg"]


def _batch(jc, seed):
    jb = dict(next(iter(JStream(vocab=jc.vocab_size, seq_len=S, batch_size=B, seed=seed))))
    jb["prefix_embeds"] = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (B, jc.num_prefix, jc.d_model)).astype(np.float32))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mode", ["none", "uniform", "coreset"])
def test_train_step_matches_reference(mode, monkeypatch):
    jc, js, tree, vg = _reference()
    ts = train_state_from_numpy(tree, get_arch(ARCH).reduced(), CPU)
    tc = ts["params"].cfg
    jb, tb = _batch(jc, seed=3)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)

    # the reference's step body on its own selection
    idx = weights = g = None
    batch = jb
    m = round(FRACTION * B)
    if mode == "uniform":
        idx, weights = jdis.uniform_plan(key, B, m)
    elif mode == "coreset":
        g = jsel.local_scores(jtrainer._score_features(js["params"], jc, jb), "leverage", 1e-4)
        idx, weights = jsel.sample_coreset(key, g, m)
    if idx is not None:
        batch = jtrainer._select_rows(jb, idx)
    jloss, jgrads = vg(js["params"], batch, weights)
    jparams, jopt = j_adamw_update(js["params"], jgrads, js["opt"], jnp.float32(LR))

    # the port's step, fed the reference's scores, its rows recorded
    seen = []
    real_select = trainer._select_rows
    monkeypatch.setattr(trainer, "_select_rows",
                        lambda b, i: seen.append(i) or real_select(b, i))
    monkeypatch.setattr(trainer, "local_scores",
                        lambda feats, score, ridge: torch.from_numpy(np.array(g)))
    sel = None if mode == "none" else SelectorConfig(mode=mode, fraction=FRACTION)
    ts, tm = make_train_step(tc, constant(LR), sel)(ts, tb, key_from_numpy(np.asarray(key), CPU))

    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-5)
    assert float(tm["aux"]) == 0.0 and int(ts["step"]) == 1
    if mode == "none":
        assert seen == []
    else:
        assert len(seen) == 1 and seen[0].tolist() == np.asarray(idx).tolist()
    from repro_torch.convert import _stacked

    tg = _flat(_stacked((n, p.grad.numpy()) for n, p in ts["params"].named_parameters()))
    jg = _flat(jgrads)
    assert tg.keys() == jg.keys() and any("enc_layers" in k for k in jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=1e-4 * np.abs(jg[k]).max(),
                                   err_msg=k)
    tstate = train_state_to_numpy(ts)
    tp, jp = _flat(tstate["params"]), _flat(jparams)
    for k in jp:
        d = np.abs(tp[k] - jp[k])
        assert d.max() <= 2 * LR + 1e-5, (k, d.max())
        assert (d > 1e-5).mean() <= 0.005, (k, (d > 1e-5).mean())
    for part in ("m", "v"):
        tmom, jmom = _flat(tstate["opt"][part]), _flat(jopt[part])
        for k in jmom:
            np.testing.assert_allclose(tmom[k], jmom[k], rtol=0,
                                       atol=1e-4 * np.abs(jmom[k]).max(), err_msg=f"{part} {k}")


def test_coreset_step_scores_the_frames_too(monkeypatch):
    """The coreset features are the mean token embedding plus the mean
    frame, the reference's, under ``no_grad``."""
    jc, js, tree, _ = _reference()
    ts = train_state_from_numpy(tree, get_arch(ARCH).reduced(), CPU)
    jb, tb = _batch(jc, seed=4)
    feats = []
    monkeypatch.setattr(trainer, "local_scores",
                        lambda f, score, ridge: feats.append(f) or local_scores(f, score, ridge))
    make_train_step(ts["params"].cfg, constant(LR),
                    SelectorConfig(mode="coreset", fraction=FRACTION))(
        ts, tb, key_from_numpy(np.asarray(jax.random.PRNGKey(5)), CPU))
    assert len(feats) == 1 and not feats[0].requires_grad
    np.testing.assert_allclose(
        feats[0].numpy(), np.asarray(jtrainer._score_features(js["params"], jc, jb)),
        rtol=0, atol=1e-6)
