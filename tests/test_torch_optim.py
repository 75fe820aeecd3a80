"""The port's optimizers, LR schedules and tree helpers
(``repro_torch.optim``, ``repro_torch.utils.tree``) against the reference
on the CPU, fed the same numpy parameters, gradients and steps.

Tolerances:

- Schedules: ``rtol=1e-6`` (XLA's float32 ``cos`` against torch's);
  warm-up values and the floor exactly.
- ``adamw_update`` and ``sgd_update`` over three steps on identical
  gradients: float32 parameters and moments ``rtol=1e-6, atol=1e-7`` (the
  global norm sums the leaves in another order; ``b1 ** step`` is XLA's
  ``pow`` against torch's); bfloat16 parameters within one bfloat16 ulp
  (a float32 difference at a rounding boundary moves the cast by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro.utils import tree as jtree
from repro_torch.configs import get_arch
from repro_torch.models import api
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    constant,
    cosine_with_warmup,
    sgd_init,
    sgd_update,
)
from repro_torch.utils import tree

CPU = "cpu"


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


def _step(s):
    return torch.tensor(s, dtype=torch.int32)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total,floor", [
    (2e-3, 5, 50, 0.1), (1.0, 10, 100, 0.1), (3e-4, 0, 20, 0.0), (1e-3, 7, 7, 0.25)])
def test_cosine_with_warmup_matches_reference(peak, warmup, total, floor):
    jf = jsched.cosine_with_warmup(peak, warmup, total, floor)
    tf = cosine_with_warmup(peak, warmup, total, floor)
    steps = list(range(0, total + 15))
    want = np.array([float(jf(jnp.asarray(s, jnp.int32))) for s in steps], np.float32)
    got = [tf(_step(s)) for s in steps]
    assert all(g.shape == () and g.dtype == torch.float32 for g in got)
    got = np.array([float(g) for g in got], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the warm-up ramp and the floor past the end are the same float32 values
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    np.testing.assert_array_equal(got[total:], want[total:])


def test_schedule_values():
    """The reference's ``tests/test_trainer.py::test_schedule_values``."""
    sched = cosine_with_warmup(1.0, 10, 100, floor=0.1)
    assert float(sched(_step(0))) == 0.0
    assert abs(float(sched(_step(10))) - 1.0) < 1e-6
    assert float(sched(_step(100))) >= 0.099
    lr = constant(0.5)(_step(7))
    assert float(lr) == 0.5 and lr.dtype == torch.float32 and lr.shape == ()
    assert float(constant(2e-3)(_step(3))) == float(jsched.constant(2e-3)(jnp.asarray(3)))


# --------------------------------------------------------------------------
# AdamW and SGD on identical gradients
# --------------------------------------------------------------------------

SHAPES = {"a": (7, 5), "b": {"c": (3,), "d": (2, 4, 3)}, "e": (16,)}


def _tree_of(fn, shapes=SHAPES, path=""):
    if isinstance(shapes, dict):
        return {k: _tree_of(fn, v, f"{path}.{k}" if path else k) for k, v in shapes.items()}
    return fn(path, shapes)


def _leaves(rng, dtypes, scale=1.0):
    """(numpy params, three numpy gradient trees); leaf ``path`` in
    ``dtypes`` is bfloat16-valued (kept as float32 words exact in bf16)."""
    def draw(path, shape, s):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        if path in dtypes:
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a
    params = _tree_of(lambda p, s: draw(p, s, 1.0))
    grads = [_tree_of(lambda p, s: draw(p, s, scale)) for _ in range(3)]
    # near-zero gradients, where AdamW's m / (sqrt(v) + eps) is not +-1
    grads[0]["a"][0, :3] = [1e-9, -3e-10, 0.0]
    return params, grads


def _jax_tree(t, dtypes):
    return {k: (_jax_tree(v, {d[len(k) + 1:] for d in dtypes if d.startswith(k + ".")})
                if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in dtypes else jnp.float32))
            for k, v in t.items()}


def _named(t, dtypes, prefix=""):
    out = {}
    for k, v in t.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_named(v, dtypes, name))
        else:
            out[name] = torch.from_numpy(v.copy()).to(
                torch.bfloat16 if name in dtypes else torch.float32)
    return out


def _assert_tree_close(named, jt, dtypes, prefix=""):
    for k, v in jt.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _assert_tree_close(named, v, dtypes, name)
            continue
        got = named[name]
        want = np.asarray(v.astype(jnp.float32))
        if name in dtypes:
            assert got.dtype == torch.bfloat16
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(got.float().numpy() - want) <= ulp), name
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])     # clip idle / clip active
@pytest.mark.parametrize("bf16", [(), ("a", "b.d")])
def test_adamw_update_matches_reference(grad_scale, bf16):
    params, grads = _leaves(np.random.default_rng(0), set(bf16), grad_scale)
    jp = _jax_tree(params, set(bf16))
    jstate = jadamw.adamw_init(jp)
    tp = _named(params, set(bf16))
    tstate = adamw_init(tp)
    assert set(tstate["m"]) == set(tp) and tstate["step"].dtype == torch.int32
    assert all(m.dtype == torch.float32 and not m.any() for m in tstate["m"].values())
    for i, g in enumerate(grads):
        lr = 1e-3 * (i + 1)
        jg = _jax_tree(g, set(bf16))
        jp, jstate = jadamw.adamw_update(jp, jg, jstate, jnp.float32(lr), weight_decay=0.1)
        tg = _named(g, set(bf16))
        before = {k: v.data_ptr() for k, v in tp.items()}
        out, tstate = adamw_update(tp, tg, tstate, torch.tensor(lr, dtype=torch.float32),
                                   weight_decay=0.1)
        assert out is tp and all(v.data_ptr() == before[k] for k, v in tp.items())
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        _assert_tree_close(tp, jp, set(bf16))
        _assert_tree_close(tstate["m"], jstate["m"], set())
        _assert_tree_close(tstate["v"], jstate["v"], set())


def test_adamw_clip_scale_is_the_global_norm():
    from repro_torch.optim.adamw import clip_scale

    g = {"x": torch.full((4,), 3.0), "y": torch.full((9,), 2.0, dtype=torch.bfloat16)}
    assert float(clip_scale(g, 1.0)) == pytest.approx(1 / np.sqrt(4 * 9 + 9 * 4), rel=1e-6)
    assert float(clip_scale(g, 100.0)) == 1.0
    zero = {"x": torch.zeros(3)}
    assert float(clip_scale(zero, 1.0)) == 1.0


def test_sgd_update_matches_reference():
    params, grads = _leaves(np.random.default_rng(1), {"e"})
    jp = _jax_tree(params, {"e"})
    jstate = jsgd.sgd_init(jp)
    tp = _named(params, {"e"})
    tstate = sgd_init(tp)
    for g in grads:
        jp, jstate = jsgd.sgd_update(jp, _jax_tree(g, {"e"}), jstate, jnp.float32(0.05))
        sgd_update(tp, _named(g, {"e"}), tstate, torch.tensor(0.05), momentum=0.9)
        _assert_tree_close(tp, jp, {"e"})
        _assert_tree_close(tstate["mom"], jstate["mom"], set())


def test_adamw_on_a_module_keys_by_parameter_name():
    cfg = get_arch("llama3.2-1b").reduced()
    model = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    state = adamw_init(model)
    names = [n for n, _ in model.named_parameters()]
    assert list(state["m"]) == names == list(state["v"])
    assert "layers.1.attn.wq" in state["m"]
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    before = model.layers[0].ffn.w_up.detach().clone()
    adamw_update(model, grads, state, torch.tensor(1e-2))
    assert not torch.equal(model.layers[0].ffn.w_up, before)
    assert model.layers[0].ffn.w_up.grad is None and int(state["step"]) == 1


# --------------------------------------------------------------------------
# tree helpers
# --------------------------------------------------------------------------

def test_tree_helpers_match_reference():
    params, _ = _leaves(np.random.default_rng(2), {"b.c"})
    jt = _jax_tree(params, {"b.c"})
    tt = {"a": torch.from_numpy(params["a"]),
          "b": {"c": torch.from_numpy(params["b"]["c"]).to(torch.bfloat16),
                "d": torch.from_numpy(params["b"]["d"])},
          "e": [torch.from_numpy(params["e"]), 3]}
    jt["e"] = [jt["e"], 3]
    assert tree.tree_bytes(tt) == jtree.tree_bytes(jt)
    assert tree.tree_params(tt) == jtree.tree_params(jt)
    z = tree.tree_zeros_like(tt)
    assert z["b"]["c"].dtype == torch.bfloat16 and not z["b"]["d"].any() and z["e"][1] == 3
    s = tree.tree_add(tree.tree_scale(tt, 2.0), tt)
    np.testing.assert_array_equal(s["a"].numpy(), np.asarray(
        jtree.tree_add(jtree.tree_scale(jt, 2.0), jt)["a"]))
    fin = tree.tree_finite(tt)
    assert fin.shape == () and fin.dtype == torch.bool and bool(fin)
    assert bool(jtree.tree_finite(jt))
    for bad in (float("nan"), float("inf")):
        tt["b"]["d"][1, 2, 0] = bad
        assert not bool(tree.tree_finite(tt))
        tt["b"]["d"][1, 2, 0] = 0.0
    assert bool(tree.tree_finite({}))


def test_tree_of_a_module_is_its_named_parameters():
    cfg = get_arch("llama3.2-1b").reduced()
    model = api.init_params(cfg, device="meta")
    names = [n for n, _ in tree.named_leaves(model)]
    assert names == [n for n, _ in model.named_parameters()]
    assert tree.tree_params(model) == api.param_count(model)
    assert tree.tree_bytes(model) == 4 * api.param_count(model)
    state = {"params": model, "step": torch.zeros((), dtype=torch.int32)}
    assert [n for n, _ in tree.named_leaves(state)][-1] == "step"
    assert tree.tree_params(state) == api.param_count(model) + 1
