"""Weights, decode caches and checkpoints of the MLA, RWKV-6 and Hymba
families (reduced ``deepseek-v2-236b``, ``rwkv6-3b`` and ``hymba-1.5b``)
across the packages on the CPU, and ``launch/train`` for each: the
converters with the float32 leaves of a bf16 model (the MoE router,
RWKV-6's decay base and bonus, Mamba's ``dt_bias``, ``A_log`` and ``D``),
a reference cache carried into the port (RWKV's without ``kpos``) and
decoded on to the reference's logits at ``atol=1e-4``, and the
reference's bf16 checkpoint file read and written again byte for byte.
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
from repro.models import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_arch
from repro_torch.convert import (
    lm_cache_from_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.train import load_checkpoint, save_checkpoint
from repro_torch.train import train_state_init

CPU = "cpu"
ARCHS = ["rwkv6-3b", "hymba-1.5b"]
ALL = ["deepseek-v2-236b"] + ARCHS
ATOL = 1e-4
B, S = 8, 16


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


_MODELS = {}


def _pair(arch, **replace):
    tag = (arch,) + tuple(sorted(replace.items()))
    if tag not in _MODELS:
        jc, tc = _cfgs(arch, **replace)
        params = jax.jit(lambda k: japi.init_params(k, jc))(jax.random.PRNGKey(3))
        # a decay and a bonus that are not the init's constants
        if "rwkv" in params["layers"]:
            r = np.random.default_rng(1)
            rw = dict(params["layers"]["rwkv"])
            rw["decay_base"] = jnp.asarray(r.uniform(-2.0, 1.0, rw["decay_base"].shape),
                                           jnp.float32)
            rw["bonus_u"] = jnp.asarray(r.standard_normal(rw["bonus_u"].shape), jnp.float32)
            params = dict(params, layers=dict(params["layers"], rwkv=rw))
        _MODELS[tag] = (jc, tc, params,
                        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU))
    return _MODELS[tag]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------
# weights, caches and checkpoints across the packages (MLA, RWKV-6, Hymba)
# --------------------------------------------------------------------------

F32_LEAVES = {"deepseek-v2-236b": {"moe.router"},
              "rwkv6-3b": {"rwkv.decay_base", "rwkv.bonus_u"},
              "hymba-1.5b": {"mamba.dt_bias", "mamba.A_log", "mamba.D"}}


@pytest.mark.parametrize("arch", ALL)
def test_bf16_params_with_float32_leaves_round_trip(arch):
    jc, tc = _cfgs(arch, param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    params = japi.init_params(jax.random.PRNGKey(1), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    f32 = {n.split(".", 2)[2] for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert f32 == F32_LEAVES[arch]
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters()
               if n.split(".", 2)[-1] not in f32)
    back = lm_params_to_numpy(model)
    want = _flat(params)
    got = _flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # with bf16_words the bf16 leaves are the reference's raw 16-bit words
    words = {jax.tree_util.keystr(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(lm_params_to_numpy(model, bf16_words=True))[0]}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        k = jax.tree_util.keystr(path)
        assert words[k].dtype == (np.dtype("V2") if leaf.dtype == jnp.bfloat16 else np.float32)
        assert words[k].tobytes() == np.asarray(leaf).tobytes(), k


@pytest.mark.parametrize("arch", ALL)
def test_reference_cache_carries_across(arch):
    """Three tokens decoded by the reference, its cache carried into the
    port (RWKV's has no ``kpos``), three more decoded by both."""
    replace = {"capacity_factor": 8.0} if arch == "deepseek-v2-236b" else {}
    jc, tc, params, model = _pair(arch, **replace)
    toks = _tokens(tc, 2, 6, seed=5)
    jcache = jlm.init_cache(jc, 2, 8)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, jc, c, t))
    for t in range(3):
        _, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
    cache = lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), CPU)
    assert ("kpos" in cache) == (arch != "rwkv6-3b") and int(cache["pos"]) == 3
    for k, v in cache["layers"].items():
        assert v.dtype == (torch.float32 if k in ("wkv", "mamba_h") else tc.param_dtype), k
    for t in range(3, 6):
        got, cache = api.decode_step(model, tc, cache, _t(toks[:, t:t + 1]))
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ALL)
def test_bf16_checkpoint_is_the_reference_file(arch, tmp_path):
    """The reference's bf16 train state through its ``save_checkpoint``,
    read by the port and written again: every array the same bytes."""
    jc = dataclasses.replace(j_get_arch(arch).reduced(), param_dtype=jnp.bfloat16)
    jstate = jtrainer.train_state_init(jax.random.PRNGKey(2), jc)
    jpath = str(tmp_path / "ref")
    jckpt.save_checkpoint(jpath, jstate, step=3)
    tc = dataclasses.replace(get_arch(arch).reduced(), param_dtype=torch.bfloat16)
    like = train_state_init(tc, generator=torch.Generator().manual_seed(0), device=CPU)
    restored, step_no = load_checkpoint(jpath, like)
    assert step_no == 3
    path = str(tmp_path / "port")
    save_checkpoint(path, restored, step=3)
    with np.load(os.path.join(path, "step00000003.npz")) as a, \
            np.load(os.path.join(jpath, "step00000003.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        f32 = [k for k in a.files if k.startswith("params|") and a[k].dtype == np.float32]
        assert {k.split("|", 2)[2].replace("|", ".") for k in f32} == F32_LEAVES[arch]


@pytest.mark.parametrize("arch", ALL)
def test_launch_train_reduced_on_the_cpu(arch, tmp_path):
    path = str(tmp_path / "run")
    assert launch_train.main(["--arch", arch, "--reduced", "--steps", "1", "--seq", "16",
                              "--batch", "4", "--selector", "coreset", "--ckpt", path,
                              "--device", "cpu"]) == 0
    like = train_state_init(get_arch(arch).reduced(), generator=torch.Generator().manual_seed(0),
                            device=CPU)
    state, step_no = load_checkpoint(path, like)
    assert step_no == 1 and int(state["step"]) == 1


