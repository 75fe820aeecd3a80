"""The port's checkpoints (``repro_torch.train.checkpoint``) and training
launcher (``repro_torch.launch.train``) on the CPU.

A checkpoint is the reference's file: ``step%08d.npz`` with ``LATEST``,
keys joined by ``|`` on the reference's tree, layers stacked on L,
bfloat16 leaves as raw 16-bit words (``|V2``).  Every comparison here is
exact: round trips in float32 and bfloat16, a port-written float32 file
read by the reference's ``load_checkpoint`` and the reverse, and a
reference-written bfloat16 file read by the port.  (The reference's own
``load_checkpoint`` cannot read a bfloat16 file, its own or the port's:
numpy has no cast from ``|V2`` to bfloat16.)
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import rng
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data import TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.optim.schedules import constant
from repro_torch.train import load_checkpoint, make_train_step, save_checkpoint, train_state_init
from repro_torch.utils.tree import named_leaves

CPU = "cpu"
ARCH = "llama3.2-1b"


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


def _cfg(bf16=False):
    cfg = get_arch(ARCH).reduced()
    return dataclasses.replace(cfg, param_dtype=torch.bfloat16) if bf16 else cfg


def _trained(cfg, seed=0, steps=1):
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(seed), device=CPU)
    step = make_train_step(cfg, constant(1e-3))
    it = iter(TokenStream(vocab=cfg.vocab_size, seq_len=16, batch_size=4, seed=seed,
                          device=CPU))
    for i in range(steps):
        state, _ = step(state, next(it), rng.fold_in(rng.PRNGKey(seed), i))
    return state


def _assert_states_equal(a, b):
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype and torch.equal(la[name], lb[name]), name


def _assert_matches_reference(state, jstate):
    got = train_state_to_numpy(state)
    flat_j = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    flat_t = {jax.tree_util.keystr(p): v
              for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        want = np.asarray(jnp.asarray(v).astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
        np.testing.assert_array_equal(flat_t[k], want, err_msg=k)


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoint_round_trip(tmp_path, bf16):
    cfg = _cfg(bf16)
    state = _trained(cfg, steps=2)
    path = str(tmp_path / "ckpt")
    fname = save_checkpoint(path, state, step=2)
    assert os.path.basename(fname) == "step00000002.npz"
    assert open(os.path.join(path, "LATEST")).read() == "step00000002.npz"
    with np.load(fname) as data:
        assert data["params|layers|attn|wq"].shape[0] == cfg.num_layers
        assert data["opt|m|layers|ffn|w_up"].dtype == np.float32
        assert data["params|embed"].dtype == (np.dtype("V2") if bf16 else np.float32)
        assert data["step"] == 2 and data["opt|step"] == 2
    like = train_state_init(cfg, generator=torch.Generator().manual_seed(9), device=CPU)
    restored, step_no = load_checkpoint(path, like)
    assert step_no == 2 and restored is not like
    _assert_states_equal(restored, state)
    # the restored state trains on as the saved one does
    it = TokenStream(vocab=cfg.vocab_size, seq_len=16, batch_size=4, seed=7, device=CPU)
    batch = it.next_batch()
    step = make_train_step(cfg, constant(1e-3))
    _, m1 = step(state, batch, rng.PRNGKey(1))
    _, m2 = step(restored, batch, rng.PRNGKey(1))
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_states_equal(restored, state)


def test_checkpoint_refuses_another_config(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, _trained(_cfg()), step=1)
    other = dataclasses.replace(_cfg(), d_ff=256)
    like = train_state_init(other, generator=torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError):
        load_checkpoint(path, like)


def test_port_checkpoint_loads_in_the_reference_and_back(tmp_path):
    state = _trained(_cfg(), seed=1, steps=2)
    path = str(tmp_path / "port")
    save_checkpoint(path, state, step=2)
    jc = j_get_arch(ARCH).reduced()
    jlike = jtrainer.train_state_init(jax.random.PRNGKey(5), jc)
    jstate, step_no = jckpt.load_checkpoint(path, jlike)
    assert step_no == 2
    _assert_matches_reference(state, jstate)
    # the reference writes it again; the port reads that file to the same bits
    jpath = str(tmp_path / "ref")
    jckpt.save_checkpoint(jpath, jstate, step=2)
    with np.load(os.path.join(path, "step00000002.npz")) as a, \
            np.load(os.path.join(jpath, "step00000002.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    like = train_state_init(_cfg(), generator=torch.Generator().manual_seed(3), device=CPU)
    restored, _ = load_checkpoint(jpath, like)
    _assert_states_equal(restored, state)


def test_reference_bf16_checkpoint_loads_in_the_port(tmp_path):
    jc = dataclasses.replace(j_get_arch(ARCH).reduced(), param_dtype=jnp.bfloat16)
    jstate = jtrainer.train_state_init(jax.random.PRNGKey(2), jc)
    jpath = str(tmp_path / "ref")
    jckpt.save_checkpoint(jpath, jstate, step=4)
    cfg = _cfg(bf16=True)
    like = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    restored, step_no = load_checkpoint(jpath, like)
    assert step_no == 4 and restored["params"].embed.dtype == torch.bfloat16
    _assert_matches_reference(restored, jstate)
    # the port's file of that state is the reference's file, word for word
    path = str(tmp_path / "port")
    save_checkpoint(path, restored, step=4)
    with np.load(os.path.join(path, "step00000004.npz")) as a, \
            np.load(os.path.join(jpath, "step00000004.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    # which the reference's loader refuses as it refuses its own
    for p in (path, jpath):
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.load_checkpoint(p, jstate)


def test_state_converters_round_trip():
    jc = j_get_arch(ARCH).reduced()
    jstate = jtrainer.train_state_init(jax.random.PRNGKey(4), jc)
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), _cfg(), CPU)
    _assert_matches_reference(state, jstate)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    broken = jax.tree_util.tree_map(np.asarray, jstate)
    del broken["opt"]["m"]["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        train_state_from_numpy(broken, _cfg(), CPU)


# --------------------------------------------------------------------------
# python -m repro_torch.launch.train
# --------------------------------------------------------------------------

def test_launch_train_writes_a_checkpoint_on_the_cpu(tmp_path):
    path = str(tmp_path / "run")
    rc = launch_train.main(["--steps", "3", "--seq", "16", "--batch", "4", "--selector",
                            "coreset", "--ckpt", path, "--device", "cpu"])
    assert rc == 0
    assert open(os.path.join(path, "LATEST")).read() == "step00000003.npz"
    like = train_state_init(_cfg(), generator=torch.Generator().manual_seed(0), device=CPU)
    state, step_no = load_checkpoint(path, like)
    assert step_no == 3 and int(state["step"]) == 3 and int(state["opt"]["step"]) == 3


def test_launch_train_production_prints_a_spec_for_every_parameter(caplog):
    """``--production`` at the published width: one line a parameter path
    (the reference's, layers stacked), its spec from ``param_shardings``."""
    from repro_torch.models import api
    from repro_torch.sharding.specs import flat_specs, param_shardings, stacked_shapes

    arch = "deepseek-v2-236b"
    with caplog.at_level("INFO", logger="train"):
        assert launch_train.main(["--arch", arch, "--production", "--device", "cpu"]) == 0
    cfg = get_arch(arch)
    want = flat_specs(param_shardings(stacked_shapes(api.init_params(cfg, device="meta")),
                                      cfg, multi_pod=False))
    lines = [r.getMessage() for r in caplog.records if r.name == "train"]
    assert lines[0].startswith("production mesh: 16x16")
    got = dict(line.split(None, 1) for line in lines[1:])
    assert set(got) == set(want) and len(want) == 21
    assert all(got[p] == str(spec) for p, spec in want.items())
    assert got["layers/moe/w_gate"] == "(None, 'model', 'data', None)"   # E over model, fsdp


def test_launch_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])
