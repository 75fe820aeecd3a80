"""The port's dry run and hill-climb (``repro_torch.launch.dryrun``,
``repro_torch.launch.hillclimb``) on the ``meta`` device, and the kernel
wrappers' ``meta`` route.

* Every kernel wrapper sends a ``meta`` tensor, like a CPU one, to its
  plain version (shapes only); ``resolve_backend("auto", "meta")`` is
  ``"ref"``; a reduced granite coreset train step on a ``meta`` state runs
  and gives the CPU step's shapes.
* Every (arch, phase) at reduced width and small shapes gives ``status:
  ok`` with the reference's record keys; the train step's layer-slope
  extrapolation (L = 1, 2 -> 3) equals the direct three-layer count exactly
  for the FLOPs and the bytes, for every family.  ``whisper-medium`` at
  ``long_500k`` is the documented skip.  The CLI writes a row.
* Each hill-climb step's transformed config and selector equal the
  reference's field for field (the reference's module is imported with the
  one-device jax backend already up, and its ``XLA_FLAGS`` restored), and
  the hill-climb CLI runs one reduced step into ``tmp_path``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.configs import all_arch_names, get_arch
from repro_torch.configs.base import InputShape
from repro_torch.core.api import resolve_backend
from repro_torch.core.selector import SelectorConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, hillclimb, inputs
from repro_torch.optim.schedules import constant
from repro_torch.train import make_train_step, train_state_init

ARCHS = all_arch_names()
SMALL = {"train": InputShape("train_small", 16, 2, "train"),
         "prefill": InputShape("prefill_small", 16, 2, "prefill"),
         "decode": InputShape("decode_small", 16, 2, "decode")}
REF_KEYS = ("arch", "shape", "mesh", "chips", "phase", "status", "lower_s", "compile_s",
            "n_layers", "hlo_flops", "hlo_bytes", "hlo_bytes_opt", "collective_bytes",
            "collectives", "memory", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "model_flops", "useful_fraction", "mfu_at_roofline",
            "peak_bytes_per_device", "wall_s")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(layers):
    def tr(cfg):
        return dataclasses.replace(cfg.reduced(), num_layers=layers,
                                   enc_layers=min(cfg.enc_layers, layers))
    return tr


# --------------------------------------------------------------------------
# the meta route of the kernel wrappers
# --------------------------------------------------------------------------

def test_meta_tensors_take_the_plain_versions():
    assert resolve_backend("auto", "meta") == "ref"
    assert resolve_backend("auto", torch.device("meta")) == "ref"
    g = np.random.default_rng(0)
    X = torch.from_numpy(g.standard_normal((3, 40, 6)).astype(np.float32))
    M = torch.from_numpy(g.standard_normal((3, 6, 6)).astype(np.float32))
    C = X[:, :5]
    w = torch.ones(3, 40)
    logits = torch.zeros(40)
    counts = torch.tensor([2, 3, 1])
    keys = torch.zeros(3, 2, dtype=torch.int64)
    key = rng.PRNGKey(0)
    calls = (lambda X, M, C, w, lg, c, k, ks: kops.leverage(X, M),
             lambda X, M, C, w, lg, c, k, ks: kops.weighted_gram(X, w),
             lambda X, M, C, w, lg, c, k, ks: kops.kmeans_assign(X, C),
             lambda X, M, C, w, lg, c, k, ks: kops.kmeans_assign_update(X, C, w),
             lambda X, M, C, w, lg, c, k, ks: kops.categorical(k, lg, 7),
             lambda X, M, C, w, lg, c, k, ks: kops.categorical_parties(
                 ks, lg.expand(3, -1), 4, c, total=6))
    for fn in calls:
        args = (X, M, C, w, logits, counts, key, keys)
        want = fn(*args)
        got = fn(*(a.to("meta") for a in args))
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for a, b in zip(want, got):
            assert b.device.type == "meta"
            assert b.shape == a.shape and b.dtype == a.dtype


def _granite_step(device):
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    if device == "meta":
        state = inputs.state_specs(cfg)
    else:
        state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 16))
                            .astype(np.int32)).to(device)
    batch = {"tokens": toks, "labels": toks}
    step = make_train_step(cfg, constant(1e-3), SelectorConfig(mode="coreset", fraction=0.25))
    state, met = step(state, batch, rng.PRNGKey(3, device=device))
    return state, met


def test_a_coreset_train_step_on_a_meta_state_has_the_cpu_steps_shapes():
    sm, mm = _granite_step("meta")
    sc, mc = _granite_step("cpu")
    assert mm.keys() == mc.keys()
    for k in mm:
        assert mm[k].device.type == "meta" and mm[k].shape == mc[k].shape, k
    named = dict(sc["params"].named_parameters())
    for name, p in sm["params"].named_parameters():
        assert p.device.type == "meta" and p.grad is not None, name
        assert p.shape == named[name].shape and p.grad.shape == named[name].grad.shape, name
    assert sm["opt"]["m"].keys() == sc["opt"]["m"].keys()


# --------------------------------------------------------------------------
# every (arch, phase)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_train_step_ok_and_its_slope_exact(arch):
    rec = dryrun.roofline_one(arch, SMALL["train"], cfg_transform=_reduced(3), full_depth=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert set(REF_KEYS) <= set(rec)
    assert rec["method"] == "layer_slope" and rec["n_layers"] == 3
    for k in ("flops", "bytes", "bytes_opt"):
        check = rec["slope_check"][k]
        assert check["direct"] == check["extrapolated"] > 0, k
    assert rec["flops_per_device"] == "global/chips" and rec["tp_collectives"] == "not executed"
    assert rec["hlo_flops"] * rec["chips"] == rec["slope_check"]["flops"]["direct"]
    assert rec["chips"] == 256 and rec["mesh"] == "16x16" and rec["fits"]
    assert rec["collectives"]["all-reduce"] == {"count": 1, "bytes": 4}


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_serving_phase_ok(arch, phase):
    rec = dryrun.run_one(arch, SMALL[phase], multi_pod=True, cfg_transform=_reduced(2))
    assert rec["status"] == "ok", rec.get("trace")
    assert set(REF_KEYS) <= set(rec)
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16" and rec["phase"] == phase
    assert rec["hlo_flops"] > 0 and rec["collectives"]["all-gather"]["count"] > 0
    assert "reduce-scatter" not in rec["collectives"]
    assert rec["peak_bytes_per_device"] == (rec["memory"]["argument_size_in_bytes"]
                                            + rec["memory"]["temp_size_in_bytes"])


def test_skips_are_the_references():
    rec = dryrun.run_one("whisper-medium", "long_500k")
    assert rec["status"] == "skipped" and rec["reason"] == dryrun.SKIPS[
        ("whisper-medium", "long_500k")]
    assert dryrun.roofline_one("whisper-medium", "long_500k")["status"] == "skipped"


def test_the_dryrun_cli_writes_a_row(tmp_path):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--roofline",
                        "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["method"] == "layer_slope" and rec["n_layers"] == 16


# --------------------------------------------------------------------------
# the hill-climb
# --------------------------------------------------------------------------

def _ref_hillclimb():
    """The reference's hill-climb module.  Importing it sets ``XLA_FLAGS``
    for 512 host devices, which takes hold only where jax's backend is not
    up yet: bring it up first, and put the variable back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.hillclimb as jh
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    assert len(jax.devices()) == 1
    return jh


def _fields(cfg):
    """A config's fields, its dtype by name (``torch.bfloat16`` and jax's
    ``bfloat16`` class -> ``bfloat16``)."""
    def name(v):
        return str(v).split(".")[-1] if isinstance(v, torch.dtype) else np.dtype(v).name

    return {k: (name(v) if k == "param_dtype" else v) for k, v in dataclasses.asdict(cfg).items()}


def test_hillclimb_steps_are_the_references():
    from repro.configs import get_arch as j_get_arch

    jh = _ref_hillclimb()
    assert list(hillclimb.STEPS) == list(jh.STEPS)
    for step, (arch, shape, tr, sel) in hillclimb.STEPS.items():
        jarch, jshape, jtr, jsel = jh.STEPS[step]
        assert (arch, shape) == (jarch, jshape), step
        assert (tr is None) == (jtr is None), step
        if tr is not None:
            assert _fields(tr(get_arch(arch))) == _fields(jtr(j_get_arch(arch))), step
        assert (sel is None) == (jsel is None), step
        if sel is not None:
            assert dataclasses.asdict(sel) == dataclasses.asdict(jsel), step


def test_the_hillclimb_cli_runs_one_reduced_step(tmp_path, monkeypatch):
    out = tmp_path / "hc.jsonl"
    arch, _, tr, sel = hillclimb.STEPS["C2"]
    monkeypatch.setitem(hillclimb.STEPS, "C2r",
                        (arch, SMALL["train"], lambda c: _reduced(2)(tr(c)), sel))
    assert hillclimb.main(["--step", "C2r", "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["step"] == "C2r" and rec["shape"] == "train_small"
    # the coreset step gathers the embedding once more for its features
    assert rec["collectives"]["all-gather"]["count"] == 2 * 2 + 1 + 1
