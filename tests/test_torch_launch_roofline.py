"""The port's roofline model (``repro_torch.launch.roofline``) and its FLOP
count against the reference's on the CPU.

* ``Roofline.row()`` equals the reference's ``Roofline.row()`` key for key
  on the same inputs once the reference module's TPU constants are
  replaced by the port's H100 constants; ``model_flops`` is equal.
* A reduced step's FLOPs, counted by ``FlopCounterMode`` on the ``meta``
  device (the dry run's count), forward and forward + backward, are within
  ``FLOP_RTOL`` of the reference's XLA ``cost_analysis()["flops"]`` on one
  CPU device, for one config of every decoder family and the
  encoder-decoder.  The count is XLA's of the lowered module: the compiled
  module's differs from it by under 1% on these configs, and compiling
  takes twice as long.  The reference runs with ``scan_unroll=True``
  (its own switch, which its layer-slope method sets), since XLA counts a
  loop's body once.  Its attention's query-chunk loop (``jax.lax.map``)
  and the SSM chunk loop (``jax.lax.scan``) stay loops, so XLA counts one
  chunk of each where the port counts all of them: that is the port's 2-4%
  surplus (the products of the other chunks, less the elementwise FLOPs
  XLA adds and the counter does not).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.launch.roofline as jrf
from repro.configs import get_arch as j_get_arch
from repro.models import api as japi
from repro_torch.configs import get_arch
from repro_torch.launch import roofline as rf
from repro_torch.models import api

FLOP_RTOL = 0.05
FAMILIES = ["llama3.2-1b", "internvl2-26b", "granite-moe-3b-a800m", "deepseek-v2-236b",
            "rwkv6-3b", "hymba-1.5b", "whisper-medium"]
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_h100_constants():
    assert rf.PEAK_FLOPS == 989e12 and rf.HBM_BW == 3.35e12 and rf.LINK_BW == 50e9
    assert rf.HBM_BYTES == 80e9


@pytest.mark.parametrize("terms", [
    dict(hlo_flops=3.1e13, hlo_bytes=2.2e11, collective_bytes=4.4e9, model_flops=5.0e15,
         peak_bytes_per_device=7.5e10),
    dict(hlo_flops=1.0e9, hlo_bytes=6.0e10, collective_bytes=0.0, model_flops=2.0e11),
    dict(hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=9.9e9, model_flops=0.0),
])
def test_row_is_the_references_at_the_port_constants(terms, monkeypatch):
    monkeypatch.setattr(jrf, "PEAK_FLOPS", rf.PEAK_FLOPS)
    monkeypatch.setattr(jrf, "HBM_BW", rf.HBM_BW)
    monkeypatch.setattr(jrf, "ICI_BW", rf.LINK_BW)
    head = dict(arch="llama3.2-1b", shape="train_4k", mesh="16x16", chips=256)
    got = rf.Roofline(**head, **terms)
    want = jrf.Roofline(**head, **terms)
    assert got.row() == want.row()
    assert (got.step_time, got.bottleneck) == (want.step_time, want.bottleneck)
    for phase in ("train", "prefill", "decode"):
        assert rf.model_flops(1_235_814_400, 4096 * 256, phase) == \
            jrf.model_flops(1_235_814_400, 4096 * 256, phase)


def _batches(cfg, jc):
    s_text = S - cfg.num_prefix if cfg.frontend == "vision_stub" else S
    tb = {"tokens": torch.empty((B, s_text), dtype=torch.int32, device="meta")}
    jb = {"tokens": jax.ShapeDtypeStruct((B, s_text), jnp.int32)}
    tb["labels"], jb["labels"] = tb["tokens"], jb["tokens"]
    if cfg.frontend != "none" or cfg.kind == "encdec":
        tb["prefix_embeds"] = torch.empty((B, cfg.num_prefix, cfg.d_model), device="meta")
        jb["prefix_embeds"] = jax.ShapeDtypeStruct((B, jc.num_prefix, jc.d_model), jnp.float32)
    return tb, jb


def _xla_flops(fn, *args):
    cost = jax.jit(fn).lower(*args).cost_analysis()
    return (cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_flops_are_xlas_within_five_percent(arch):
    cfg = get_arch(arch).reduced()
    jc = dataclasses.replace(j_get_arch(arch).reduced(), scan_unroll=True)
    tb, jb = _batches(cfg, jc)
    jparams = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
    jloss = lambda p, b: japi.loss_fn(p, jc, b)[0]          # noqa: E731
    model = api.init_params(cfg, device="meta")
    for grad in (False, True):
        counter = FlopCounterMode(display=False)
        with counter:
            loss = api.loss_fn(model, cfg, tb)[0]
            if grad:
                loss.backward()
        got = counter.get_total_flops()
        want = _xla_flops(jax.grad(jloss) if grad else jloss, jparams, jb)
        assert abs(got / want - 1) <= FLOP_RTOL, (grad, got, want)
        assert got >= want * (1 - 0.01), "the counter counts every chunk XLA counts once"
