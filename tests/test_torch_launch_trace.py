"""The port's trace reader (``repro_torch.launch.trace``, the counterpart of
``repro.launch.hlo``) on the CPU.

* A gloo world of two (two subprocesses meeting in a ``FileStore`` under
  the test's directory, each killed past ``RANK_TIMEOUT_S``), its mesh from
  ``make_debug_mesh(2, 1, device_type="cpu")``: the collectives of one
  profiled FSDP train step (after a first, unprofiled one), read by
  ``collective_stats``, equal ``dryrun.fsdp_collectives`` of the same
  model exactly, kind for kind, count and bytes: reduced ``llama3.2-1b``
  in modes ``none`` and ``coreset`` and reduced ``whisper-medium`` in mode
  ``none``, ``fsdp=True``.
* ``fusion_optimistic_bytes`` and ``StepCounter``'s bytes and live peak
  of small functions against hand counts, on ``meta`` and on the CPU.
* ``while_trip_counts`` against the chunk loops counted in a run of each
  family's reduced model.
* ``op_census`` and ``device_busy_us`` over stand-ins of the profiler's
  records (the device's user annotations left out).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import all_arch_names, get_arch
from repro_torch.configs.base import InputShape
from repro_torch.core.selector import SelectorConfig
from repro_torch.launch import dryrun, trace
from repro_torch.models import api, attention, ssm

SRC = Path(__file__).resolve().parent.parent / "src"
RANK_TIMEOUT_S = 120
RUNS = (("llama3.2-1b", "none"), ("llama3.2-1b", "coreset"), ("whisper-medium", "none"))
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _selector(mode):
    return None if mode == "none" else SelectorConfig(mode=mode, fraction=0.5)


_RANK = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import rng
from repro_torch.configs import get_arch
from repro_torch.core.selector import SelectorConfig
from repro_torch.launch import trace
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.sharding.fsdp import fully_shard_model
from repro_torch.train import make_train_step

rank, world, store_path, runs, B, S = sys.argv[1:7]
rank, world, B, S = int(rank), int(world), int(B), int(S)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                        world_size=world)
mesh = make_debug_mesh(world, 1, device_type="cpu")
report = {}
for arch, mode in json.loads(runs):
    cfg = dataclasses.replace(get_arch(arch).reduced(), fsdp=True)
    model = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    fully_shard_model(model, cfg, mesh)
    state = {"params": model, "opt": adamw_init(model), "step": torch.zeros((), dtype=torch.int32)}
    g = np.random.default_rng(rank)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    if cfg.kind == "encdec":
        batch["prefix_embeds"] = torch.from_numpy(
            g.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32))
    sel = None if mode == "none" else SelectorConfig(mode=mode, fraction=0.5)
    step = make_train_step(cfg, constant(1e-3), sel)
    step(state, batch, rng.PRNGKey(1))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        step(state, batch, rng.PRNGKey(2))
    report[f"{arch}|{mode}"] = trace.collective_stats(prof)
dist.destroy_process_group()
print(json.dumps(report))
'''


def test_a_profiled_fsdp_step_in_a_gloo_world_of_two_moves_the_formulas_bytes(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = {**os.environ, "PYTHONPATH": str(SRC)}     # keeps HOME and TMPDIR
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"), json.dumps(RUNS),
         str(B), str(S)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    reports = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err
            reports.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of the gloo world ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert reports[0] == reports[1]
    sizes = {"pod": 1, "data": 2, "model": 1}
    for arch, mode in RUNS:
        cfg = dataclasses.replace(get_arch(arch).reduced(), fsdp=True)
        want = dryrun.fsdp_collectives(api.init_params(cfg, device="meta"), cfg, "train", sizes,
                                       selector=_selector(mode))
        assert reports[0][f"{arch}|{mode}"] == want, (arch, mode)
    layers = get_arch("llama3.2-1b").reduced().num_layers
    assert reports[0]["llama3.2-1b|none"]["all-gather"]["count"] == 2 * layers + 1
    assert reports[0]["llama3.2-1b|coreset"]["all-gather"]["count"] == 2 * layers + 2


# --------------------------------------------------------------------------
# the aten-op counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_fusion_optimistic_bytes_of_two_products_is_the_hand_count(device):
    a = torch.ones(64, 128, device=device)
    b = torch.ones(128, 96, device=device)
    c = torch.ones(96, 32, device=device)
    got = trace.fusion_optimistic_bytes(lambda: torch.tanh(a @ b) @ c)
    assert got == 2 * (64 * 96 * 4 + 64 * 32 * 4)
    idx = torch.zeros(10, dtype=torch.int64, device=device)
    assert trace.fusion_optimistic_bytes(lambda: (a + 1)[idx]) == 2 * 10 * 128 * 4


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_step_counter_bytes_and_live_peak(device):
    x = torch.ones(1000, device=device)
    w = torch.ones(1000, 1000, device=device, requires_grad=True)
    with trace.StepCounter(exclude=[x, w]) as c:
        y = x + 1                              # reads x, writes y
        z = y.view(10, 100)                    # a view moves nothing
    assert c.bytes_accessed == 2 * 4000
    assert c.live == c.peak == 4000            # y's storage, held by y and z
    del y, z
    assert c.live == 0
    with trace.StepCounter(exclude=[x, w]) as c:
        h = x
        for _ in range(3):
            h = torch.tanh(h @ w)              # tanh saves its output
        h.sum().backward()
        del h
    assert c.live == 1000 * 1000 * 4           # w.grad
    assert c.peak >= 1000 * 1000 * 4 + 3 * 4000


def _counted_loops(monkeypatch, cfg, tokens, prefix):
    seen = {"attn": [], "ssm": []}
    sdpa, chunks = attention._sdpa_chunked, ssm._chunks

    def count_sdpa(q, k, v, qp, kp, window, chunk):
        seen["attn"].append((q.shape[1], max(q.shape[1] // chunk, 1)))
        return sdpa(q, k, v, qp, kp, window, chunk)

    def count_chunks(S, chunk, who):
        out = chunks(S, chunk, who)
        seen["ssm"].append(out[0])
        return out

    monkeypatch.setattr(attention, "_sdpa_chunked", count_sdpa)
    monkeypatch.setattr(ssm, "_chunks", count_chunks)
    model = api.init_params(cfg, device="meta")
    with torch.no_grad():
        api.forward_hidden(model, cfg, {"tokens": tokens, "prefix_embeds": prefix})
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch", all_arch_names())
def test_while_trip_counts_are_the_loops_a_run_takes(arch, monkeypatch):
    cfg = get_arch(arch).reduced()
    shape = InputShape("small", 32, 2, "prefill")
    s_text = shape.seq_len - (cfg.num_prefix if cfg.frontend == "vision_stub" else 0)
    tokens = torch.empty((2, s_text), dtype=torch.int32, device="meta")
    prefix = torch.empty((2, cfg.num_prefix, cfg.d_model), device="meta")
    seen = _counted_loops(monkeypatch, cfg, tokens, prefix if cfg.num_prefix else None)
    want = trace.while_trip_counts(cfg, shape)
    assert want["layers"] == cfg.num_layers
    if cfg.kind == "encdec":
        assert want["enc_layers"] == cfg.enc_layers
        enc = [nc for sq, nc in seen["attn"] if sq == cfg.num_prefix]
        assert enc == [want["enc_attn_chunks"]] * cfg.enc_layers
        seen["attn"] = [x for x in seen["attn"] if x[0] != cfg.num_prefix]
    if "attn_chunks" in want:
        assert [nc for _, nc in seen["attn"]] == [want["attn_chunks"]] * cfg.num_layers
    else:
        assert not seen["attn"]
    if "ssm_chunks" in want:
        assert seen["ssm"] == [want["ssm_chunks"]] * cfg.num_layers
    else:
        assert not seen["ssm"]
    decode = trace.while_trip_counts(cfg, InputShape("d", 32, 2, "decode"))
    assert all(v == 1 for k, v in decode.items() if k.endswith("chunks"))


# --------------------------------------------------------------------------
# the trace's device events
# --------------------------------------------------------------------------

class _Raw:
    """Stands in for one of the profiler's kineto records."""

    def __init__(self, name, start_us, end_us, device=True, annotation=False):
        from torch.autograd import DeviceType

        self._name, self._start, self._dur = name, int(start_us * 1e3), int((end_us - start_us) * 1e3)
        self._dev = DeviceType.CUDA if device else DeviceType.CPU
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._annotation

    def shapes(self):
        return []

    def dtypes(self):
        return []


def _prof(raw):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))


def test_op_census_and_device_busy_over_a_stand_in_trace():
    prof = _prof([_Raw("void kau_partial_kernel<4>(float const*, int)", 0.0, 10.0),
                  _Raw("kau_reduce_kernel(float const*)", 10.0, 12.0),
                  _Raw("void kau_partial_kernel<4>(float const*, int)", 20.0, 31.0),
                  _Raw("aten::mm", 0.0, 100.0, device=False),
                  _Raw("FSDP::all_gather", 0.0, 90.0, annotation=True),
                  _Raw("kau_reduce_kernel(float const*)", 30.0, 33.0)])
    census = trace.op_census(prof, top=None)
    assert list(census) == ["void kau_partial_kernel<4>(float const*, int)",
                            "kau_reduce_kernel(float const*)"]
    assert census["void kau_partial_kernel<4>(float const*, int)"] == {"count": 2,
                                                                        "device_us": 21.0}
    assert trace.op_census(prof, top=1).keys() == {"void kau_partial_kernel<4>(float const*, "
                                                   "int)"}
    assert trace.device_busy_us(prof) == 12.0 + 13.0
    assert trace.kernel_base_name("void kau_partial_kernel<4>(float const*, int)") \
        == "kau_partial_kernel"
    assert trace.kernel_base_name("wgram_reduce_kernel(float const*)") == "wgram_reduce_kernel"
    # as the card's traces name the port's kernels (csrc/*.cu keep them in an
    # anonymous namespace)
    assert trace.kernel_base_name("void (anonymous namespace)::leverage_reg_kernel<32>(float "
                                  "const*, float const*, float*, long long, int)") \
        == "leverage_reg_kernel"
    assert trace.kernel_base_name("(anonymous namespace)::categorical_merge_kernel(float "
                                  "const*, int const*)") == "categorical_merge_kernel"
    assert trace.kernel_base_name("void at::native::reduce_kernel<512, 1>(at::native::"
                                  "ReduceOp<float>)") == "reduce_kernel"
    assert np.isclose(trace.device_busy_us(_prof([])), 0.0)
