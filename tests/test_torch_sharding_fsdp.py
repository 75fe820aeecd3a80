"""FSDP over ``torch.distributed`` (``repro_torch.sharding.fsdp``) on the
CPU with gloo: the reduced ``llama3.2-1b`` and ``whisper-medium`` train
steps, ``fsdp=True``, their parameters held per the reference's rules at
sizes ``{"pod": 1, "data": D, "model": 1}``.

* A world of one (in this process): every parameter a DTensor sharded as
  its spec says; the loss, every gradient and every updated parameter bit
  for bit the groupless step's, in modes ``none`` and ``coreset``.
* A world of two (two subprocesses meeting in a ``FileStore`` under the
  test's directory, each killed past ``RANK_TIMEOUT_S``): a step in mode
  ``none`` with the batch split over the ranks, against the unsharded
  full-batch step: the ranks' mean loss within ``1e-5`` (relative), every
  gradient within ``1e-4`` of its leaf's largest |g|, every parameter
  after the step within ``2 lr + 1e-5``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import rng
from repro_torch.configs import get_arch
from repro_torch.core.selector import SelectorConfig
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.sharding import specs
from repro_torch.sharding.fsdp import data_dim, fully_shard_model
from repro_torch.train import make_train_step

SRC = Path(__file__).resolve().parent.parent / "src"
RANK_TIMEOUT_S = 120
ARCHS = ["llama3.2-1b", "whisper-medium"]
LR = 1e-3
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).reduced(), fsdp=True)


def _model(cfg):
    return api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def _batch(cfg, seed=5):
    g = np.random.default_rng(seed)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    if cfg.kind == "encdec":
        batch["prefix_embeds"] = torch.from_numpy(
            g.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32))
    return batch


def _step(cfg, model, batch, mode):
    sel = None if mode == "none" else SelectorConfig(mode=mode, fraction=0.5)
    state = {"params": model, "opt": adamw_init(model), "step": torch.zeros((), dtype=torch.int32)}
    _, met = make_train_step(cfg, constant(LR), sel)(state, batch, rng.PRNGKey(7))
    return met


@pytest.mark.parametrize("mode", ["none", "coreset"])
@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_is_the_groupless_step_bit_for_bit(arch, mode):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    cfg = _cfg(arch)
    batch = _batch(cfg)
    plain = _model(cfg)
    met = _step(cfg, plain, batch, mode)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        sharded = fully_shard_model(_model(cfg), cfg, mesh)
        want = specs.module_specs(api.init_params(cfg, device="meta"), cfg,
                                  sizes=specs.mesh_sizes(mesh))
        for name, p in sharded.named_parameters():
            assert isinstance(p, DTensor) and p.placements == (Shard(data_dim(want[name])),), name
        met_s = _step(cfg, sharded, batch, mode)
        assert torch.equal(met_s["loss"], met["loss"])
        for (name, p), q in zip(sharded.named_parameters(), plain.parameters()):
            assert torch.equal(p.grad.full_tensor(), q.grad), name
            assert torch.equal(p.full_tensor(), q), name
    finally:
        dist.destroy_process_group()


def test_fully_shard_model_refuses_a_mesh_without_data_or_with_pods():
    class Mesh:
        def __init__(self, names, sizes):
            self.mesh_dim_names, self._sizes = names, sizes

        def size(self, i):
            return self._sizes[i]

    cfg = _cfg("llama3.2-1b")
    with pytest.raises(ValueError, match="'data' dim"):
        fully_shard_model(_model(cfg), cfg, Mesh(("model",), (2,)))
    with pytest.raises(ValueError, match="2 pods"):
        fully_shard_model(_model(cfg), cfg, Mesh(("pod", "data"), (2, 2)))


_RANK = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import rng
from repro_torch.configs import get_arch
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.sharding.fsdp import fully_shard_model
from repro_torch.train import make_train_step

rank, world, store_path, data_path, out_dir = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (1, world, 1), mesh_dim_names=("pod", "data", "model"))
data = np.load(data_path)
report = {}
for arch in ("llama3.2-1b", "whisper-medium"):
    cfg = dataclasses.replace(get_arch(arch).reduced(), fsdp=True)
    model = api.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    fully_shard_model(model, cfg, mesh)
    state = {"params": model, "opt": adamw_init(model), "step": torch.zeros((), dtype=torch.int32)}
    rows = slice(rank * int(data["B"]) // world, (rank + 1) * int(data["B"]) // world)
    batch = {k.split("|")[1]: torch.from_numpy(data[k][rows]) for k in data.files
             if k.startswith(arch + "|")}
    state, met = make_train_step(cfg, constant(float(data["lr"])))(state, batch, rng.PRNGKey(7))
    loss = met["loss"].clone()
    dist.all_reduce(loss)
    grads = {n: p.grad.full_tensor().numpy() for n, p in model.named_parameters()}
    params = {n: p.full_tensor().detach().numpy() for n, p in model.named_parameters()}
    if rank == 0:
        np.savez(f"{out_dir}/{arch}.npz", loss=(loss / world).numpy(),
                 **{"g|" + n: v for n, v in grads.items()},
                 **{"p|" + n: v for n, v in params.items()})
    report[arch] = {n: [str(pl) for pl in p.placements] for n, p in model.named_parameters()}
dist.destroy_process_group()
print(json.dumps(report))
'''


def test_world_of_two_on_gloo_matches_the_unsharded_step(tmp_path):
    batches = {arch: _batch(_cfg(arch), seed=9) for arch in ARCHS}
    data = tmp_path / "data.npz"
    np.savez(data, B=B, lr=LR, **{f"{arch}|{k}": v.numpy() for arch, b in batches.items()
                                  for k, v in b.items()})
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    env = {**os.environ, "PYTHONPATH": str(SRC)}     # keeps HOME and TMPDIR
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp_path / "store"), str(data),
         str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
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
    for arch in ARCHS:
        cfg = _cfg(arch)
        placed = reports[0][arch]
        assert placed["embed"] == ["S(1)"] and placed["layers.0.attn.wo"] == ["S(1)"]
        assert placed["layers.1.ffn.w_up"] == ["S(0)"]
        model = _model(cfg)
        met = _step(cfg, model, batches[arch], "none")
        got = np.load(tmp_path / f"{arch}.npz")
        assert abs(float(got["loss"]) - float(met["loss"])) <= 1e-5 * abs(float(met["loss"]))
        for n, p in model.named_parameters():
            want = p.grad.numpy()
            np.testing.assert_allclose(got["g|" + n], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(), err_msg=f"{arch} {n}")
            assert np.abs(got["p|" + n] - p.detach().numpy()).max() <= 2 * LR + 1e-5, n
