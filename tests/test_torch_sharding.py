"""The port's partition rules and activation hooks (``repro_torch.sharding``)
against the reference's ``repro.sharding`` on the CPU.

* Every parameter, optimizer-moment, batch and cache spec of every catalog
  config x ``INPUT_SHAPES`` x ``multi_pod`` equals the reference's
  ``PartitionSpec`` (as a tuple), path for path: the reference's shapes
  from ``jax.eval_shape``, the port's from a ``meta``-device model, its
  layers stacked on L as the reference's (``specs.stacked_shapes``).
* The reference's ``tests/test_sharding.py`` sanitizer and expert-policy
  tests, restated.
* Each hook under a ``ShardingCtx``: the specs the port's model code asks
  for (captured at ``ctx.constrain``) are the reference's (captured by
  replacing ``jax.lax.with_sharding_constraint`` inside the test while
  tracing its forward and decode with ``jax.eval_shape``), in order of
  first appearance (the reference traces its layer scan's body once, the
  port calls every layer).
* A per-layer tensor's spec drops the stacked dim 0 only when that dim is
  unsharded; otherwise ``layer_spec`` raises naming the leaf.
* ``placements`` maps a spec onto DTensor placements per mesh dim.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch.inputs import cache_specs, state_specs
from repro.models import api as japi
from repro.sharding import ctx as jctx
from repro.sharding import specs as jspecs
from repro_torch.configs import INPUT_SHAPES, all_arch_names, get_arch
from repro_torch.models import api
from repro_torch.optim import adamw_init
from repro_torch.sharding import ctx, specs

ARCHS = all_arch_names()
SHAPES = list(INPUT_SHAPES)


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


def _ref_flat(tree):
    """{path joined by '/': tuple(spec)} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}


_STATE = {}


def _ref_state(arch):
    if arch not in _STATE:
        _STATE[arch] = state_specs(j_get_arch(arch))
    return _STATE[arch]


_META = {}


def _meta(arch):
    if arch not in _META:
        _META[arch] = api.init_params(get_arch(arch), device="meta")
    return _META[arch]


# --------------------------------------------------------------------------
# the spec tables against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_equal_the_reference(arch, multi_pod):
    jc, tc = j_get_arch(arch), get_arch(arch)
    jstate = _ref_state(arch)
    want = _ref_flat(jspecs.param_shardings(jstate["params"], jc, multi_pod))
    model = _meta(arch)
    got = specs.flat_specs(specs.param_shardings(specs.stacked_shapes(model), tc, multi_pod))
    assert got == want
    jm = _ref_flat(jspecs.opt_shardings(jspecs.param_shardings(jstate["opt"]["m"], jc, multi_pod)))
    m = adamw_init(model)["m"]
    assert all(t.device.type == "meta" for t in m.values())
    gm = specs.flat_specs(specs.opt_shardings(specs.param_shardings(specs.stacked_shapes(m), tc,
                                                                    multi_pod)))
    assert gm == jm == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, shape):
    jshape, tshape = J_SHAPES[shape], INPUT_SHAPES[shape]
    jc, tc = j_get_arch(arch).for_shape(jshape), get_arch(arch).for_shape(tshape)
    jcache = cache_specs(jc, jshape)
    cache = api.init_cache(tc, tshape.global_batch, tshape.seq_len, device="meta")
    assert all(t.device.type == "meta" for t in cache["layers"].values())
    for mp in (False, True):
        want = {k: tuple(v) for k, v in jspecs.batch_shardings(jc, jshape, mp).items()}
        assert specs.batch_shardings(tc, tshape, mp) == want
        want = _ref_flat(jspecs.cache_shardings(jcache, jc, jshape, mp))
        assert specs.flat_specs(specs.cache_shardings(cache, tc, tshape, mp)) == want


def test_sanitize_drops_uneven():
    assert specs.sanitize(("model",), (40,)) == (None,) == tuple(jspecs.sanitize(P("model"), (40,)))
    assert specs.sanitize(("model",), (64,)) == ("model",)
    assert specs.sanitize((("pod", "data"),), (64,)) == (("pod", "data"),)
    assert specs.sanitize((("pod", "data"),), (48,)) == (None,)
    assert specs.sanitize((("data",), None), (48, 3)) == ("data", None)


def test_expert_sharding_policy():
    """deepseek (E=160) experts go expert-parallel; granite (E=40) falls
    back to ffn-dim sharding."""
    for arch, expert_parallel in (("deepseek-v2-236b", True), ("granite-moe-3b-a800m", False)):
        cfg = get_arch(arch)
        wg = specs.param_shardings(specs.stacked_shapes(_meta(arch)), cfg, False)[
            "layers"]["moe"]["w_gate"]
        if expert_parallel:
            assert wg[1] == "model", wg
        else:
            assert wg[1] != "model" and "model" in wg, wg


def test_fsdp_and_pure_fsdp_rules_at_other_sizes():
    """The FSDP variants at a world's own sizes, against the reference's
    at the same sizes."""
    sizes = {"pod": 1, "data": 2, "model": 1}
    for arch in ("llama3.2-1b", "whisper-medium", "hymba-1.5b"):
        for extra in ({"fsdp": True}, {"pure_fsdp": True}):
            jc = dataclasses.replace(j_get_arch(arch).reduced(), **extra)
            tc = dataclasses.replace(get_arch(arch).reduced(), **extra)
            jshape = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
            for mp in (False, True):
                want = _ref_flat(jspecs.param_shardings(jshape, jc, mp, sizes))
                got = specs.flat_specs(specs.param_shardings(
                    specs.stacked_shapes(api.init_params(tc, device="meta")), tc, mp, sizes))
                assert got == want, (arch, extra, mp)


# --------------------------------------------------------------------------
# per-layer specs, placements
# --------------------------------------------------------------------------

def test_layer_spec_drops_an_unsharded_layer_axis():
    assert specs.layer_spec("layers/attn/wq", (None, "data", "model")) == ("data", "model")
    assert specs.layer_spec("enc_layers/ffn/w_up", (None, None, "model")) == (None, "model")
    assert specs.layer_spec("embed", ("model", "data")) == ("model", "data")
    ms = specs.module_specs(api.init_params(dataclasses.replace(
        get_arch("whisper-medium").reduced(), fsdp=True), device="meta"),
        get_arch("whisper-medium").reduced(), sizes={"pod": 1, "data": 2, "model": 1})
    assert ms["enc_layers.1.attn.wo"] == ("model", None)
    assert ms["layers.0.cross.wk"] == (None, "model")


def test_layer_spec_raises_naming_a_leaf_sharded_on_the_layer_axis():
    """Under ``pure_fsdp`` hymba's A_log (32, 1600, 16) takes ``data`` on
    d_inner and then ``model`` on dim 0 (the layers), as the reference's
    rule gives it (its norms too); a per-layer tensor cannot hold that, and
    the port says which leaf."""
    cfg = dataclasses.replace(get_arch("hymba-1.5b"), pure_fsdp=True)
    flat = specs.flat_specs(specs.param_shardings(specs.stacked_shapes(_meta("hymba-1.5b")),
                                                  cfg, False))
    jc = dataclasses.replace(j_get_arch("hymba-1.5b"), pure_fsdp=True)
    assert tuple(_ref_flat(jspecs.param_shardings(_ref_state("hymba-1.5b")["params"], jc,
                                                  False))["layers/mamba/A_log"]) \
        == flat["layers/mamba/A_log"] == ("model", "data", None)
    with pytest.raises(ValueError, match="layers/mamba/A_log: the rule shards the stacked "
                                         "layer axis"):
        specs.layer_spec("layers/mamba/A_log", flat["layers/mamba/A_log"])
    # the first such leaf in the model's order: the norms (32, 1600) too
    assert flat["layers/attn_norm"] == ("model", "data")
    with pytest.raises(ValueError, match="^layers/attn_norm: "):
        specs.module_specs(_meta("hymba-1.5b"), cfg)


def test_ref_path_and_stacked_shapes():
    assert specs.ref_path("layers.3.attn.wq") == ("layers/attn/wq", 3)
    assert specs.ref_path("enc_layers.0.ffn.w_up") == ("enc_layers/ffn/w_up", 0)
    assert specs.ref_path("pos_embed") == ("pos_embed", None)
    tree = specs.stacked_shapes(_meta("whisper-medium"))
    assert tree["enc_layers"]["attn"]["wq"] == (24, 1024, 1024)
    assert tree["layers"]["cross"]["wo"] == (24, 1024, 1024)
    assert tree["embed"] == (51968, 1024)


class _Mesh:
    """Stands in for a ``DeviceMesh``: its named dims and their sizes."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(("pod", "data", "model"), (1, 2, 4))
    assert specs.placements((None, "data", "model"), mesh) == (Replicate(), Shard(1), Shard(2))
    assert specs.placements((("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert specs.placements(("model", None), _Mesh(("data",), (2,))) == (Replicate(),)
    assert specs.placements((), mesh) == (Replicate(),) * 3
    assert specs.mesh_sizes(_Mesh(("data",), (8,))) == {"pod": 1, "data": 8, "model": 1}
    with pytest.raises(ValueError, match="named dims"):
        specs.placements(("data",), _Mesh(None, (2,)))


# --------------------------------------------------------------------------
# the hooks under a context, against the reference's
# --------------------------------------------------------------------------

CTXS = {"dp": dict(), "pod_seq": dict(dp_axes=("pod", "data"), seq_axis="data")}


def _ref_specs(monkeypatch, arch, ctx_kw, B, S):
    """The reference's constraints, in order of first appearance, while
    tracing its loss and one decode step under ``ShardingCtx(**ctx_kw)``."""
    jc = j_get_arch(arch).reduced()
    seen = []

    def record(x, spec):
        seen.append((tuple(spec), tuple(x.shape)))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if jc.frontend != "none" or jc.kind == "encdec":
        batch["prefix_embeds"] = jax.ShapeDtypeStruct((B, jc.num_prefix, jc.d_model),
                                                      jnp.float32)
    pshape = jax.eval_shape(lambda k: japi.init_params(k, jc), jax.random.PRNGKey(0))
    cshape = jax.eval_shape(lambda: japi.init_cache(jc, B, S))
    tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    with jctx.set_ctx(jctx.ShardingCtx(**ctx_kw)):
        jax.eval_shape(lambda p, b: japi.loss_fn(p, jc, b)[0], pshape, batch)
        jax.eval_shape(lambda p, c, t: japi.decode_step(p, jc, c, t)[0], pshape, cshape, tok)
    monkeypatch.undo()
    return list(dict.fromkeys(seen))


def _port_specs(monkeypatch, arch, ctx_kw, B, S):
    tc = get_arch(arch).reduced()
    seen = []

    def record(x, spec):
        seen.append((tuple(spec), tuple(x.shape)))
        return x

    monkeypatch.setattr(ctx, "constrain", record)
    model = api.init_params(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = np.random.default_rng(0)
    toks = torch.from_numpy(gen.integers(0, tc.vocab_size, (B, S)))
    batch = {"tokens": toks, "labels": toks}
    if tc.frontend != "none" or tc.kind == "encdec":
        batch["prefix_embeds"] = torch.from_numpy(
            gen.standard_normal((B, tc.num_prefix, tc.d_model)).astype(np.float32))
    cache = api.init_cache(tc, B, S, device="cpu")
    with torch.no_grad(), ctx.set_ctx(ctx.ShardingCtx(**ctx_kw)):
        api.loss_fn(model, tc, batch)
        api.decode_step(model, tc, cache, toks[:, :1])
    monkeypatch.undo()
    return list(dict.fromkeys(seen))


@pytest.mark.parametrize("ctx_name", list(CTXS))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "granite-moe-3b-a800m",
                                  "rwkv6-3b", "hymba-1.5b", "whisper-medium"])
def test_hooks_ask_for_the_reference_specs(arch, ctx_name, monkeypatch):
    B, S = 16, 16
    want = _ref_specs(monkeypatch, arch, CTXS[ctx_name], B, S)
    got = _port_specs(monkeypatch, arch, CTXS[ctx_name], B, S)
    assert want and got == want


def test_hooks_without_a_context_return_their_input():
    x = torch.zeros(16, 16, 4)
    assert ctx.current_ctx() is None
    for hook in (ctx.shard_batch_seq, ctx.shard_heads, ctx.shard_logits, ctx.shard_expert):
        assert hook(x) is x
    with ctx.set_ctx(ctx.ShardingCtx()):
        assert ctx.current_ctx() == ctx.ShardingCtx()
        for hook in (ctx.shard_batch_seq, ctx.shard_heads, ctx.shard_logits, ctx.shard_expert):
            assert hook(x) is x                       # a plain tensor is not moved
    assert ctx.current_ctx() is None


@pytest.mark.parametrize("shape", [(16, 16, 32), (3, 16, 16, 8), (32, 8, 5)])
def test_each_hook_direct_against_the_reference(shape, monkeypatch):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    monkeypatch.setattr(ctx, "constrain", lambda x, spec: seen.append(tuple(spec)) or x)
    hooks = ("shard_batch_seq", "shard_heads", "shard_logits", "shard_expert")
    for kw in CTXS.values():
        with jctx.set_ctx(jctx.ShardingCtx(**kw)), ctx.set_ctx(ctx.ShardingCtx(**kw)):
            for name in hooks:
                del seen[:]
                getattr(jctx, name)(jnp.zeros(shape))
                getattr(ctx, name)(torch.zeros(shape))
                assert len(seen) in (0, 2) and seen[:1] == seen[1:], (name, kw, seen)
