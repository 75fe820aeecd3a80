"""The port's production mesh and dry-run inputs (``repro_torch.launch.mesh``,
``repro_torch.launch.inputs``, ``dryrun.argument_bytes_per_device``)
against the reference's ``repro.launch`` on the CPU.

* ``production_mesh_shape`` is what the reference's ``make_production_mesh``
  passes to ``jax.make_mesh`` (captured by replacing ``jax.make_mesh``
  inside the test); ``dp_axes`` is equal; ``make_debug_mesh(1, 1,
  device_type="cpu")`` builds in a gloo world of one, and the production
  mesh refuses that world, naming the one it needs.
* ``input_specs`` / ``prefill_specs`` have the reference's keys, shapes and
  (at full width) dtypes for every arch x shape.
* ``cache_specs`` and ``state_specs`` are ``meta`` tensors matching the
  reference's ``jax.eval_shape`` trees leaf for leaf (the port's parameter
  names mapped through ``specs.ref_path`` / ``stacked_shapes``), with equal
  byte totals, at reduced and at full width.
* ``argument_bytes_per_device`` is the same ceil-divided shard arithmetic
  over the reference's ``param_shardings`` / ``batch_shardings`` /
  ``cache_shardings`` of the reference's trees, part for part; only the
  PRNG key differs (the port's is two int64 words, the reference's two
  uint32).
"""

import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.mesh as jmesh
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch import inputs as jinputs
from repro.sharding import specs as jspecs
from repro_torch.configs import INPUT_SHAPES, all_arch_names, get_arch
from repro_torch.launch import dryrun, inputs, mesh
from repro_torch.sharding import specs

ARCHS = all_arch_names()
SHAPES = list(INPUT_SHAPES)
DECODE = [s for s in SHAPES if INPUT_SHAPES[s].is_decode]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dt(dtype) -> str:
    """A dtype's name in both packages: ``torch.bfloat16`` / jax's
    ``bfloat16`` -> ``bfloat16``."""
    return str(dtype).split(".")[-1]


def _cfgs(arch, width):
    jc, tc = j_get_arch(arch), get_arch(arch)
    return (jc.reduced(), tc.reduced()) if width == "reduced" else (jc, tc)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_is_the_references(multi_pod, monkeypatch):
    seen = []
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: seen.append((shape, axes)))
    jmesh.make_production_mesh(multi_pod=multi_pod)
    assert seen == [mesh.production_mesh_shape(multi_pod)]
    assert mesh.dp_axes(multi_pod) == jmesh.dp_axes(multi_pod)


def test_debug_mesh_in_a_gloo_world_of_one_and_the_production_mesh_refuses_it():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="needs a world of 256 ranks; this process has no "
                                           "process group"):
        mesh.make_production_mesh(device_type="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        m = mesh.make_debug_mesh(1, 1, device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
        assert m.device_type == "cpu"
        with pytest.raises(RuntimeError, match=r"2x16x16 \('pod', 'data', 'model'\) needs a "
                                               r"world of 512 ranks; this process has a world "
                                               r"of 1"):
            mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the inputs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_prefill_specs_are_the_references(arch, shape):
    jc, tc = j_get_arch(arch), get_arch(arch)
    for jfn, tfn in ((jinputs.input_specs, inputs.input_specs),
                     (jinputs.prefill_specs, inputs.prefill_specs)):
        want = jfn(jc, J_SHAPES[shape])
        got = tfn(tc, INPUT_SHAPES[shape])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert _dt(t.dtype) == _dt(want[k].dtype), k
    assert inputs.key_spec().shape == (2,) and inputs.key_spec().dtype == torch.int64


def _ref_leaves(tree):
    """{path joined by '/': (shape, dtype name)} of a reference pytree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): (tuple(x.shape), _dt(x.dtype))
            for path, x in leaves}


def _port_state_leaves(state):
    """The port's state as the reference's tree: the parameters and moments
    keyed by reference path, each layer stack's leaves stacked on L."""
    def stacked(named):
        tree = specs.stacked_tree(((n, (tuple(t.shape), _dt(t.dtype))) for n, t in named),
                                  lambda v: ((len(v), *v[0][0]), v[0][1]))
        return specs.flat_specs(tree)

    out = {}
    for prefix, named in (("params", state["params"].named_parameters()),
                          ("opt/m", state["opt"]["m"].items()),
                          ("opt/v", state["opt"]["v"].items())):
        out.update({f"{prefix}/{k}": v for k, v in stacked(named).items()})
    for k in ("opt/step", "step"):
        t = state["opt"]["step"] if k == "opt/step" else state["step"]
        out[k] = (tuple(t.shape), _dt(t.dtype))
    return out


def _bytes(leaves):
    return sum(math.prod(s) * torch.empty((), dtype=getattr(torch, d)).element_size()
               for s, d in leaves.values())


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_cache_specs_match_the_references_leaf_for_leaf(arch, width):
    jc, tc = _cfgs(arch, width)
    state = inputs.state_specs(tc)
    tensors = [*state["params"].parameters(), *state["opt"]["m"].values(),
               *state["opt"]["v"].values(), state["opt"]["step"], state["step"]]
    assert all(t.device.type == "meta" for t in tensors)
    want = _ref_leaves(jinputs.state_specs(jc))
    got = _port_state_leaves(state)
    assert got == want
    assert _bytes(got) == _bytes(want)
    for shape in DECODE:
        jshape, tshape = J_SHAPES[shape], INPUT_SHAPES[shape]
        cache = inputs.cache_specs(tc.for_shape(tshape), tshape)
        leaves = specs.flat_specs(cache)
        assert all(t.device.type == "meta" for t in leaves.values())
        got = {p: (tuple(t.shape), _dt(t.dtype)) for p, t in leaves.items()}
        want = _ref_leaves(jinputs.cache_specs(jc.for_shape(jshape), jshape))
        assert got == want, shape
        assert _bytes(got) == _bytes(want)


# --------------------------------------------------------------------------
# one device's arguments
# --------------------------------------------------------------------------

def _ref_shard_bytes(shape, itemsize, spec, sizes=jspecs.MESH_SIZES):
    n = itemsize
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


def _ref_tree_bytes(tree, spec_tree):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_ref_shard_bytes(x.shape, x.dtype.itemsize, tuple(s))
               for x, s in zip(leaves, spec_leaves))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_per_device_are_the_references_arithmetic(arch, multi_pod):
    jc, tc = j_get_arch(arch), get_arch(arch)
    jstate = jinputs.state_specs(jc)
    pspec = jspecs.param_shardings(jstate["params"], jc, multi_pod)
    for name in SHAPES:
        jshape, tshape = J_SHAPES[name], INPUT_SHAPES[name]
        jcs, tcs = jc.for_shape(jshape), tc.for_shape(tshape)
        got = dryrun.argument_bytes_per_device(tcs, tshape, dryrun.step_args(tcs, tshape),
                                               multi_pod)
        assert got["params"] == _ref_tree_bytes(jstate["params"], pspec), name
        jbatch = jinputs.input_specs(jcs, jshape)
        if jshape.phase == "prefill":
            jbatch = jinputs.prefill_specs(jcs, jshape)
        bspec = jspecs.batch_shardings(jcs, jshape, multi_pod)
        assert got["batch"] == sum(_ref_shard_bytes(x.shape, x.dtype.itemsize, tuple(bspec[k]))
                                   for k, x in jbatch.items()), name
        if jshape.phase == "train":
            assert got["opt"] == 2 * _ref_tree_bytes(
                jstate["opt"]["m"], jspecs.opt_shardings(
                    jspecs.param_shardings(jstate["opt"]["m"], jc, multi_pod)))
            assert got["steps"] == 8 and got["key"] == 16      # the reference's key: 8
        if jshape.is_decode:
            jcache = jinputs.cache_specs(jcs, jshape)
            assert got["cache"] == _ref_tree_bytes(
                jcache, jspecs.cache_shardings(jcache, jcs, jshape, multi_pod)), name
        assert got["total"] == sum(v for k, v in got.items() if k != "total")
