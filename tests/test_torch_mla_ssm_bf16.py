"""The MLA, RWKV-6 and Hymba blocks in bfloat16 (``param_dtype=
torch.bfloat16``, the dtype they serve and train in on the card) against
the reference's bf16 blocks on the CPU: reduced ``deepseek-v2-236b``
(MLA + MoE), ``rwkv6-3b`` and ``hymba-1.5b``, from the same bf16 weights
(``convert.lm_params_from_numpy`` of the reference's init) and tokens.

The reference's block is compiled with ``xla_allow_excess_precision``
off, which rounds every bf16 op as its eager evaluation does and as the
port does (``tests/test_torch_lm_bf16.py``).  Each block is fed the
reference's own bf16 input (the previous block's output):

* **Forward.**  No element more than ``BLOCK_TOL`` = 2**-6 x max |y|
  from the reference's block (two bf16 ulps at the largest magnitude),
  and at least ``EXACT_ROWS`` of the token rows bit for bit.
* **Backward.**  One bf16 cotangent a block, against ``jax.vjp`` of the
  reference's block: the input's gradient and every parameter's (the
  float32 leaves too) within ``GRAD_TOL`` = 2**-5 of the leaf's largest
  |g|, the bound ``tests/test_torch_train_bf16.py`` holds a step's
  gradients to.

Measured, the worst layer of two: forward 4.1e-3 (deepseek), 4.5e-3
(rwkv), 5.7e-3 (hymba) of max |y|, with 94 %, 84 % and 97 % of the rows
bit for bit; gradients 1.1e-2 (deepseek, the input's), 2.0e-2 (rwkv,
``mix_w``: its gradient sums the decay path over every token), 1.3e-2
(hymba, ``attn_norm``).  The float32 parts of the mixers — the WKV chunk
algebra, the absorbed products, the Mamba scan — agree to float32
rounding; what differs is where a bf16 rounding lands after a sum taken
in another order.  The Mamba chunk's scan runs in the reference's own
odd/even order (``ssm._linear_scan``, bit for bit ``jax.lax.
associative_scan`` in float32, ``tests/test_torch_ssm.py``), so it moves
nothing: Hymba's second block is bit for bit the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm

CPU = torch.device("cpu")
BLOCK_TOL = 2.0 ** -6
GRAD_TOL = 2.0 ** -5
EXACT_ROWS = 0.75
B, S = 2, 16
ARCHS = ["deepseek-v2-236b", "rwkv6-3b", "hymba-1.5b"]


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


def _bf16(a) -> torch.Tensor:
    """A jax bf16 array as a torch bf16 tensor, through its 16-bit words."""
    words = np.array(np.asarray(a)).view(np.int16)
    return torch.from_numpy(words).view(torch.bfloat16)


def _f32(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32)


def _strict(fn, *args):
    """``fn`` compiled for ``args``' shapes with every bf16 op rounded (no
    excess precision kept between fused ops)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _pair(arch):
    jc = dataclasses.replace(j_get_arch(arch).reduced(), param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_arch(arch).reduced(), param_dtype=torch.bfloat16)
    params = japi.init_params(jax.random.PRNGKey(3), jc)
    model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc, CPU)
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, params, model, toks


def _layer(params, i):
    return jax.tree_util.tree_map(lambda a: a[i], params["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_blocks_match_the_reference(arch):
    jc, tc, params, model, toks = _pair(arch)
    x = params["embed"][toks]
    block = lambda x, p: jlm._layer_fwd(jc, x, p, jnp.arange(S))[0]

    def pull(x, p, ct):
        return jax.vjp(block, x, p)[1](ct)

    cts = jax.random.normal(jax.random.PRNGKey(1), (jc.num_layers,) + x.shape, jnp.bfloat16)
    fwd = _strict(block, x, _layer(params, 0))
    pull = _strict(pull, x, _layer(params, 0), cts[0])
    rows = exact = 0
    for i, p_t in enumerate(model.layers):
        y = fwd(x, _layer(params, i))
        xt = _bf16(x).requires_grad_(True)
        yt, _ = lm._layer_fwd(tc, xt, p_t, torch.arange(S))
        assert yt.dtype == torch.bfloat16
        got, want = _f32(yt.detach()), _f32(y)
        gap = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert gap <= BLOCK_TOL, f"{arch} forward layer {i}: {gap:.3e}"
        same = np.all(got == want, axis=-1)
        rows, exact = rows + same.size, exact + int(same.sum())

        gx, gp = pull(x, _layer(params, i), cts[i])
        p_t.zero_grad(set_to_none=True)
        yt.backward(_bf16(cts[i]))
        gaps = {"x": float(np.abs(_f32(xt.grad) - _f32(gx)).max() / np.abs(_f32(gx)).max())}
        for name, p in p_t.named_parameters():
            ref = gp
            for part in name.split("."):
                ref = ref[part]
            assert p.grad.dtype == p.dtype, name
            gaps[name] = float(np.abs(_f32(p.grad) - _f32(ref)).max() / np.abs(_f32(ref)).max())
        bad = {k: v for k, v in gaps.items() if not v <= GRAD_TOL}
        assert not bad, f"{arch} layer {i}: gradients beyond {GRAD_TOL}: {bad}"
        p_t.zero_grad(set_to_none=True)
        x = y
    assert exact >= EXACT_ROWS * rows, f"{arch}: {exact} of {rows} rows bit for bit"
