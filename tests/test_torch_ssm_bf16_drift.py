"""How far the RWKV-6 and Hymba models in bfloat16 drift from their float32
copies is the models' own property, not the port's: over 8 layers of the
reduced width, and in one layer of Hymba at its published width, the
reference's bf16 model lies as far from its float32 copy as the port's
does from its own, past the 0.06 x max |logit| that ``chip_smoke.py``
holds the dense and MoE models to (``LM_BF16_TOL``).  So phases 20 and 21
hold the bf16 forward at one layer to a bound above that drift
(``SSM_BF16_TOL``) and print it deeper.

Both packages start from one set of bf16 weights (the reference's init;
the float32 copy is those weights widened), on the same tokens; the
reference is jitted as it runs.  Measured (max |bf16 - float32| over the
float32 copy's max |logit|): rwkv6 7.5e-2 (reference) against 1.07e-1
(port); hymba 5.72e-1 against 5.74e-1; one layer of hymba at its published
width (seed 1) 9.84e-2 against 1.01e-1 (seeds 0, 2, 3 gave 3.5e-2 to
7.8e-2 for both).  Which bf16 roundings land where
differs between the packages (sums in another order), and the models
amplify any of them, so the two drifts are held to the same order: the
port's within ``RATIO`` of the reference's either way.  The float32 models
agree within ``F32_TOL`` x max |logit| (rwkv 7.7e-6, hymba 6.7e-5 over 8
layers, 1.2e-5 in the published-width layer: float32 rounding grows
through the layers too).
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

CPU = "cpu"
LAYERS = 8
LM_BF16_TOL = 0.06
RATIO = 2.0
F32_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def nonpartitionable():
    with jax.threefry_partitionable(False), torch.no_grad():
        yield


@pytest.mark.parametrize("arch,reduced,layers,seed", [
    ("rwkv6-3b", True, LAYERS, 0), ("hymba-1.5b", True, LAYERS, 0),
    ("hymba-1.5b", False, 1, 1)])
def test_bf16_drift_is_the_models_own(arch, reduced, layers, seed):
    size = (lambda c: c.reduced()) if reduced else (lambda c: c)
    jc16 = dataclasses.replace(size(j_get_arch(arch)), num_layers=layers,
                               param_dtype=jnp.bfloat16)
    jc32 = dataclasses.replace(jc16, param_dtype=jnp.float32)
    p16 = jax.jit(lambda k: japi.init_params(k, jc16))(jax.random.PRNGKey(seed))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    toks = np.random.default_rng(seed).integers(0, jc16.vocab_size, (4, 32)).astype(np.int32)

    def ref_logits(p, c):
        fn = jax.jit(lambda p, t: jlm.logits_of(p, c, jlm.forward(p, c, t)[0]))
        return np.asarray(fn(p, jnp.asarray(toks)))[..., :c.vocab_size]

    def port_logits(p, c):
        model = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, p), c, CPU)
        return model(torch.from_numpy(toks)).numpy()[..., :c.vocab_size]

    tc16 = dataclasses.replace(size(get_arch(arch)), num_layers=layers,
                               param_dtype=torch.bfloat16)
    tc32 = dataclasses.replace(tc16, param_dtype=torch.float32)
    r16, r32 = ref_logits(p16, jc16), ref_logits(p32, jc32)
    t16, t32 = port_logits(p16, tc16), port_logits(p32, tc32)
    scale = np.abs(r32).max()
    ref_drift = np.abs(r16 - r32).max() / scale
    port_drift = np.abs(t16 - t32).max() / np.abs(t32).max()
    assert np.abs(t32 - r32).max() <= F32_TOL * scale
    assert ref_drift > LM_BF16_TOL and port_drift > LM_BF16_TOL
    assert ref_drift / RATIO <= port_drift <= RATIO * ref_drift, (ref_drift, port_drift)
