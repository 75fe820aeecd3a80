"""The frozen yardsticks pinned to golden values: the bound arithmetic
copied from ``chip_smoke.py``, the trace reading copied from the port's
``launch/trace.py``, and the reference's threefry against the port's
``rng`` (draw for draw)."""

import math

import pytest
import torch

from benchlib import tracing, yardstick
from reference import threefry


def test_k5_bound_at_the_yearprediction_draw():
    """PERF.md's K5 bound: (3, 463,715) x 5000 rows, 12.6137 ms, op-bound."""
    n, m, T = 463_715, 5000, 3
    s = yardstick.categorical_bound_s(m * n, 4 * T * n + 8 * m + 8 * T + 16 * T)
    assert s * 1e3 == pytest.approx(12.6137, abs=5e-5)
    assert (yardstick.K5_INT32_OPS, yardstick.K5_FP32_OPS) == (91, 70)


def test_bound_arithmetic_golden():
    assert yardstick.gram_flops(5000, 90) == 5000 * 90 * 91 + 5000 * 90
    assert yardstick.kmeans_flops(10, 10, 90, True) == 10 * (1800 + 180 + 30 + 183)
    assert yardstick.kmeans_bytes(3, 100, 10, 30, True, 0, True) == (
        4 * (9000 + 900) + 2400 + 4 * 3 * 320)
    # K3 at (463,715, 90): 0.0573 ms, bound by operations (PERF.md)
    n, d = 463_715, 90
    s = yardstick.bound_s(4 * (n * d + n + d * d), yardstick.gram_flops(n, d))
    assert s * 1e3 == pytest.approx(0.0573, abs=5e-5)


def _ev(name, a, b, dev=True):
    return tracing.Event(name, a, b, dev)


def test_busy_time_is_the_union_of_intervals():
    evs = [_ev("k1", 0, 10), _ev("k2", 5, 15), _ev("k3", 12, 14), _ev("k4", 20, 30),
           _ev("bench.fit", 0, 40, False)]
    assert tracing.device_busy_us(evs, 0, 40) == 25
    assert tracing.device_busy_us(evs, 8, 25) == 12          # clipped to the slice
    assert tracing.idle_gaps(evs, 0, 40) == [(15, 20), (30, 40)]


def test_kernel_base_name_and_breakdown():
    assert tracing.kernel_base_name(
        "void (anonymous namespace)::kau_partial_kernel<4>(float const*, int)") == \
        "kau_partial_kernel"
    evs = [_ev("bench.request", 0, 100, False), _ev("bench.fit", 50, 100, False),
           _ev("void categorical_row_kernel(Draw, long long*)", 0, 30),
           _ev("void categorical_row_kernel(Draw, long long*)", 35, 45),
           _ev("Memcpy DtoH (Device -> Pageable)", 60, 61)]
    b = tracing.breakdown(evs, 0, 100)
    assert b["device_ops"][0] == ["categorical_row_kernel", 40e-6]
    assert b["idle_gaps"][0] == ["fit", 39e-6]
    assert b["idle_gaps"][1:] == [["fit", 15e-6], ["request", 5e-6]]


def test_threefry_copy_matches_the_port():
    from repro_torch import rng

    key = (0x12345678, 0x9ABCDEF0)
    kt = torch.tensor(key, dtype=torch.int64)
    assert [tuple(k) for k in rng.split(kt, 5).tolist()] == threefry.split(key, 5)
    assert tuple(rng.fold_in(kt, 7).tolist()) == threefry.fold_in(key, 7)
    for size in (11, 12, 1001):
        pos = torch.arange(size, dtype=torch.int64)
        assert torch.equal(rng.random_bits(kt, (size,)), threefry.bits_at(key, pos, size))


def test_reference_draw_matches_the_port_draw():
    """float64 gumbels against the port's float32 ones: the same winners
    away from near ties (these logits have none)."""
    from repro_torch import rng

    g = torch.Generator().manual_seed(5)
    logits = torch.randn(997, generator=g) * 3
    key = (7, 11)
    want = rng.categorical_plain(torch.tensor(key), logits, 40, take=25)
    got = threefry.draw(key, logits, 40, torch.arange(25))
    assert torch.equal(want, got)
    g32 = rng._gumbel_of(rng.random_bits(torch.tensor(key), (50,)))
    g64 = threefry.gumbel(threefry.bits_at(key, torch.arange(50), 50))
    assert torch.allclose(g32.double(), g64, rtol=1e-6, atol=1e-6)
    assert math.isfinite(float(g64.max()))
