"""The H100 peaks and the bound arithmetic, frozen here so that the
yardstick does not move with the program.

Copied from ``chip_smoke.py`` (its peaks, ``K5_INT32_OPS``,
``K5_FP32_OPS``, ``categorical_bound_ms``, ``bound_ms``, ``gram_flops``,
``kmeans_flops`` and ``kmeans_bytes``), in seconds where the original
gives milliseconds.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# The operation rates behind them, per second on 132 SMs at the 1.98 GHz
# boost clock: 128 fp32 operations per SM and clock (the data sheet's
# 67 TFLOP/s counts an FMA as two), 64 int32 ones, and 4 warp schedulers
# issuing one instruction of 32 threads each per clock.
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# The least work of one gumbel-max candidate of the DIS draw, counted from
# the algorithm (the counter pair 8, threefry2x32 2 + 60 + 10, its lane
# select 1, the uniform's mantissa 2, each log's fields 2 x 3, the running
# maximum's selects 2: 91 int32; the uniform 3, each log 32, the logit,
# the compare and its NaN test 3: 70 fp32).
K5_INT32_OPS = 8 + (2 + 20 * 3 + 5 * 2) + 1 + 2 + 2 * 3 + 2
K5_FP32_OPS = 3 + 2 * 32 + 3


def categorical_bound_s(candidates: float, nbytes: float) -> float:
    """Least seconds for ``candidates`` gumbel-max candidates: their int32
    and fp32 operations over their pipes' rates, all of them over the
    schedulers' issue rate, or the bytes, whichever is longest."""
    t_ops = max(candidates * K5_INT32_OPS / INT32_OPS_PER_S,
                candidates * K5_FP32_OPS / FP32_OPS_PER_S,
                candidates * (K5_INT32_OPS + K5_FP32_OPS) / ISSUE_PER_S)
    return max(t_ops, nbytes / HBM_BYTES_PER_S)


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work: its bytes at HBM bandwidth or its fp32
    operations at the peak rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def gram_flops(n: int, d: int) -> int:
    """Least fp32 operations for G = X^T diag(w) X: n d products w_i x_i,
    then n multiply-adds for each of the d(d+1)/2 entries of one triangle."""
    return n * d * (d + 1) + n * d


def kmeans_flops(n: int, k: int, d: int, fused: bool) -> int:
    """fp32 operations of one assignment sweep: x.c for k centers (2kd),
    ||x||^2 (2d) and the combination (3k) per row; the fused update adds
    w x into csum (2d), w into wsum and w d2 into ccost (3) per row."""
    return n * (2 * k * d + 2 * d + 3 * k + ((2 * d + 3) if fused else 0))


def kmeans_bytes(B: int, n: int, k: int, d: int, c_batched: bool,
                 w_rows: int, fused: bool) -> int:
    """Bytes read once (X, C, the weights) and written once (assign, d2
    and, fused, the per-cluster sums)."""
    read = 4 * (B * n * d + (B if c_batched else 1) * k * d + w_rows)
    return read + 8 * B * n + (4 * B * (k * d + 2 * k) if fused else 0)
