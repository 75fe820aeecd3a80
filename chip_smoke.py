#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed S]

Run from the root of a checkout.  It imports the port (``src/repro_torch``)
and never JAX or the JAX package ``repro``.  Phases, each fatal on failure:

1. device: the card's name and count, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and load them;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and over a sweep of odd shapes, in full fp32
   (TF32 off), within the stated tolerance; two launches bitwise equal;
   weighted_gram's G exactly symmetric; each fast kernel equal bit for bit
   to its oracle at the main path's shapes (both timed), over the sweep and
   at ragged edges: kmeans_assign_update and kmeans_assign to their global
   variants (the same sums in the same order), leverage to its wide
   kernel; the general variants past the
   fast kernels' limits (leverage at s = 239, 256, 512; the k-means
   kernels at (k, d) = (425, 64), (2000, 64), (10, 2048) and one batched
   case, with assignments equal to the plain version's); CUDA-event times
   of the kernel, the plain version and one PyTorch library call
   computing the same function, beside the card's bound, at the main
   path's shapes and for each general variant; the threefry words past
   2**32 - 1 counters equal on the card and the CPU; the categorical
   kernel (the DIS draw) equal bit for bit to its plain version over a
   sweep (a party with no rows, cap = 1, n = 1, odd cap * n, take < cap,
   both entry shapes) and at the main path's shapes (round 1, round 2 at
   cap 5000 over three parties with device counts, timed beside its
   bound, counted from the algorithm's operations per candidate, and the
   plain version, and a k-means++ pick), and one timed draw
   of cap * n just past the counter limit, its rows across the block edge
   held to the plain rows;
4. main path, ``vrlr``: coreset -> ``fit_ridge`` -> ``evaluate`` at the
   YearPrediction scale (n = 463,715, d = 90, T = 3) for m = 1000 and 5000
   on data made from the seed, with the exact DIS bill, the Theorem 2.5
   +2mT, rising launch counters, a finite relative error under the
   benchmark gate, and the identity coreset reproducing the full solve;
   the build's time split into scoring, DIS draw (run with CUDA's sync
   debug mode set to "error": no host copy inside) and health report;
   then agreement with the CPU plain path on a small input;
5. main path, ``vkmc``: ``end_to_end(k=10)``'s coreset -> ``fit_kmeans``
   -> ``evaluate`` on the same data (alpha = 2, 15 local Lloyd iterations,
   25 in the fits) for m = 1000 and 5000, with the exact bill and +2mT,
   exactly the counted launches of the two k-means kernels, Lemma F.2's
   per-party score sum, the identity coreset at relative error 0 and a
   finite relative error under the gate; the build split into k-means++,
   Lloyd, scoring, DIS draw and health report; then the card against the
   CPU plain path on a small input;
6. solver grid (the paper's Table 1 left and Figs 6-8): ``solve`` for
   ridge, linear, lasso and elastic net and ``saga_ridge`` (20,000 steps,
   automatic step size) on phase 4's data, its vrlr coreset at m = 5000
   and a uniform coreset at m = 5000, with each solver's time, each
   sampling's relative error, the exact SAGA bill and K3 launched twice
   per sampling;
7. batched engine: ``build_coresets_batched`` for ``vrlr`` (2 seeds x
   m in {1000, 5000} at full scale, K1 launched once for the grid) and
   ``vkmc`` (2 seeds x m in {200, 500} at n = 20,001, K2 16 times a
   seed, first checked at the grid's shape against its plain version and
   its global variant; K5 first checked bit for bit at each grid's round
   1, round 2 and k-means++ shapes), each cell at m = m_cap equal to its
   eager build bit for bit (the vrlr grid's seed 0 is phase 4's key, held
   to phase 4's build), the m < m_cap cells a prefix with a zero tail,
   every bill exact; the vkmc grid then split by stage;
8. fused engine: ``build_coreset_jit`` for ``vrlr``, ``vkmc`` and
   ``uniform`` at m in {1000, 5000} on phase 4's data: the first call's
   capture time and the replay's build_s beside an eager build_s, indices
   equal to the eager build's (and to phases 4 and 5's builds), weights
   equal bit for bit, the exact bill, the launches each replay adds, and
   replays with a second key and on a second dataset of the same shapes
   equal to their eager builds;
9. streamed engine: a host-resident copy of phase 4's data (CPU tensors),
   block_size 65,536 (8 blocks, the last with 4,963 valid rows): each
   kernel first at the streamed shapes against its plain version (K3 and
   K1 on a full and the ragged last (3, 65536, 31) block with the row-valid
   mask as weights, K2 and K4 at (3, 65536, 30) x (3, 10, 30) and K2 on a
   (16384, 30) subsample, each fast kernel bit for bit to its oracle, K5
   bit for bit at round 1 over 24 cells and round 2 over a full and the
   ragged block with its -inf tail); then ``CoresetPipeline(host
   dataset).build(engine="streamed")`` on the card for ``vrlr`` and
   ``vkmc`` (k = 10, alpha = 2, 15 local iterations on a 16,384-row
   subsample) at m in {1000, 5000}, fit and evaluated on the card dataset:
   the exact bill with an nb-float round-1 payload, the launches counted
   from the code (touched blocks included), the staged host-to-device
   bytes (two block passes and the touched blocks), data_passes, a finite
   relative error under the gate, the build's own peak device memory
   (above what was allocated before it) under four staged blocks, printed
   beside phases 4 and 5's peaks; the build split by stage (pass 1, the
   mass pass, round 1, round 2) and held to the counted build bit for bit;
   ``vrlr``'s streamed scores and block masses against the materialized
   scores; ``vkmc``'s block masses against the plain stats and score
   bodies on the same local centers, Lemma F.2, and the coreset's weighted
   cost within a few percent of the full data's at the fit's and the
   baseline's centers; a plan compiled for the host dataset's device
   refused by a build on the card; the ``norm`` backend at one block,
   from the host copy and from the card dataset, and the ``uniform``
   task from the host copy, equal to their materialized builds bit for
   bit;
10. pipelined engine, from the same host copy: each kernel first at the
   superchunk shapes (C = 8 blocks of 65,536 and of 16,384 rows, the
   first and the ragged last superchunk) against its plain version and,
   bit for bit, against the streamed engine's per-block launches on the
   same blocks (K3's Grams, K1's scores, K2's cluster sizes and costs,
   K4's assignments, each block's mass), with the batched launch timed
   against the per-block ones; K5 at round 1 over the T nb cells and at
   a redraw group's 3 C cells; then (a) ``build_coreset_streaming`` with
   its defaults (block 65,536, one superchunk, the card's prefetch
   default) for ``vrlr`` and ``vkmc`` at m in {1000, 5000} with phase 9's
   keys, equal bit for bit to phase 9's streamed builds (indices,
   weights, block masses, bill and ledger); (b) block 16,384 (29 blocks,
   superchunks of 8, 8, 8 and 5) at m = 5000, prefetch on and off, equal
   bit for bit to a streamed build of this phase; each build with the
   launches counted from the code (one per superchunk and per redraw
   group), the staged bytes equal to the streamed engine's and its own
   peak device memory under 2.5 superchunks, split by stage; (c) the
   prefetch ablation, ``vrlr`` at block 4,096 (114 blocks, 15
   superchunks), m = 1000, three runs each way after a warm-up;
11. sharded masses and the fault seam, from the same host copy at block
   66,245 (7 blocks, one superchunk; 463,715 = 5 x 7 x 13,249, so this is
   the divisor nearest the default 65,536 that the shard grid takes at
   D = 1): K3 with unit weights and K1 at the shard's (3, 463715, 31), K4
   at (3, 463715, 30) x (3, 10, 30) against their plain versions; then (a)
   the ``vrlr`` and ``vkmc`` (k = 10, alpha = 2) block-mass tables and
   pipelined ``sharded_masses`` builds at m in {1000, 5000}, without a
   process group and in an NCCL world of one: tables and builds (indices,
   weights, bill) bit for bit across the two, exactly two all-reduces per
   table in the group, the table within rtol 1e-4, atol 1e-6 of the
   unsharded scorer's, ``data_passes`` 1 and 2 with it supplied, the exact
   bill, launches counted from the code, a finite relative error under the
   gate after the fit, ``sharded_s`` and the table's peak device memory
   beside the shard's bytes, a CPU table under the NCCL group refused;
   (b) the fault seam on the materialized engine (m = 5000) and the
   pipelined one (block 66,245, sharded masses) for both tasks: a
   null-plan ``Transport`` under each of the four policies bit for bit the
   transportless build (indices, weights, ledger, launches); a chaos build
   (plan seed 123, drop 0.3, 6 retries, ``retry``) replayed identically,
   its ledger the base bill plus the ``retry/`` units exactly; ``degrade``
   with party 0 never answering and ``quarantine`` with party 0 poisoning
   its table on an unverifying wire, each receipt naming party 0 and the
   survivors' draw bit for bit a build on ``select_parties([1, 2])``; the
   sharded ``vkmc`` build solves its local centers once (launches counted);
12. checkpointed resume, the planner and engine failover, from the same
   host copy: (a) pipelined ``vrlr`` and ``vkmc`` builds at block 16,384
   (four superchunks of 8, prefetch on, m = 5000) crashed by a probe inside
   the first pass, inside the mass pass and after the mass pass's last
   superchunk, each rerun with its ``StreamCheckpoint`` bit for bit the
   uninterrupted build (indices, weights, bill, ledger), with resumes, the
   signature cleared, ``h2d_bytes`` the full build's less the skipped
   superchunks' and launches less the skipped superchunks'; (b) the
   planner's ``predicted_peak_bytes`` beside each engine's measured own
   peak (materialized at phase 4's shape, streamed at blocks 65,536 and
   16,384, pipelined at 65,536 and at 16,384 with prefetch on and off),
   each build run through ``build_failover`` under a memory budget of its
   own prediction with no attempt, and each prediction at or above its
   peak; (c) memory budgets at and one byte
   below the model's values selecting materialized, pipelined, streamed
   and streamed flagged, the pipelined and streamed auto builds equal bit
   for bit, the host dataset planned onto the streaming engines,
   ``codec="auto"`` under the bits of ``fp16`` and of ``int8_blockscale``
   picking them as the reference's ladder walk does, a transported build's
   realised bits within the prediction, and a repeated plan a cache hit;
   (d) ``build_failover`` of the pipelined spec under a memory budget
   from the model alone, its streamed prediction at 16,384 (the budget
   counts the build's own bytes, as the watchdog does): the watchdog
   trips, the streamed rung's coreset is the forced streamed build's bit
   for bit and its ledger that build's bill plus a zero-unit
   ``fallback/pipelined->streamed`` entry;
13. the merge-and-reduce serving tree: phase 4's host copy inserted in
   superchunks of 65,536 rows (8 inserts, the last of 4,963) into a
   ``CoresetTree`` per task, budget 1000, nodes of 2000 rows, leaves
   pipelined at block 16,384 with prefetch: (a) every leaf bit for bit the
   direct pipelined build at ``leaf_key(i)`` (indices plus the offset,
   weights, bill); (b) merges per insert 0, 1, 0, 2, 0, 1, 0, 3, the
   rescored rows the chunk's plus 4000 a merge, height 4; (c) the ledger
   exactly 8 leaf DIS bills and 7 merges each with its union's DIS bill;
   (d) two queries between inserts bit for bit, and a second ``vrlr``
   tree with the same key replaying the first; (e) ``query(reduce_to=
   1000)`` fit on the card and evaluated at full n, its ``rel_error``
   finite, < 0.25 and <= max(8 x the flat build's, 0.05); (f) a ``vrlr``
   tree with ``failover=True`` under the model's streamed prediction for
   one leaf, built alone and again with 1 GiB resident: the seven full
   leaves fall back to streamed both times, the nodes are (a)'s bit for
   bit and the ledger (a)'s bill plus one 0-unit ``fallback/`` entry a
   fallback; phase 13's (a) trees also leave, for phase 14, the digests of
   their levels and of ``query(reduce_to=1000)`` after every insert;
14. the multi-tenant ``CoresetService`` on the card at phase 13's shapes:
   (a) tenants ``v`` (``vrlr``) and ``k`` (``vkmc``) with phase 13's keys and
   ``v2`` (``vrlr``, a third seed) inserted round robin with a reduced query
   after each insert: ``v`` and ``k`` bit for bit phase 13's trees after
   every insert (levels and queries), ``v2``'s leaves hitting ``v``'s plans,
   each ledger the sum of its receipts' deltas, insert and query
   ``latency_s`` p50 / p99 per task and the first insert against the warm
   ones; (b) a hostile mix on a ``SimClock`` ticking 1 s a read over three
   superchunks: a rate-limited tenant shed with ``rate_limit`` and
   recovering, a deadline breached mid-leaf returning a ``deadline`` receipt
   with the tree and ledger bit for bit unchanged, a tenant whose
   ``Transport`` drops every party opening its breaker and shed with
   ``breaker_open``, a normal tenant's final query bit for bit the same
   tenant alone on a fresh service and its ``failover=True`` twin (under one
   leaf's streamed prediction, ``"pipelined->streamed"`` receipts), every
   request a receipt or a party failure its breaker recorded; (c) six
   one-shot requests of two tenants on phase 4's card dataset (``vrlr`` at
   m in {1000, 5000}, ``vkmc`` at 1000, k = 10) flushed as two batched
   builds, K1 once for the ``vrlr`` group, the m = m_cap cells bit for bit
   their eager builds, every bill exact, ``flush_s`` beside the requests
   built one by one, and a host dataset refused at ``attach_dataset``;
15. the synthetic datasets: ``rng.normal``'s words bit for bit on the card
   and the CPU, ``year_prediction_like`` and ``correlated_vfl_data`` at
   n = 51,534 (the reference's ``--fast`` size) on the card against the
   port's CPU ones within the tests' tolerances; then
   ``benchmarks/common.py``'s recipe at n = 515,345 on the card:
   ``vrlr`` from ``PRNGKey(7)`` with targets centred on the train split and
   a 10% test split, ``end_to_end`` at m in {1000, 5000}; ``vkmc`` from
   ``PRNGKey(11)``, standardized, k = 10, ``end_to_end`` at m = 5000; each
   ``rel_error`` finite and under the gate, the bill ``dis_total`` + 2mT,
   the launches of one ``end_to_end``, and the generation's time and own
   peak device memory.

Every path is driven with all five launch counters set to 0 just before
it and read just after.  With the default seed, the drawn indices of
phases 4, 5 and 7 are also held to the digests recorded before the
categorical kernel replaced the plain draw.

Its last two lines are the kernels' JSON record and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside
# the tensor cores — the bound_ms yardsticks.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# the operation rates behind them, per second on 132 SMs at the 1.98 GHz
# boost clock: 128 fp32 operations per SM and clock (the data sheet's
# 67 TFLOP/s counts an FMA as two), 64 int32 ones (add, logic, shift,
# compare, select; CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), and 4 warp schedulers issuing one
# instruction of 32 threads each per clock.  The categorical kernel is
# bound by its int32 operations, not by flops or bytes.
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# The least work of one gumbel-max candidate of the DIS draw, counted from
# the algorithm (rng._bits_at, rng._gumbel_of, rng.log and the running
# maximum), each operation on the pipe that runs it; loop control, address
# arithmetic and moves are not counted.
#   int32: the counter pair (the position, its compare with the half, the
#     two offsets and their selects, the odd-size pad's compare and select:
#     8); threefry2x32 (the first key add on both words, 20 rounds of add,
#     rotate and xor, 5 key injections of two adds: 2 + 60 + 10) and its
#     lane select (1); the uniform's mantissa (shift, or: 2); each log's
#     exponent and mantissa fields (shift, subtract, and-or: 2 x 3); the
#     running maximum's value and index selects (2): 91
#   fp32: the uniform (- 1, + tiny, clamp: 3); each log 32 (clamp, the
#     exponent's conversion and + 1, the sqrt(1/2) compare, t's subtract,
#     select and add, e's select and subtract, z and t^3, 9 FMAs, e * q1,
#     0.5 z, three sums, e * q2, and three special cases of a compare and a
#     select each); + logit, the compare with the maximum and its NaN test
#     (3): 70
K5_INT32_OPS = 8 + (2 + 20 * 3 + 5 * 2) + 1 + 2 + 2 * 3 + 2
K5_FP32_OPS = 3 + 2 * 32 + 3

N_FULL, D_FULL, T_PARTIES = 463_715, 90, 3   # YearPrediction, paper Table 1
N_WIDE = 20_001          # rows of the timed general-variant shapes
CAP_PAST_LIMIT = 9_263   # the first cap with cap * N_FULL > 2**32 - 1
BUDGETS = (1000, 5000)
REL_ERROR_GATE = 0.5                          # benchmarks/e2e.py's gate
# kernel-vs-plain tolerances, relative to the largest magnitude the sum can
# reach (fp32 sums of up to n products in another order than cuBLAS's)
LEVERAGE_TOL = 1e-5        # max|k - p| / max|p|
GRAM_TOL = 1e-5            # max|k - p| / max(|X|^T |w| |X|)
# k-means kernels: an assignment must be near-minimal (its center's float64
# distance within KMEANS_D2_TOL * max(||x||^2 + ||c||^2) of the row's
# minimum; index equality is not required where two distances tie within
# rounding), d2 within that of the plain version's (the expanded form's
# cancellation error), and csum / wsum / ccost within KMEANS_SUM_TOL of the
# largest absolute segment sum of the kernel's own assignment.  The plain
# version's scatter_add_ runs one atomic chain of up to n/k rows per
# cluster, whose rounding grows like sqrt(n/k) * 2^-24: about 1.5e-5 in the
# tail at n/k = 46,000, hence 1e-4 and not GRAM_TOL's 1e-5.
KMEANS_D2_TOL = 1e-5
KMEANS_SUM_TOL = 1e-4
K_CLUSTERS, ALPHA, LOCAL_ITERS, FIT_ITERS = 10, 2.0, 15, 25   # Table 1 right
SAGA_STEPS = 20_000      # benchmarks/vrlr_main.py's fast setting
BLOCK_SIZE = 65_536      # the streamed engine's block, the reference's default
CENTER_SAMPLE = 16_384   # vkmc_local_centers' row subsample, the reference's default
# streamed vrlr scores and block masses against phase 4's materialized ones:
# two fp32 pseudo-inverses of the party Grams (condition numbers up to 905
# at --seed 0), one Gram the block-scan K3 sums (4.3e-8 from the float64
# Gram), the other one cuBLAS product over all n rows (1.6e-4 from it); at
# --seed 0 the scores differ by 8.3e-4 of the largest, the materialized ones
# 8.5e-4 and the streamed ones 4.1e-4 from the scores of a float64 Gram and
# pseudo-inverse (PERF.md, section 6). The streamed scores and block masses are
# held to both, the materialized and the float64 ones.
STREAM_SCORE_TOL = 2e-3  # max |streamed - other| / max |float64 scores|
# the streamed build's own device memory: at most four staged blocks
STREAM_PEAK_BLOCKS = 4
# the streamed vkmc block masses against the plain stats and score bodies
# on the same (bit-equal) local centers: max |kernel - plain| / plain
STREAM_MASS_TOL = 1e-4
# the streamed vkmc coreset's weighted cost against the full data's at the
# fit's and the baseline's centers, |cost_S / cost_X - 1|: at --seed 0 and
# m = 1000 0.20% / 0.31%, phase 5's coreset 1.04% / 0.41% (PERF.md)
STREAM_COST_GATE = 0.05
# the pipelined engine (phase 10): its block sizes, and the bound on a build's
# own device memory, in superchunks of DEFAULT_CHUNK_BLOCKS blocks (the
# reference's PIPELINED_PEAK_FACTOR: two staging slots and half of one for
# the work)
PIPE_BLOCK = 16_384      # nb = 29: superchunks of 8, 8, 8 and 5 blocks
ABLATION_BLOCK = 4_096   # nb = 114: 15 superchunks, the prefetch ablation's
ABLATION_RUNS = 3
PIPE_PEAK_FACTOR = 2.5
# phase 11's block: 463,715 = 5 x 7 x 13,249, and 66,245 (7 blocks) is the
# divisor nearest the default 65,536 that the shard grid accepts at D = 1
SHARD_BLOCK = 66_245
# phase 13, the serving tree: superchunks of the main path's rows inserted one
# at a time (8 inserts, the last of 4,963 rows), a budget of phase 4's smaller m,
# nodes keeping twice it (the reference tree's default headroom)
TREE_CHUNK = 65_536
TREE_BUDGET = 1000
TREE_HEADROOM = 2
# phase 15, the synthetic datasets: the reference's --fast n and the paper's
# YearPredictionMSD n (benchmarks/common.py), the assumption sweep's width for
# correlated_vfl_data, and the tolerances tests/test_torch_synthetic.py holds the
# generators to (X is O(1)-O(10) after a library's Z @ W; y is near 2000)
SYNTH_FAST_N = 51_534
SYNTH_FULL_N = 515_345
SYNTH_CORR_D = 30
SYNTH_X_ATOL = 1e-5
SYNTH_Y_RTOL = 1e-6
# indices_sha256 of phases 4 and 5 at --seed 0, recorded on the card with
# the plain draw (PERF.md); phase 7's vrlr cell (0, 1) is phase 4's m = 5000
# build
PARENT_DIGESTS = {("vrlr", 1000): "76d59a6faebe9131", ("vrlr", 5000): "b1b04abcb57045c2",
                  ("vkmc", 1000): "2ffe1edfffb6b0e6", ("vkmc", 5000): "d22065e54e37e4d3"}
# indices_sha256 of phase 11's sharded pipelined builds at --seed 0, recorded on
# the card with two local-center solves per sharded vkmc build (PERF.md); the
# one solve the build makes must keep these bits
SHARDED_DIGESTS = {("vrlr", 1000): "21c82dce04bdf60a", ("vrlr", 5000): "816652e7c348dba2",
                   ("vkmc", 1000): "aaaea2437f750c6a", ("vkmc", 5000): "0a1bbd81ea77c7a0"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_once(torch, fn):
    """(fn's result, its milliseconds on the card) for one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def categorical_bound_ms(candidates: int, nbytes: float):
    """(least milliseconds for ``candidates`` gumbel-max candidates, what
    bounds it): their int32 and fp32 operations (``K5_INT32_OPS``,
    ``K5_FP32_OPS`` each) over their pipes' rates, all of them over the
    schedulers' issue rate, or the bytes."""
    t_ops = max(candidates * K5_INT32_OPS / INT32_OPS_PER_S,
                candidates * K5_FP32_OPS / FP32_OPS_PER_S,
                candidates * (K5_INT32_OPS + K5_FP32_OPS) / ISSUE_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(nbytes: float, flops: float):
    """(least milliseconds for the work on the card, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gram_flops(n: int, d: int) -> int:
    """Least fp32 operations for G = X^T diag(w) X: n*d products w_i x_i,
    then n multiply-adds for each of the d(d+1)/2 entries of one triangle
    (G is symmetric, so the other triangle is a copy, not work)."""
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


def make_data(seed: int, n: int, d: int, k_clusters: int = 8):
    """Clustered Gaussian rows with a noisy linear response, in the style
    of benchmarks/e2e.py::_dataset, made with numpy from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((k_clusters, d)).astype(np.float32)
    X = (centers[rng.integers(0, k_clusters, n)]
         + rng.standard_normal((n, d)).astype(np.float32))
    theta = rng.standard_normal(d).astype(np.float32)
    y = X @ theta + 0.1 * rng.standard_normal(n).astype(np.float32)
    return X, y


def row_valid(torch, bs: int, nvalid: int, dev):
    """(bs,) float32 0/1 weights: the first ``nvalid`` rows of a block."""
    return (torch.arange(bs, device=dev) < nvalid).to(torch.float32)


def digest(indices) -> str:
    """A short hash of a coreset's drawn indices, to compare draws across
    runs and commits."""
    import hashlib

    return hashlib.sha256(indices.cpu().numpy().astype("int64").tobytes()).hexdigest()[:16]


def mat_digest(mat) -> str:
    """A short hash of a materialized coreset's rows, weights, feature
    slices, labels and bill: equal digests are the same node bit for bit."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (mat.indices, mat.weights, *mat.parts, *([] if mat.y is None else [mat.y])):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(f"{mat.comm_units},{mat.comm_bits}".encode())
    return h.hexdigest()[:16]


def levels_digest(tree) -> str:
    """A short hash of a serving tree's occupied levels (level, node)."""
    import hashlib

    return hashlib.sha256("".join(
        f"{lvl}:{mat_digest(nd.cs)};" for lvl, nd in enumerate(tree.levels)
        if nd is not None).encode()).hexdigest()[:16]


def check_kernel(torch, name, kern, plain, args, scale_fn, tol):
    """Kernel vs plain on the card: returns the max abs error; fails past
    ``tol`` (relative to ``scale_fn``'s magnitude) or on unequal repeats."""
    got = kern(*args)
    again = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    if not torch.equal(got, again):
        fail(f"{name}: two launches on the same input differ")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = scale_fn(*args) if got.numel() else 1.0
    rel = err / max(scale, 1e-30)
    shapes = " ".join(str(tuple(a.shape)) for a in args)
    log(f"  {name} {shapes}: max_abs_err={err:.3e} scaled={rel:.3e} (tol {tol:g})")
    if rel > tol:
        fail(f"{name} {shapes}: scaled error {rel:.3e} above {tol:g}")
    return err


def check_kmeans(torch, ref, name, kern, plain, X, C, w=None, fused=False,
                 exact=False):
    """A k-means kernel against its plain version on the card: two launches
    bitwise equal, assignments near-minimal (with ``exact``, equal to the
    plain version's on every row where the two choices are not tied within
    KMEANS_D2_TOL in float64: there the two summation orders may round
    either way), d2 and the sums within the tolerances above.  Returns the
    max abs error over d2 and the sums."""
    args = (X, C, w) if fused else (X, C)
    got = kern(*args)
    again = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    shapes = " ".join(str(tuple(a.shape)) for a in args if a is not None)
    if fused and w is None:
        shapes += " w=None"
    if any(not torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name} {shapes}: two launches on the same input differ")
    assign, d2 = got[0], got[1]
    if assign.shape != want[0].shape or assign.dtype != torch.int32:
        fail(f"{name} {shapes}: assign {tuple(assign.shape)} {assign.dtype}")
    if not all(torch.isfinite(t).all() for t in got[1:]):
        fail(f"{name} {shapes}: non-finite output")
    k = C.shape[-2]
    X64, C64 = X.double(), C.double()
    x2, c2 = (X64 * X64).sum(-1), (C64 * C64).sum(-1)
    full = (x2[..., None] + c2[..., None, :]
            - 2.0 * X64 @ C64.transpose(-1, -2)).expand(assign.shape + (k,))
    chosen = full.gather(-1, assign.long()[..., None])[..., 0]
    scale = float(x2.max() + c2.max())
    gap = float((chosen - full.min(-1).values).max()) / scale
    d2_err = float((d2 - want[1]).abs().max())
    differ = assign != want[0]
    mismatched = int(differ.sum())
    if exact and mismatched:
        other = full.gather(-1, want[0].long()[..., None])[..., 0]
        tied = (chosen - other).abs() <= KMEANS_D2_TOL * scale
        if bool((differ & ~tied).any()):
            fail(f"{name} {shapes}: {int((differ & ~tied).sum())} assignments "
                 f"differ from plain's where the two are not tied")
    if gap > KMEANS_D2_TOL or d2_err / scale > KMEANS_D2_TOL:
        fail(f"{name} {shapes}: assignment gap {gap:.3e} or d2 error "
             f"{d2_err / scale:.3e} above {KMEANS_D2_TOL:g}")
    err, rel = d2_err, 0.0
    if fused:
        sums = ref.segment_sums(X, w, assign, d2, k)
        scales = ref.segment_sums(X.abs(), None if w is None else w.abs(),
                                  assign, d2.abs(), k)
        for g, e, sc in zip(got[2:], sums, scales):
            e_abs = float((g - e).abs().max())
            rel = max(rel, e_abs / max(float(sc.abs().max()), 1.0))
            err = max(err, e_abs)
        if rel > KMEANS_SUM_TOL:
            fail(f"{name} {shapes}: sums error {rel:.3e} above {KMEANS_SUM_TOL:g}")
    log(f"  {name} {shapes}: max_abs_err={err:.3e} assign_gap={gap:.2e} "
        f"d2_scaled={d2_err / scale:.2e} sums_scaled={rel:.2e} "
        f"assign!=plain {mismatched}")
    return err


def check_k2_oracle(torch, kkau, X, C, w=None, timed=False):
    """K2's fast stage 1 against its global variant on the same input: the
    five outputs equal bit for bit (both sum every entry in the same order,
    kmeans_assign_update.cu's bit contract).  With ``timed``, also the CUDA
    event times of both, returned as (fast ms, global ms)."""
    fast = kkau.kmeans_assign_update(X, C, w)
    glob = kkau._launch(X, C, w, global_variant=True)
    torch.cuda.synchronize()
    shapes = " ".join(str(tuple(a.shape)) for a in (X, C, w) if a is not None)
    layout = kkau.layout(C.shape[-2], X.shape[-1])
    bad = [nm for nm, a, b in zip(("assign", "d2", "csum", "wsum", "ccost"), fast, glob)
           if not torch.equal(a, b)]
    if bad:
        fail(f"kmeans_assign_update {shapes}: the fast kernel's {bad} differ from "
             f"the global variant's (layout {layout})")
    msg = (f"  kmeans_assign_update {shapes}: fast kernel (layout {layout}) == "
           f"global variant, bit for bit")
    if not timed:
        log(msg)
        return None
    times = (cuda_ms(torch, lambda: kkau.kmeans_assign_update(X, C, w)),
             cuda_ms(torch, lambda: kkau._launch(X, C, w, global_variant=True)))
    log(f"{msg}; fast {times[0]:.4f} ms, global {times[1]:.4f} ms")
    return times


def check_k1_oracle(torch, klev, X, M, timed=False):
    """K1's kernel for the width of X against the wide kernel on the same
    input, and against itself: equal bit for bit (leverage.cu's bit
    contract).  With ``timed``, also the CUDA event times of both, returned
    as (kernel ms, wide ms)."""
    got = klev.leverage(X, M)
    again = klev.leverage(X, M)
    wide = klev._launch(X, M, wide=True)
    torch.cuda.synchronize()
    shapes = f"{tuple(X.shape)} {tuple(M.shape)}"
    if not torch.equal(got, again):
        fail(f"leverage {shapes}: two launches on the same input differ")
    if not torch.equal(got, wide):
        fail(f"leverage {shapes}: the kernel's output differs from the wide kernel's")
    msg = f"  leverage {shapes}: kernel == wide kernel, bit for bit"
    if not timed:
        log(msg)
        return None
    times = (cuda_ms(torch, lambda: klev.leverage(X, M)),
             cuda_ms(torch, lambda: klev._launch(X, M, wide=True)))
    log(f"{msg}; kernel {times[0]:.4f} ms, wide {times[1]:.4f} ms")
    return times


def check_k4_oracle(torch, kka, X, C, timed=False):
    """K4's fast kernel against its global variant on the same input, and
    against itself: assign and d2 equal bit for bit (kmeans_assign.cu's bit
    contract).  With ``timed``, also the CUDA event times of both, returned
    as (fast ms, global ms)."""
    fast = kka.kmeans_assign(X, C)
    again = kka.kmeans_assign(X, C)
    glob = kka._launch(X, C, global_variant=True)
    torch.cuda.synchronize()
    shapes = f"{tuple(X.shape)} {tuple(C.shape)}"
    layout = kka.assign_layout(C.shape[-2], X.shape[-1])
    if any(not torch.equal(a, b) for a, b in zip(fast, again)):
        fail(f"kmeans_assign {shapes}: two launches on the same input differ")
    bad = [nm for nm, a, b in zip(("assign", "d2"), fast, glob) if not torch.equal(a, b)]
    if bad:
        fail(f"kmeans_assign {shapes}: the fast kernel's {bad} differ from the "
             f"global variant's (layout {layout})")
    msg = (f"  kmeans_assign {shapes}: fast kernel (layout {layout}) == global "
           f"variant, bit for bit")
    if not timed:
        log(msg)
        return None
    times = (cuda_ms(torch, lambda: kka.kmeans_assign(X, C)),
             cuda_ms(torch, lambda: kka._launch(X, C, global_variant=True)))
    log(f"{msg}; fast {times[0]:.4f} ms, global {times[1]:.4f} ms")
    return times


def library_assign_update(torch, X, C, w=None):
    """One PyTorch expression for K2's function (timed, used nowhere in the
    port): torch.cdist(X, C).min(-1), then index_add_ of w x, w and w d2
    over the flattened batch."""
    dist, a = torch.cdist(X, C).min(-1)
    d2 = dist * dist
    n, d = X.shape[-2:]
    k = C.shape[-2]
    B = a.numel() // n
    flat = (a + torch.arange(B, device=X.device).view(a.shape[:-1] + (1,)) * k
            ).reshape(-1) if a.ndim > 1 else a
    ww = (torch.ones_like(d2) if w is None else w.expand(a.shape)).reshape(-1)
    Xf = X.expand(a.shape + (d,)).reshape(-1, d)
    csum = torch.zeros(B * k, d, device=X.device).index_add_(0, flat, ww[:, None] * Xf)
    wsum = torch.zeros(B * k, device=X.device).index_add_(0, flat, ww)
    ccost = torch.zeros(B * k, device=X.device).index_add_(0, flat, ww * d2.reshape(-1))
    return a, d2, csum, wsum, ccost


def streamed_phase(torch, dev, seed, ds_host, ds, lam, launches, mat_peaks, mat_coresets,
                   check_k5, reset_counts, read_counts):
    """Phase 9, the streamed engine from ``ds_host``, a host-resident copy
    of the main path's data; returns the largest kernel-vs-plain error it
    saw, by kernel, and its counted builds by (task, m): indices, weights,
    block masses, bill and staged bytes.  ``ds`` is the same data on the
    card, ``launches`` the running totals it adds the counted builds and
    fits to, ``mat_peaks`` and ``mat_coresets`` phases 4 and 5's peak
    device memory and coresets by (task, m)."""
    import numpy as np

    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, build_coreset,
        dis_plan_streamed, evaluate, fit_kmeans, fit_ridge, full_data_coreset, kmeans_cost,
        make_stream_scorer, vkmc_local_centers)
    from repro_torch.core import streaming as cst
    from repro_torch.core.api import vrlr_scores
    from repro_torch.core.dis import _key_chain
    from repro_torch.core.sensitivity import batched_gram_pinv
    from repro_torch.core.wire import WirePayload
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import kmeans_assign_update as kkau
    from repro_torch.kernels import leverage as klev
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import weighted_gram as kwg

    T = T_PARTIES
    phase_t0 = time.perf_counter()
    nb, bs = ds_host.block_geometry(BLOCK_SIZE)
    last = N_FULL - (nb - 1) * bs
    log(f"streamed: host-resident copy n={ds_host.n} dims={ds_host.dims} on "
        f"{ds_host.device}; block_size={BLOCK_SIZE}: {nb} blocks of {bs} rows, the "
        f"last with {last} valid")
    gen = torch.Generator(device="cpu").manual_seed(seed + 9)
    errs = dict.fromkeys(("leverage", "weighted_gram", "kmeans_assign_update",
                          "kmeans_assign"), 0.0)
    lev_scale = lambda X, M: klev.plain(X, M).abs().max().item()
    gram_scale = lambda X, w: kwg.plain(X.abs(), w.abs()).max().item()

    # -- each kernel at the streamed shapes against its plain version (outside
    #    the counts): a full block and the ragged last one, staged from the host
    log("kernels at the streamed shapes vs plain:")
    for b in (0, nb - 1):
        blk, nv = ds_host.block(b, BLOCK_SIZE, with_labels=True, device=dev)  # (3, bs, 31)
        wv = row_valid(torch, bs, nv, dev).expand(T, bs)
        errs["weighted_gram"] = max(errs["weighted_gram"], check_kernel(
            torch, "weighted_gram", kwg.weighted_gram, kwg.plain, (blk, wv), gram_scale,
            GRAM_TOL))
        G = kwg.weighted_gram(blk, wv)
        if not torch.equal(G, G.transpose(-1, -2)):
            fail(f"weighted_gram at block {b}: G is not exactly symmetric")
        M = batched_gram_pinv(G)
        errs["leverage"] = max(errs["leverage"], check_kernel(
            torch, "leverage", klev.leverage, klev.plain, (blk, M), lev_scale, LEVERAGE_TOL))
        check_k1_oracle(torch, klev, blk, M)
        kb, _ = ds_host.block(b, BLOCK_SIZE, device=dev)                       # (3, bs, 30)
        Cb = kb[:, torch.randperm(nv, generator=gen)[:K_CLUSTERS].to(dev)].contiguous()
        errs["kmeans_assign_update"] = max(errs["kmeans_assign_update"], check_kmeans(
            torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update, kkau.plain,
            kb, Cb, wv, fused=True))
        check_k2_oracle(torch, kkau, kb, Cb, wv)
        errs["kmeans_assign"] = max(errs["kmeans_assign"], check_kmeans(
            torch, kref, "kmeans_assign", kka.kmeans_assign, kka.plain, kb, Cb))
        check_k4_oracle(torch, kka, kb, Cb)
        del blk, kb
    # K2 on one party's k-means subsample, 2-D, as the local Lloyd runs it
    Xs = ds_host.parts[0][torch.randperm(N_FULL, generator=gen)[:CENTER_SAMPLE]].to(dev)
    Cs = Xs[:K_CLUSTERS].contiguous()
    errs["kmeans_assign_update"] = max(errs["kmeans_assign_update"], check_kmeans(
        torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update, kkau.plain, Xs, Cs,
        fused=True))
    check_k2_oracle(torch, kkau, Xs, Cs)
    # K5: round 1 over the T * nb cells, round 2 over a full block and over the
    # ragged last block with its -inf tail (the counter layout is the padded
    # block's), and a k-means++ pick over the subsample
    keys = rng.split(rng.PRNGKey(seed + 15), T).to(dev)
    cell_lg = torch.log(torch.rand(1, T * nb, generator=gen) + 0.01).to(dev)
    row_lg = torch.log(torch.rand(T, bs, generator=gen) + 0.01).to(dev)
    tail_lg = row_lg.clone()
    tail_lg[:, last:] = -float("inf")
    for m in BUDGETS:
        per = m // (T * nb)
        check_k5(keys[:1], cell_lg, m, [m], f"streamed round 1 m={m}")
        check_k5(keys, row_lg, m, [per] * T, f"streamed round 2 m={m}")
        check_k5(keys, tail_lg, m, [per, 0, 2 * per], f"streamed round 2, ragged block, m={m}")
    check_k5(keys[:1], torch.log(torch.rand(1, CENTER_SAMPLE, generator=gen) + 0.01).to(dev),
             1, [1], "streamed k-means++ pick")
    del Xs, Cs, row_lg, tail_lg

    # -- the builds: CoresetPipeline(host dataset).build(engine="streamed") on the
    #    card, counted, then fit and evaluated on the card dataset; then the
    #    same build split by stage (outside the counts) and held to it
    pipe = CoresetPipeline(ds_host)
    # a plan resolves its backend and engine for one device: compiled where
    # the host dataset lives, it is refused by a build on the card (before
    # any work is done)
    try:
        pipe.build(pipe.plan(CoresetSpec(engine="streamed", block_size=BLOCK_SIZE)),
                   key=rng.PRNGKey(seed))
    except ValueError as e:
        if "compiled for a build on cpu" not in str(e):
            raise
    else:
        fail("a plan compiled for the CPU ran on the card")
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS,
                 "center_sample": CENTER_SAMPLE}
    r1_payload = WirePayload.of((nb,), "float32", "raw_fp32")
    mat_vrlr = None
    builds = {}
    for task, params, off in (("vrlr", {}, 0), ("vkmc", vk_params, 100)):
        with_labels = task == "vrlr"
        widths, s = ds_host.stacked_widths(with_labels)
        one_block = 4 * T * bs * s
        passes = 2 if task == "vrlr" else 3
        for m in BUDGETS:
            spec = CoresetSpec(task=task, budgets=m, engine="streamed", block_size=BLOCK_SIZE,
                               params=params)
            key = rng.fold_in(rng.PRNGKey(seed + off), m)
            led = CommLedger()
            staged0 = ds_host.staged_bytes
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            cs = pipe.build(spec, key=key, ledger=led)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() - before
            staged = ds_host.staged_bytes - staged0
            reset_counts()
            if task == "vrlr":
                fit = fit_ridge(ds, cs, lam)
                rep = evaluate(ds, fit)
            else:
                sk = rng.fold_in(key, 1)
                fit = fit_kmeans(ds, cs, K_CLUSTERS, key=sk, iters=FIT_ITERS)
                rep = evaluate(ds, fit, key=sk, iters=FIT_ITERS)
            torch.cuda.synchronize()
            fit_counts = read_counts()
            for nm in launches:
                launches[nm] += counts[nm] + fit_counts[nm]
            idx = cs.indices.tolist()
            touched = len({i // bs for i in idx})
            want_launches = (
                {"leverage": nb + touched, "weighted_gram": nb, "kmeans_assign": 0,
                 "kmeans_assign_update": 0, "categorical": 1 + touched}
                if task == "vrlr" else
                {"leverage": 0, "weighted_gram": 0, "kmeans_assign": nb + touched,
                 "kmeans_assign_update": T * LOCAL_ITERS + nb,
                 "categorical": T * K_CLUSTERS + 1 + touched})
            if counts != want_launches:
                fail(f"streamed {task} m={m}: launches {counts}, counted {want_launches} "
                     f"from the code ({nb} blocks, {touched} touched)")
            if staged != (2 * nb + touched) * one_block:
                fail(f"streamed {task} m={m}: staged {staged} bytes, not two passes of "
                     f"{nb} blocks and {touched} touched blocks of {one_block}")
            if cs.indices.shape != (m,) or not (bool((cs.weights > 0).all())
                                                and bool(torch.isfinite(cs.weights).all())):
                fail(f"streamed {task} m={m}: malformed coreset")
            if min(idx) < 0 or max(idx) >= N_FULL:
                fail(f"streamed {task} m={m}: an index outside [0, {N_FULL})")
            if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
                fail(f"streamed {task} m={m}: rel_error {rep.rel_error} not finite or >= "
                     f"{REL_ERROR_GATE}")
            if peak > STREAM_PEAK_BLOCKS * one_block:
                fail(f"streamed {task} m={m}: the build's peak device memory {peak} bytes "
                     f"above {STREAM_PEAK_BLOCKS} staged blocks ({STREAM_PEAK_BLOCKS * one_block})")

            # the same build by stage, with the build's key: the local centers,
            # pass 1 (Gram or stats) and the mass pass by a synchronising probe
            # after each step; round 1 alone (its key chain timed apart); round 2
            # the rest of the draw
            stamps = []

            def probe():
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer = make_stream_scorer(task, key, ds_host, BLOCK_SIZE, "pallas", probe=probe,
                                        device=dev, **params)
            stamps.insert(0, t0)
            if task == "vkmc":
                centers_s = stamps[1] - stamps[0]
                del stamps[0]
            pass1_s, mass_s = stamps[nb] - stamps[0], stamps[2 * nb] - stamps[nb]
            t0 = time.perf_counter()
            subs = _key_chain(scorer.dis_key, T * nb + 1)
            torch.cuda.synchronize()
            chain_s = time.perf_counter() - t0
            draws = kops.categorical(subs[0], rng.log(torch.clamp_min(
                scorer.masses.reshape(-1), 1e-30)), m)
            a_cells = np.bincount(draws.cpu().numpy(), minlength=T * nb)
            t1 = time.perf_counter()
            plan = dis_plan_streamed(scorer, m)
            torch.cuda.synchronize()
            round1_s, round2_s = t1 - t0, time.perf_counter() - t1 - (t1 - t0)
            if not (torch.equal(plan.indices, cs.indices)
                    and torch.equal(plan.weights, cs.weights)):
                fail(f"streamed {task} m={m}: the staged rerun drew another coreset")
            if scorer.data_passes != passes or int(plan.counts.sum()) != m:
                fail(f"streamed {task} m={m}: data_passes {scorer.data_passes} (want "
                     f"{passes}), counts {plan.counts.tolist()}")
            if not np.array_equal(a_cells.reshape(T, nb).sum(1), plan.counts.cpu().numpy()):
                fail(f"streamed {task} m={m}: round 1 alone drew other cells")
            bill = CommSchedule.dis(T, m, counts=plan.counts.tolist(), round1_payload=r1_payload)
            if (cs.comm_units, cs.comm_bits, led.total, led.total_bits) != (
                    bill.total, bill.total_bits, bill.total, bill.total_bits):
                fail(f"streamed {task} m={m}: billed {cs.comm_units} units / {cs.comm_bits} "
                     f"bits, CommSchedule.dis says {bill.total} / {bill.total_bits}")
            extra = ""
            if task == "vrlr":
                # every block's scores and the block masses against phase 4's
                # materialized scores, sliced or summed per block, and both
                # against the scores of a float64 Gram and pseudo-inverse
                if mat_vrlr is None:
                    mat_vrlr = vrlr_scores(key.to(dev), ds)[0]
                    f32 = ds.stacked(with_labels=True).blocks
                    f64 = f32.double()
                    G64 = f64.transpose(1, 2) @ f64
                    M64 = batched_gram_pinv(G64)
                    exact = torch.clamp(((f64 @ M64) * f64).sum(-1), 0.0, 1.0) + 1.0 / N_FULL
                    # the two Grams behind the two scores, against the float64 one
                    G_k3 = torch.zeros_like(G64, dtype=torch.float32)
                    for b, blk, _ in ds_host.blocks(BLOCK_SIZE, True, device=dev):
                        G_k3 = cst._gram_chunk(G_k3, blk[None],
                                               cst._rows_ok(b, 1, bs, N_FULL, dev), True)
                    gram_errs = [float((G - G64).abs().max() / G64.abs().max())
                                 for G in (f32.transpose(1, 2) @ f32, G_k3)]
                    del f32, f64, G64, G_k3
                    per_block = lambda t: torch.nn.functional.pad(
                        t.double(), (0, nb * bs - N_FULL)).reshape(T, nb, bs)
                    mat_blocks, exact_blocks = per_block(mat_vrlr), per_block(exact)
                    scale = float(exact.abs().max())
                streamed = torch.stack([scorer.score_block(b) for b in range(nb)], 1).double()
                gap = lambda a, b: float((a - b).abs().max()) / scale
                mgap = lambda a, b: float(((a - b).abs() / b).max())
                sc = (gap(streamed, mat_blocks), gap(streamed, exact_blocks),
                      gap(mat_blocks, exact_blocks))
                ms = (mgap(scorer.masses.double(), mat_blocks.sum(2)),
                      mgap(scorer.masses.double(), exact_blocks.sum(2)),
                      mgap(mat_blocks.sum(2), exact_blocks.sum(2)))
                if max(sc[:2] + ms[:2]) > STREAM_SCORE_TOL:
                    fail(f"streamed vrlr m={m}: scores / block masses {sc[0]:.3e} / "
                         f"{ms[0]:.3e} from the materialized (tol {STREAM_SCORE_TOL:g}), "
                         f"{sc[1]:.3e} / {ms[1]:.3e} from float64, the materialized "
                         f"{sc[2]:.3e} / {ms[2]:.3e}")
                conds = [f"{c:.4g}" for c in scorer.gram_conds.tolist()]
                extra = (f"; scores / block masses vs materialized {sc[0]:.3e} / {ms[0]:.3e} "
                         f"(tol {STREAM_SCORE_TOL:g}), vs float64 {sc[1]:.3e} / {ms[1]:.3e}, "
                         f"materialized vs float64 {sc[2]:.3e} / {ms[2]:.3e}; Gram conds {conds}; "
                         f"Gram vs float64: cuBLAS over n rows (materialized) "
                         f"{gram_errs[0]:.3e}, K3 block sums (streamed) {gram_errs[1]:.3e}")
                split = f"gram_s={pass1_s:.4f} mass_s={mass_s:.4f} (with the pinv)"
            else:
                # Lemma F.2 on the streamed masses, with the global cluster sizes
                centers, _ = vkmc_local_centers(key, ds_host, k=K_CLUSTERS,
                                                local_iters=LOCAL_ITERS,
                                                center_sample=CENTER_SAMPLE, device=dev)
                # and, for the block masses, the plain stats and score bodies
                # on the same centers (the local k-means is deterministic)
                csize = ccost = csize_p = ccost_p = 0.0
                for b, blk, _ in ds_host.blocks(BLOCK_SIZE, device=dev):
                    ok = cst._rows_ok(b, 1, bs, N_FULL, dev)
                    csize, ccost = cst._vkmc_stats_chunk(csize, ccost, blk[None], centers,
                                                         ok, True)
                    csize_p, ccost_p = cst._vkmc_stats_chunk(csize_p, ccost_p, blk[None],
                                                             centers, ok, False)
                    del blk
                plain_masses = []
                for b, blk, _ in ds_host.blocks(BLOCK_SIZE, device=dev):
                    plain_masses.append(cst._vkmc_scores(
                        blk[None], centers, csize_p, ccost_p,
                        cst._rows_ok(b, 1, bs, N_FULL, dev), float(ALPHA), False)[0].sum(1))
                    del blk
                plain_masses = torch.stack(plain_masses, 1).double()
                mass_gap = float(((scorer.masses.double() - plain_masses).abs()
                                  / plain_masses).max())
                if not mass_gap <= STREAM_MASS_TOL:
                    fail(f"streamed vkmc m={m}: block masses {mass_gap:.3e} from the plain "
                         f"bodies' on the same centers (tol {STREAM_MASS_TOL:g})")
                sums = scorer.masses.sum(1).double()
                lemma = 2.0 * (K_CLUSTERS + 1) * ALPHA
                if bool((csize > 0).all()) and not torch.allclose(
                        sums, torch.full_like(sums, lemma), rtol=1e-4, atol=0.0):
                    fail(f"streamed vkmc m={m}: party mass totals {sums.tolist()} != "
                         f"Lemma F.2's {lemma}")
                # the coreset's own quality, the fit's luck aside: its weighted
                # cost against the full data's at the fit's and the baseline's
                # centers, beside phase 5's coreset of the same key
                X_full = ds.full()
                base = fit_kmeans(ds, full_data_coreset(ds), K_CLUSTERS, key=sk,
                                  iters=FIT_ITERS).params      # evaluate's baseline
                cost_err = lambda c, C: float(abs(kmeans_cost(X_full[c.indices], C, c.weights)
                                                  / kmeans_cost(X_full, C) - 1.0))
                errs_c = [(cost_err(c, fit.params), cost_err(c, base))
                          for c in (cs, mat_coresets[(task, m)])]
                del X_full, base
                if not max(errs_c[0]) <= STREAM_COST_GATE:
                    fail(f"streamed vkmc m={m}: the coreset's weighted cost is "
                         f"{errs_c[0][0]:.4g} / {errs_c[0][1]:.4g} from the full data's at "
                         f"the fit's / the baseline's centers (gate {STREAM_COST_GATE:g})")
                best_rel = rep.cost_fit / min(rep.cost_fit, rep.cost_opt) - 1.0
                extra = (f"; block masses vs plain bodies {mass_gap:.3e} (tol "
                         f"{STREAM_MASS_TOL:g}); party mass totals {sums.tolist()} "
                         f"(Lemma F.2: {lemma}), "
                         f"smallest global cluster {int(csize.min())}; rel_error_vs_best="
                         f"{best_rel:.6g}; coreset cost error at the fit's / the baseline's "
                         f"centers {errs_c[0][0]:.4g} / {errs_c[0][1]:.4g}, phase 5's coreset "
                         f"{errs_c[1][0]:.4g} / {errs_c[1][1]:.4g} (gate {STREAM_COST_GATE:g})")
                split = (f"centers_s={centers_s:.4f} stats_s={pass1_s:.4f} "
                         f"mass_s={mass_s:.4f}")
            h2d_sub = 0 if task == "vrlr" else 4 * CENTER_SAMPLE * sum(ds_host.dims)
            log(f"streamed {task} m={m}: build_s={build_s:.4f} rel_error={rep.rel_error:.6g} "
                f"indices_sha256={digest(cs.indices)} comm_units={cs.comm_units} "
                f"comm_bits={cs.comm_bits} touched={touched}/{nb} h2d_bytes={staged + h2d_sub} "
                f"(blocks {staged}, subsample {h2d_sub}) peak_bytes={peak} (limit "
                f"{STREAM_PEAK_BLOCKS * one_block}; materialized phase {4 if task == 'vrlr' else 5}: "
                f"{mat_peaks[(task, m)]}) launches {counts}, fit+evaluate {fit_counts}")
            log(f"breakdown streamed {task} m={m}: {split} round1_s={round1_s:.4f} (the "
                f"{T * nb + 1}-key chain {chain_s:.4f}) round2_s={round2_s:.4f} ({touched} "
                f"touched blocks; probes synchronise){extra}")
            builds[(task, m)] = {"indices": cs.indices, "weights": cs.weights,
                                 "masses": scorer.masses, "ledger": led.by_tag(),
                                 "bill": (cs.comm_units, cs.comm_bits), "h2d": staged,
                                 "build_s": build_s}
            del scorer, plan, cs, fit, rep

    # -- identity: the norm backend at one block is the materialized norm build,
    #    from the host copy (staged) and from the card dataset (sliced in place)
    m = BUDGETS[0]
    for task, params in (("vrlr", {}), ("vkmc", {"k": K_CLUSTERS})):
        key = rng.fold_in(rng.PRNGKey(seed + 900), m)
        mat = build_coreset(task, ds, m, key=key, backend="norm", **params)
        for label, d_ in (("host", ds_host), ("card", ds)):
            st = CoresetPipeline(d_).build(
                CoresetSpec(task=task, budgets=m, engine="streamed", backend="norm",
                            block_size=N_FULL, params=params), key=key)
            if not (torch.equal(st.indices, mat.indices) and torch.equal(st.weights, mat.weights)):
                fail(f"streamed norm {task} ({label} dataset, one block): differs from the "
                     f"materialized norm build")
            if (st.comm_units, st.comm_bits) != (mat.comm_units,
                                                 mat.comm_bits - T * (N_FULL - 1) * 32):
                fail(f"streamed norm {task} ({label}): billed {st.comm_units} / "
                     f"{st.comm_bits}, the materialized {mat.comm_units} / {mat.comm_bits}")
        log(f"streamed norm {task} m={m}, block_size=n: host-resident and card-resident "
            f"builds equal the materialized norm build bit for bit "
            f"(indices_sha256={digest(mat.indices)}), comm_units={mat.comm_units}; bits "
            f"{mat.comm_bits} - T (n - 1) 32 (round 1 carries one float per block)")
    # the uniform task on the streamed engine from the host copy: the
    # materialized engine's indices and weights, bit for bit, and its bill
    key = rng.fold_in(rng.PRNGKey(seed + 200), m)
    mat = build_coreset("uniform", ds, m, key=key)
    st = CoresetPipeline(ds_host).build(
        CoresetSpec(task="uniform", budgets=m, engine="streamed", block_size=BLOCK_SIZE),
        key=key)
    if not (torch.equal(st.indices, mat.indices) and torch.equal(st.weights, mat.weights)
            and (st.comm_units, st.comm_bits) == (mat.comm_units, mat.comm_bits)
            and st.comm_units == CommSchedule.uniform(T, m).total):
        fail(f"streamed uniform m={m}: differs from the materialized uniform build")
    log(f"streamed uniform m={m} from the host copy: equal to the materialized build bit "
        f"for bit (indices_sha256={digest(st.indices)}), comm_units={st.comm_units}")
    log(f"phase 9 took {time.perf_counter() - phase_t0:.1f} s")
    return errs, builds



def pipelined_phase(torch, dev, seed, ds_host, launches, streamed, check_k5, reset_counts,
                    read_counts):
    """Phase 10, the pipelined engine from the host-resident copy of the main
    path's data; returns the largest kernel-vs-plain error it saw, by kernel.
    ``streamed`` holds phase 9's counted builds by (task, m), ``launches``
    the running totals it adds its counted builds to."""
    import numpy as np

    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, build_coreset_streaming,
        dis_plan_streamed, dis_plan_streamed_batched, make_stream_scorer)
    from repro_torch.core import streaming as cst
    from repro_torch.core.dis import _key_chain
    from repro_torch.core.plan import DEFAULT_CHUNK_BLOCKS, PREFETCH_DEFAULT
    from repro_torch.core.sensitivity import batched_gram_pinv
    from repro_torch.core.wire import WirePayload
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import kmeans_assign_update as kkau
    from repro_torch.kernels import leverage as klev
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import weighted_gram as kwg

    T, n = T_PARTIES, N_FULL
    phase_t0 = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(seed + 10)
    errs = dict.fromkeys(("leverage", "weighted_gram", "kmeans_assign_update",
                          "kmeans_assign"), 0.0)
    lev_scale = lambda X, M: klev.plain(X, M).abs().max().item()
    gram_scale = lambda X, w: kwg.plain(X.abs(), w.abs()).max().item()
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS,
                 "center_sample": CENTER_SAMPLE}
    offsets = {"vrlr": 0, "vkmc": 100}                 # phase 9's keys
    C = DEFAULT_CHUNK_BLOCKS
    log(f"pipelined: superchunks of {C} blocks (DEFAULT_CHUNK_BLOCKS); PREFETCH_DEFAULT="
        f"{PREFETCH_DEFAULT}")

    # -- each kernel at the superchunk shapes against its plain version and, bit
    #    for bit, against the streamed engine's per-block launches (outside the
    #    counts): the first superchunk and the ragged last one at each block size
    log("kernels at the superchunk shapes vs plain, and one batched launch vs per-block:")
    for bsz in (BLOCK_SIZE, PIPE_BLOCK):
        nb, bs = ds_host.block_geometry(bsz)
        Cb = min(C, nb)
        for b0 in sorted({0, (nb - 1) // Cb * Cb}):
            ids = list(range(b0, min(b0 + Cb, nb)))
            cnt = len(ids)
            ok = cst._rows_ok(b0, cnt, bs, n, dev)
            X, nvs = ds_host.gather_blocks(ids, bsz, True, device=dev)    # (cnt, 3, bs, 31)
            w = cst._row_weights(ok, X.shape, dev)
            w_blk = [row_valid(torch, bs, int(nv), dev).expand(T, bs) for nv in nvs]
            # K3 against float64 and the plain version: the fp32 cuBLAS products of
            # the plain version sum 16,384- to 65,536-row columns in long chains
            # and land up to 1.7e-5 (scaled) from float64 at these shapes, where
            # K3's fixed row split stays near 1e-7; so the kernel is held within
            # GRAM_TOL of float64, and within the plain version's own distance
            # from float64 plus GRAM_TOL of the plain version (block by block,
            # as phase 9 holds it)
            Gb = kwg.weighted_gram(X, w)
            if not torch.equal(Gb, kwg.weighted_gram(X, w)):
                fail(f"weighted_gram {tuple(X.shape)}: two launches on the same input differ")
            if not torch.equal(Gb, Gb.transpose(-1, -2)):
                fail(f"weighted_gram {tuple(X.shape)}: G is not exactly symmetric")
            if not all(torch.equal(Gb[i], kwg.weighted_gram(X[i], w_blk[i]))
                       for i in range(cnt)):
                fail(f"weighted_gram {tuple(X.shape)}: a block's Gram differs from its "
                     f"own launch")
            want = torch.stack([kwg.plain(X[i], w_blk[i]) for i in range(cnt)])
            X64 = X.double()
            G64 = (X64 * w.double()[..., None]).transpose(-1, -2) @ X64
            scale = max(gram_scale(X[i], w_blk[i]) for i in range(cnt))
            err = float((Gb - want).abs().max())
            e64 = [float((G - G64).abs().max()) / scale
                   for G in (Gb, want, kwg.plain(X, w))]
            del X64, G64
            log(f"  weighted_gram {tuple(X.shape)} {tuple(w.shape)}: max_abs_err={err:.3e} "
                f"scaled={err / scale:.3e} against the plain version block by block "
                f"(tol {GRAM_TOL:g} + the plain version's own gap); from float64, scaled: "
                f"kernel {e64[0]:.3e} (tol {GRAM_TOL:g}), plain block by block "
                f"{e64[1]:.3e}, plain over the batch {e64[2]:.3e}")
            if e64[0] > GRAM_TOL or err / scale > e64[1] + GRAM_TOL:
                fail(f"weighted_gram {tuple(X.shape)}: scaled error {e64[0]:.3e} from "
                     f"float64, {err / scale:.3e} from the plain version (its own gap "
                     f"{e64[1]:.3e}), above {GRAM_TOL:g}")
            errs["weighted_gram"] = max(errs["weighted_gram"], err)
            M = batched_gram_pinv(Gb.sum(0))
            Mb = M.expand(cnt, *M.shape)
            errs["leverage"] = max(errs["leverage"], check_kernel(
                torch, "leverage", klev.leverage, klev.plain, (X, Mb), lev_scale,
                LEVERAGE_TOL))
            check_k1_oracle(torch, klev, X, Mb)
            lev = klev.leverage(X, Mb)
            if not all(torch.equal(lev[i], klev.leverage(X[i], M)) for i in range(cnt)):
                fail(f"leverage {tuple(X.shape)}: a block's scores differ from its own launch")
            # the block masses: each block's (T, bs) slice summed as the streamed
            # engine sums a block; whether one sum over the batch gives the same
            # bits is printed, not relied on
            sc = cst._vrlr_scores(X, M, ok, n, True)
            per = torch.stack([torch.sum(cst._vrlr_scores(
                X[i][None], M, cst._rows_ok(ids[i], 1, bs, n, dev), n, True)[0], dim=1)
                for i in range(cnt)], dim=1)
            if not torch.equal(cst._block_masses(sc), per):
                fail(f"block masses {tuple(sc.shape)}: differ from the per-block sums")
            one_sum = torch.equal(torch.sum(sc, dim=2).T, per)
            log(f"  block masses {tuple(sc.shape)}: == per-block sums, bit for bit (one "
                f"torch.sum over the batch: {'the same bits' if one_sum else 'other bits'})")
            del X, Gb, lev, sc
            Xk, _ = ds_host.gather_blocks(ids, bsz, False, device=dev)      # (cnt, 3, bs, 30)
            Ck = Xk[0][:, torch.randperm(bs, generator=gen)[:K_CLUSTERS].to(dev)].contiguous()
            Ckb = Ck.expand(cnt, *Ck.shape)
            wk = cst._row_weights(ok, Xk.shape, dev)
            errs["kmeans_assign_update"] = max(errs["kmeans_assign_update"], check_kmeans(
                torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update, kkau.plain,
                Xk, Ckb, wk, fused=True))
            check_k2_oracle(torch, kkau, Xk, Ckb, wk)
            _, _, _, ws, cc = kkau.kmeans_assign_update(Xk, Ckb, wk)
            for i in range(cnt):
                _, _, _, ws_i, cc_i = kkau.kmeans_assign_update(Xk[i], Ck, w_blk[i])
                if not (torch.equal(ws[i], ws_i) and torch.equal(cc[i], cc_i)):
                    fail(f"kmeans_assign_update {tuple(Xk.shape)}: a block's sizes or "
                         f"costs differ from its own launch")
            errs["kmeans_assign"] = max(errs["kmeans_assign"], check_kmeans(
                torch, kref, "kmeans_assign", kka.kmeans_assign, kka.plain, Xk, Ckb))
            check_k4_oracle(torch, kka, Xk, Ckb)
            a, d2 = kka.kmeans_assign(Xk, Ckb)
            for i in range(cnt):
                a_i, d2_i = kka.kmeans_assign(Xk[i], Ck)
                if not (torch.equal(a[i], a_i) and torch.equal(d2[i], d2_i)):
                    fail(f"kmeans_assign {tuple(Xk.shape)}: a block differs from its own "
                         f"launch")
            log(f"  blocks {ids[0]}..{ids[-1]} at block_size {bsz}: K3, K1, K2 and K4 over "
                f"the batch == their per-block launches, bit for bit")
            if b0 == 0 and bsz == PIPE_BLOCK:
                # one batched launch against the streamed engine's per-block ones
                per_ms = lambda f: cuda_ms(torch, lambda: [f(i) for i in range(cnt)])
                Xf, _ = ds_host.gather_blocks(ids, bsz, True, device=dev)
                t = [(cuda_ms(torch, lambda: kwg.weighted_gram(Xf, w)),
                      per_ms(lambda i: kwg.weighted_gram(Xf[i], w_blk[i]))),
                     (cuda_ms(torch, lambda: klev.leverage(Xf, Mb)),
                      per_ms(lambda i: klev.leverage(Xf[i], M))),
                     (cuda_ms(torch, lambda: kkau.kmeans_assign_update(Xk, Ckb, wk)),
                      per_ms(lambda i: kkau.kmeans_assign_update(Xk[i], Ck, w_blk[i]))),
                     (cuda_ms(torch, lambda: kka.kmeans_assign(Xk, Ckb)),
                      per_ms(lambda i: kka.kmeans_assign(Xk[i], Ck)))]
                log("  one launch over the superchunk vs " + str(cnt) + " per-block launches "
                    "(ms): " + ", ".join(f"{nm} {a_:.4f} vs {b_:.4f}" for nm, (a_, b_) in
                                        zip(("K3", "K1", "K2", "K4"), t)))
                del Xf
            del Xk, a, d2
        # K5: round 1 over the T * nb cells, and a redraw group: 3 C cells of which
        # every other one drawn, over a full block's rows and the ragged one's
        keys = rng.split(rng.PRNGKey(seed + 16 + bsz), T * Cb).to(dev)
        m = BUDGETS[-1]
        per = m // (T * nb)
        check_k5(keys[:1], torch.log(torch.rand(1, T * nb, generator=gen) + 0.01).to(dev), m,
                 [m], f"pipelined round 1, block_size {bsz}, m={m}")
        lg = torch.log(torch.rand(T * Cb, bs, generator=gen) + 0.01).to(dev)
        lg[T * Cb // 2:, n - (nb - 1) * bs:] = -float("inf")
        check_k5(keys, lg, m, [per * (i % 2) for i in range(T * Cb)],
                 f"pipelined redraw group, block_size {bsz}, m={m}")
        del lg

    # -- the builds, counted: (a) the shim's defaults against phase 9's streamed
    #    builds; (b) block 16,384 against a streamed build of this phase
    def run(fn, ds):
        """(result, build_s, launches, peak bytes above the start, staged bytes)."""
        staged0 = ds.staged_bytes
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        return (out, build_s, counts, torch.cuda.max_memory_allocated() - before,
                ds.staged_bytes - staged0)

    def add(counts):
        for nm in launches:
            launches[nm] += counts[nm]

    def want_launches(task, nchunks, groups):
        if task == "vrlr":
            return {"leverage": nchunks + groups, "weighted_gram": nchunks,
                    "kmeans_assign": 0, "kmeans_assign_update": 0, "categorical": 1 + groups}
        return {"leverage": 0, "weighted_gram": 0, "kmeans_assign": nchunks + groups,
                "kmeans_assign_update": T * LOCAL_ITERS + nchunks,
                "categorical": T * K_CLUSTERS + 1 + groups}

    def breakdown(task, key, bsz, m, chunk, prefetch, params):
        """The build again by stage, a synchronising probe after every superchunk:
        (scorer, plan, split text)."""
        nb, _ = ds_host.block_geometry(bsz)
        nch = -(-nb // chunk)
        stamps = []

        def probe():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        scorer = make_stream_scorer(task, key, ds_host, bsz, "pallas", probe=probe,
                                    device=dev, chunk_blocks=chunk, prefetch=prefetch,
                                    **params)
        split = ""
        if task == "vkmc":
            split = f"centers_s={stamps[1] - stamps[0]:.4f} "
            del stamps[0]
        split += (f"{'gram' if task == 'vrlr' else 'stats'}_s={stamps[nch] - stamps[0]:.4f} "
                  f"mass_s={stamps[2 * nch] - stamps[nch]:.4f}")
        t0 = time.perf_counter()
        subs = _key_chain(scorer.dis_key, T * nb + 1)
        draws = kops.categorical(subs[0], rng.log(torch.clamp_min(
            scorer.masses.reshape(-1), 1e-30)), m)
        np.bincount(draws.cpu().numpy(), minlength=T * nb)
        t1 = time.perf_counter()
        redraw = dis_plan_streamed_batched if chunk > 1 or prefetch else dis_plan_streamed
        plan = redraw(scorer, m)
        torch.cuda.synchronize()
        split += (f" round1_s={t1 - t0:.4f} round2_s="
                  f"{time.perf_counter() - t1 - (t1 - t0):.4f}")
        return scorer, plan, split

    def same(a, b):
        return torch.equal(a.indices, b["indices"]) and torch.equal(a.weights, b["weights"])

    stage_s = {"kernels": time.perf_counter() - phase_t0}
    t_stage = time.perf_counter()
    rows = []
    for task in ("vrlr", "vkmc"):
        params = {} if task == "vrlr" else vk_params
        with_labels = task == "vrlr"
        _, s = ds_host.stacked_widths(with_labels)
        # (a) build_coreset_streaming with its defaults, phase 9's keys and data
        nb, bs = ds_host.block_geometry(BLOCK_SIZE)
        Ca = min(C, nb)
        nch = -(-nb // Ca)
        one_block = 4 * T * bs * s
        limit = PIPE_PEAK_FACTOR * Ca * one_block
        for m in BUDGETS:
            key = rng.fold_in(rng.PRNGKey(seed + offsets[task]), m)
            ref_ = streamed[(task, m)]
            led = CommLedger()
            cs, build_s, counts, peak, staged = run(
                lambda: build_coreset_streaming(task, ds_host, m, key=key, ledger=led,
                                                **params), ds_host)
            add(counts)
            touched = len({int(i) // bs for i in cs.indices.tolist()})
            groups = -(-touched // Ca)
            want = want_launches(task, nch, groups)
            if not same(cs, ref_):
                fail(f"pipelined {task} m={m} (defaults): differs from phase 9's streamed "
                     f"build (indices_sha256 {digest(cs.indices)} vs "
                     f"{digest(ref_['indices'])})")
            if ((cs.comm_units, cs.comm_bits) != ref_["bill"]
                    or led.by_tag() != ref_["ledger"]):
                fail(f"pipelined {task} m={m}: billed {cs.comm_units} / {cs.comm_bits}, "
                     f"phase 9 {ref_['bill']}")
            if counts != want:
                fail(f"pipelined {task} m={m}: launches {counts}, counted {want} from the code "
                     f"({nch} superchunks, {touched} touched blocks in {groups} groups)")
            if staged != ref_["h2d"]:
                fail(f"pipelined {task} m={m}: staged {staged} bytes, the streamed engine "
                     f"{ref_['h2d']}")
            if peak > limit:
                fail(f"pipelined {task} m={m}: the build's peak device memory {peak} above "
                     f"{PIPE_PEAK_FACTOR} superchunks ({limit:.0f})")
            scorer, plan, split = breakdown(task, key, BLOCK_SIZE, m, Ca,
                                            PREFETCH_DEFAULT["cuda"], params)
            if not torch.equal(scorer.masses, ref_["masses"]):
                fail(f"pipelined {task} m={m}: block masses differ from phase 9's")
            if not same(plan, ref_):
                fail(f"pipelined {task} m={m}: the staged rerun drew another coreset")
            bill = CommSchedule.dis(T, m, counts=plan.counts.tolist(),
                                    round1_payload=WirePayload.of((nb,), "float32", "raw_fp32"))
            if (cs.comm_units, cs.comm_bits) != (bill.total, bill.total_bits):
                fail(f"pipelined {task} m={m}: bill differs from CommSchedule.dis")
            rows.append((task, m, BLOCK_SIZE, PREFETCH_DEFAULT["cuda"], build_s, ref_["build_s"],
                         peak, limit, staged, counts))
            log(f"pipelined {task} m={m} (build_coreset_streaming defaults: block_size "
                f"{BLOCK_SIZE}, {nch} superchunk(s) of {Ca}, prefetch "
                f"{PREFETCH_DEFAULT['cuda']}): build_s={build_s:.4f} (phase 9 streamed "
                f"{ref_['build_s']:.4f}) indices_sha256={digest(cs.indices)} == phase 9, "
                f"weights and masses bit for bit, comm_units={cs.comm_units} "
                f"comm_bits={cs.comm_bits}; peak_bytes={peak} (limit {limit:.0f}) "
                f"h2d_bytes={staged} (streamed {ref_['h2d']}) touched={touched}/{nb} "
                f"launches {counts}")
            log(f"breakdown pipelined {task} m={m}: {split} (probes synchronise)")
            del cs, scorer, plan

        # (b) block 16,384: a streamed build, then the pipelined engine with
        # prefetch on and off, at m = 5000
        m = BUDGETS[-1]
        key = rng.fold_in(rng.PRNGKey(seed + offsets[task] + 16), m)
        nb, bs = ds_host.block_geometry(PIPE_BLOCK)
        Cb = min(C, nb)
        nch = -(-nb // Cb)
        one_block = 4 * T * bs * s
        limit = PIPE_PEAK_FACTOR * Cb * one_block
        base = CoresetSpec(task=task, budgets=m, block_size=PIPE_BLOCK, params=params)
        led_s = CommLedger()
        st, st_s, _, st_peak, st_staged = run(
            lambda: CoresetPipeline(ds_host).build(base.replace(engine="streamed"), key=key,
                                                   ledger=led_s), ds_host)
        ref_ = {"indices": st.indices, "weights": st.weights}
        st_scorer, st_plan, st_split = breakdown(task, key, PIPE_BLOCK, m, 1, False, params)
        if not same(st_plan, ref_):
            fail(f"streamed {task} m={m} at block_size {PIPE_BLOCK}: the rerun differs")
        touched = len({int(i) // bs for i in st.indices.tolist()})
        groups = -(-touched // Cb)
        log(f"streamed {task} m={m} at block_size {PIPE_BLOCK} ({nb} blocks): "
            f"build_s={st_s:.4f} peak_bytes={st_peak} h2d_bytes={st_staged} "
            f"touched={touched}; breakdown {st_split}")
        for prefetch in (True, False):
            led = CommLedger()
            spec = base.replace(engine="pipelined", chunk_blocks=C, prefetch=prefetch)
            cs, build_s, counts, peak, staged = run(
                lambda: CoresetPipeline(ds_host).build(spec, key=key, ledger=led), ds_host)
            add(counts)
            want = want_launches(task, nch, groups)
            if not same(cs, ref_):
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK} prefetch {prefetch}: "
                     f"differs from the streamed build")
            if ((cs.comm_units, cs.comm_bits) != (st.comm_units, st.comm_bits)
                    or led.by_tag() != led_s.by_tag()):
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK}: bill differs")
            if counts != want:
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK} prefetch {prefetch}: "
                     f"launches {counts}, counted {want} ({nch} superchunks, {touched} "
                     f"touched blocks in {groups} groups)")
            if staged != st_staged:
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK}: staged {staged} "
                     f"bytes, the streamed engine {st_staged}")
            if peak > limit:
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK} prefetch {prefetch}: "
                     f"peak device memory {peak} above {PIPE_PEAK_FACTOR} superchunks "
                     f"({limit:.0f})")
            scorer, plan, split = breakdown(task, key, PIPE_BLOCK, m, C, prefetch, params)
            if not (torch.equal(scorer.masses, st_scorer.masses) and same(plan, ref_)):
                fail(f"pipelined {task} m={m} block_size {PIPE_BLOCK} prefetch {prefetch}: "
                     f"masses or the rerun's draw differ from the streamed engine's")
            rows.append((task, m, PIPE_BLOCK, prefetch, build_s, st_s, peak, limit, staged,
                         counts))
            log(f"pipelined {task} m={m} block_size {PIPE_BLOCK} ({nch} superchunks of "
                f"{Cb}) prefetch {prefetch}: build_s={build_s:.4f} (streamed {st_s:.4f}) "
                f"== the streamed build bit for bit (indices_sha256={digest(cs.indices)}, "
                f"weights, masses, bill {cs.comm_units} / {cs.comm_bits}); peak_bytes={peak} "
                f"(limit {limit:.0f}; streamed {st_peak}) h2d_bytes={staged} (streamed "
                f"{st_staged}) launches {counts}")
            log(f"breakdown pipelined {task} m={m} block_size {PIPE_BLOCK} prefetch "
                f"{prefetch}: {split} (probes synchronise)")
            del cs, scorer, plan
        del st, st_scorer, st_plan

    # (c) the prefetch ablation: vrlr at block 4,096 (nb = 114, 15 superchunks),
    #     m = 1000, prefetch on and off in turn, after one scorer of each (its
    #     pinned slots and shapes) as the warm-up
    stage_s["builds (a), (b)"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    m = BUDGETS[0]
    key = rng.fold_in(rng.PRNGKey(seed + 17), m)
    nb, bs = ds_host.block_geometry(ABLATION_BLOCK)
    nch = -(-nb // C)
    spec = CoresetSpec(task="vrlr", budgets=m, engine="pipelined", block_size=ABLATION_BLOCK,
                       chunk_blocks=C)
    for prefetch in (True, False):
        make_stream_scorer("vrlr", key, ds_host, ABLATION_BLOCK, "pallas", device=dev,
                           chunk_blocks=C, prefetch=prefetch)
    times = {True: [], False: []}
    first = None
    for i in range(ABLATION_RUNS):
        for prefetch in ((True, False) if i % 2 == 0 else (False, True)):
            cs, build_s, counts, peak, staged = run(
                lambda: CoresetPipeline(ds_host).build(spec.replace(prefetch=prefetch),
                                                       key=key), ds_host)
            add(counts)
            first = first or {"indices": cs.indices, "weights": cs.weights}
            if not same(cs, first):
                fail(f"pipelined vrlr block_size {ABLATION_BLOCK} prefetch {prefetch}: "
                     f"another coreset than the first run's")
            times[prefetch].append(build_s)
            del cs
    med = {p: sorted(t)[len(t) // 2] for p, t in times.items()}
    winner = min(med, key=med.get)
    log(f"prefetch ablation, vrlr m={m} block_size {ABLATION_BLOCK} ({nb} blocks, {nch} "
        f"superchunks of {C}), {ABLATION_RUNS} runs each, build_s: on "
        f"{[round(t, 4) for t in times[True]]} (median {med[True]:.4f}), off "
        f"{[round(t, 4) for t in times[False]]} (median {med[False]:.4f}); winner: prefetch "
        f"{'on' if winner else 'off'}; PREFETCH_DEFAULT['cuda'] = {PREFETCH_DEFAULT['cuda']}"
        f"; last run peak_bytes={peak} (2.5 superchunks: "
        f"{PIPE_PEAK_FACTOR * C * 4 * T * bs * 31:.0f}, not gated at this block size) "
        f"h2d_bytes={staged} launches {counts}")
    log("pipelined table (task, m, block_size, prefetch, build_s, streamed build_s, "
        "peak_bytes, limit, h2d_bytes, launches):")
    for r in rows:
        log(f"  {r[0]} {r[1]} {r[2]} {r[3]} {r[4]:.4f} {r[5]:.4f} {r[6]} {r[7]:.0f} {r[8]} "
            f"{r[9]}")
    ds_host._staging.clear()
    stage_s["ablation (c)"] = time.perf_counter() - t_stage
    log(f"phase 10 took {time.perf_counter() - phase_t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_s.items()) + ")")
    return errs


def sharded_phase(torch, dev, seed, ds_host, ds, lam, launches, card, reset_counts,
                  read_counts):
    """Phase 11 from the host-resident copy ``ds_host`` of the main path's
    data (``ds`` the same data on the card, for the fits and the
    materialized engine): (a) the sharded block masses at block 66,245,
    without a process group and in an NCCL world of one; (b) the party fault
    and integrity seam on the materialized and pipelined engines.  Returns
    the largest kernel-vs-plain error it saw, by kernel; adds its counted
    builds to ``launches``; ``card`` is the card's name and power limit."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, FaultPlan, Transport,
        evaluate, fit_kmeans, fit_ridge, make_stream_scorer, vkmc_block_masses_sharded,
        vrlr_block_masses_sharded)
    from repro_torch.core import streaming as cst
    from repro_torch.core.plan import DEFAULT_CHUNK_BLOCKS
    from repro_torch.core.sensitivity import batched_gram_pinv
    from repro_torch.core.wire import WirePayload
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import leverage as klev
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import weighted_gram as kwg

    T, n = T_PARTIES, N_FULL
    phase_t0 = time.perf_counter()
    errs = dict.fromkeys(("leverage", "weighted_gram", "kmeans_assign"), 0.0)
    nb, bs = ds_host.block_geometry(SHARD_BLOCK)
    C = min(DEFAULT_CHUNK_BLOCKS, nb)
    nch = -(-nb // C)
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS,
                 "center_sample": CENTER_SAMPLE}
    log(f"sharded: block_size {SHARD_BLOCK} ({nb} blocks of {bs} rows, {nch} superchunk(s) "
        f"of {C}); the shard grid at D = 1: n % D == 0 and (n / D) % bs == 0")

    # -- each kernel at the shard's shapes against its plain version (outside
    #    the counts): K3 with unit weights and K1 at (3, n, 31), K4 at
    #    (3, n, 30) x (3, 10, 30), the shards being built as the tables build them
    log("kernels at the shard's shapes vs plain:")
    widths, s = ds_host.stacked_widths(True)
    f = cst._stacked_rows(ds_host, 0, n, widths, s, True, dev)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    lev_scale = lambda X, M: klev.plain(X, M).abs().max().item()
    gram_scale = lambda X, w: kwg.plain(X.abs(), w.abs()).max().item()
    # K3 against float64 and the plain version party by party: the plain
    # version over the (3, n, 31) batch (a batched cuBLAS product) lands
    # 1.6e-4 (scaled) from float64 at this shape on an H100 (PERF.md, section
    # 6), one party at a time 2.5e-7, as phase 3's (n, 90); so the kernel is held
    # within GRAM_TOL of float64 and within the per-party plain version's own
    # distance from float64 plus GRAM_TOL of it, as phase 10 holds its blocks
    G = kwg.weighted_gram(f, ones)
    if not torch.equal(G, kwg.weighted_gram(f, ones)) or not torch.equal(G, G.transpose(1, 2)):
        fail(f"weighted_gram {tuple(f.shape)}: two launches differ or G is not symmetric")
    want = torch.stack([kwg.plain(f[j], ones) for j in range(T)])
    f64 = f.double()
    G64 = f64.transpose(1, 2) @ f64
    del f64
    scale = gram_scale(f, ones)
    e64 = [float((g - G64).abs().max()) / scale for g in (G, want, kwg.plain(f, ones))]
    err = float((G - want).abs().max())
    log(f"  weighted_gram {tuple(f.shape)} {tuple(ones.shape)}: max_abs_err={err:.3e} "
        f"scaled={err / scale:.3e} against the plain version party by party (tol "
        f"{GRAM_TOL:g} + the plain version's own gap); from float64, scaled: kernel "
        f"{e64[0]:.3e} (tol {GRAM_TOL:g}), plain party by party {e64[1]:.3e}, plain over "
        f"the batch {e64[2]:.3e}")
    if e64[0] > GRAM_TOL or err / scale > e64[1] + GRAM_TOL:
        fail(f"weighted_gram {tuple(f.shape)}: scaled error {e64[0]:.3e} from float64, "
             f"{err / scale:.3e} from the plain version (its own gap {e64[1]:.3e})")
    errs["weighted_gram"] = err
    M = batched_gram_pinv(G)
    del G, G64, want
    errs["leverage"] = check_kernel(torch, "leverage", klev.leverage, klev.plain, (f, M),
                                    lev_scale, LEVERAGE_TOL)
    del f, M
    widths_k, sk_ = ds_host.stacked_widths(False)
    fk = cst._stacked_rows(ds_host, 0, n, widths_k, sk_, False, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed + 11)
    Ck = fk[:, torch.randperm(n, generator=gen)[:K_CLUSTERS].to(dev)].contiguous()
    errs["kmeans_assign"] = check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign,
                                         kka.plain, fk, Ck)
    del fk, Ck

    def run(fn):
        """(result, seconds, launches, peak bytes above the start)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        for nm in launches:
            launches[nm] += counts[nm]
        return out, secs, counts, torch.cuda.max_memory_allocated() - before

    calls = [0]
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(*a, **kw):
        calls[0] += 1
        return real_all_reduce(*a, **kw)

    dist.all_reduce = counted_all_reduce

    def same_draw(a, b):
        return torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)

    def same(a, b):
        return same_draw(a, b) and (a.comm_units, a.comm_bits) == (b.comm_units, b.comm_bits)

    # -- (a) the sharded tables and builds: without a group, then in an NCCL
    #    world of one (the same bits, two all-reduces per table)
    t_stage = time.perf_counter()
    tables, builds = {}, {}
    for world in ("none", "nccl"):
        if world == "nccl":
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=datetime.timedelta(seconds=120))
            # the communicator is set up by the first collective: time it apart
            t0 = time.perf_counter()
            real_all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            log(f"  NCCL world of one: the first all-reduce (communicator set-up) took "
                f"{time.perf_counter() - t0:.4f} s; {card}")
            # NCCL takes CUDA tensors only: a table on the CPU under the group raises
            try:
                vrlr_block_masses_sharded(ds_host, SHARD_BLOCK, device="cpu")
            except ValueError as e:
                log(f"  a CPU table under the NCCL group raises: {e}")
            else:
                fail("sharded: a CPU table under an NCCL group did not raise")
        try:
            for task in ("vrlr", "vkmc"):
                params = {} if task == "vrlr" else vk_params
                key = rng.fold_in(rng.PRNGKey(seed + 400 + (task == "vkmc")), 1)
                calls[0] = 0
                if task == "vrlr":
                    tbl, sharded_s, counts, peak = run(
                        lambda: vrlr_block_masses_sharded(ds_host, SHARD_BLOCK))
                    want = {"leverage": 1, "weighted_gram": 1, "kmeans_assign": 0,
                            "kmeans_assign_update": 0, "categorical": 0}
                else:
                    tbl, sharded_s, counts, peak = run(
                        lambda: vkmc_block_masses_sharded(ds_host, SHARD_BLOCK, key=key,
                                                          **vk_params))
                    want = {"leverage": 0, "weighted_gram": 0, "kmeans_assign": 1,
                            "kmeans_assign_update": T * LOCAL_ITERS,
                            "categorical": T * K_CLUSTERS}
                if calls[0] != (2 if world == "nccl" else 0):
                    fail(f"sharded {task} ({world}): {calls[0]} all-reduce calls")
                if counts != want:
                    fail(f"sharded {task} table ({world}): launches {counts}, counted {want}")
                _, sw = ds_host.stacked_widths(task == "vrlr")
                shard_bytes = 4 * T * n * sw
                tables[(world, task)] = tbl
                if world == "nccl" and not torch.equal(tbl, tables[("none", task)]):
                    fail(f"sharded {task}: the NCCL world-1 table differs from the "
                         f"groupless one")
                if world == "none":
                    scorer = make_stream_scorer(task, key, ds_host, SHARD_BLOCK, "pallas",
                                                device=dev, chunk_blocks=C, prefetch=True,
                                                **params)
                    gap = float(((tbl - scorer.masses).abs()
                                 - (1e-6 + 1e-4 * scorer.masses.abs())).max())
                    rel = float(((tbl - scorer.masses).abs() / scorer.masses.abs()).max())
                    if gap > 0:
                        fail(f"sharded {task}: table outside rtol 1e-4, atol 1e-6 of the "
                             f"scorer's (max rel {rel:.3e})")
                    passes = make_stream_scorer(task, key, ds_host, SHARD_BLOCK, "pallas",
                                                device=dev, chunk_blocks=C, prefetch=True,
                                                masses=tbl, **params).data_passes
                    if passes != (1 if task == "vrlr" else 2):
                        fail(f"sharded {task}: data_passes {passes} with a supplied table")
                    log(f"sharded {task} table ({T}, {nb}): sharded_s={sharded_s:.4f} "
                        f"peak_bytes={peak} (the shard {shard_bytes} bytes) launches "
                        f"{counts}; max rel to the scorer's table {rel:.3e} (rtol 1e-4, "
                        f"atol 1e-6); data_passes with it {passes}; {card}")
                else:
                    log(f"sharded {task} table in an NCCL world of one: sharded_s="
                        f"{sharded_s:.4f} peak_bytes={peak}, 2 all-reduces, == the "
                        f"groupless table bit for bit; {card}")
                for m in BUDGETS:
                    spec = CoresetSpec(task=task, budgets=m, engine="pipelined",
                                       block_size=SHARD_BLOCK, sharded_masses=True,
                                       params=params)
                    led = CommLedger()
                    bkey = rng.fold_in(key, m)
                    calls[0] = 0
                    cs, build_s, counts, peak = run(
                        lambda: CoresetPipeline(ds_host).build(spec, key=bkey, ledger=led))
                    touched = len({int(i) // bs for i in cs.indices.tolist()})
                    groups = -(-touched // C)
                    want = ({"leverage": 1 + groups, "weighted_gram": 1 + nch,
                             "kmeans_assign": 0, "kmeans_assign_update": 0,
                             "categorical": 1 + groups} if task == "vrlr" else
                            {"leverage": 0, "weighted_gram": 0, "kmeans_assign": 1 + groups,
                             "kmeans_assign_update": T * LOCAL_ITERS + nch,
                             "categorical": T * K_CLUSTERS + 1 + groups})
                    if counts != want:
                        fail(f"sharded {task} m={m} ({world}): launches {counts}, counted "
                             f"{want} ({touched} touched blocks in {groups} groups)")
                    if calls[0] != (2 if world == "nccl" else 0):
                        fail(f"sharded {task} m={m} ({world}): {calls[0]} all-reduces")
                    # the total and the bits do not depend on the realised split
                    bill = CommSchedule.dis(
                        T, m, counts=[m] + [0] * (T - 1),
                        round1_payload=WirePayload.of((nb,), "float32", "raw_fp32"))
                    if (cs.comm_units, cs.comm_bits) != (bill.total, bill.total_bits) or \
                            led.total != cs.comm_units:
                        fail(f"sharded {task} m={m}: billed {cs.comm_units} / "
                             f"{cs.comm_bits}, the schedule {bill.total} / {bill.total_bits}")
                    if cs.indices.shape != (m,) or not bool((cs.weights > 0).all()):
                        fail(f"sharded {task} m={m}: malformed coreset")
                    if seed == 0 and digest(cs.indices) != SHARDED_DIGESTS[(task, m)]:
                        fail(f"sharded {task} m={m}: indices_sha256 {digest(cs.indices)}, "
                             f"recorded {SHARDED_DIGESTS[(task, m)]}")
                    builds[(world, task, m)] = cs
                    if world == "nccl":
                        if not same(cs, builds[("none", task, m)]):
                            fail(f"sharded {task} m={m}: the NCCL world-1 build differs "
                                 f"from the groupless one")
                        log(f"sharded {task} m={m} in an NCCL world of one: build_s="
                            f"{build_s:.4f}, == the groupless build bit for bit "
                            f"(indices, weights, bill); {card}")
                        continue
                    if task == "vrlr":
                        rep = evaluate(ds, fit_ridge(ds, cs, lam))
                    else:
                        fk_key = rng.fold_in(bkey, 1)
                        rep = evaluate(ds, fit_kmeans(ds, cs, K_CLUSTERS, key=fk_key,
                                                      iters=FIT_ITERS),
                                       key=fk_key, iters=FIT_ITERS)
                    if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
                        fail(f"sharded {task} m={m}: rel_error {rep.rel_error}")
                    log(f"sharded {task} m={m} (pipelined, block_size {SHARD_BLOCK}, "
                        f"sharded_masses): build_s={build_s:.4f} peak_bytes={peak} "
                        f"comm_units={cs.comm_units} comm_bits={cs.comm_bits} "
                        f"rel_error={rep.rel_error:.6g} launches {counts} "
                        f"indices_sha256={digest(cs.indices)}; {card}")
        finally:
            if world == "nccl":
                dist.destroy_process_group()
    dist.all_reduce = real_all_reduce
    stage_s = {"kernels": t_stage - phase_t0, "sharded (a)": time.perf_counter() - t_stage}

    # -- (b) the fault seam, both tasks, on the materialized engine (the card
    #    dataset, m = 5000) and the pipelined one (the host copy, block 66,245,
    #    sharded masses)
    t_stage = time.perf_counter()
    m = BUDGETS[-1]
    for engine, data in (("materialized", ds), ("pipelined", ds_host)):
        for task in ("vrlr", "vkmc"):
            params = {} if task == "vrlr" else dict(vk_params)
            if engine == "materialized":
                params.pop("center_sample", None)     # k-means on every row
            kw = dict(task=task, budgets=m, engine=engine, params=params)
            if engine == "pipelined":
                kw.update(block_size=SHARD_BLOCK, sharded_masses=True)
            spec = CoresetSpec(**kw)
            key = rng.fold_in(rng.PRNGKey(seed + 500 + (task == "vkmc")), m)
            pipe = CoresetPipeline(data)
            led0 = CommLedger()
            base, base_s, base_counts, _ = run(lambda: pipe.build(spec, key=key, ledger=led0))
            path = [nm for nm, c in base_counts.items() if c]
            times = [f"transportless {base_s:.4f}"]
            for policy in ("fail", "retry", "degrade", "quarantine"):
                led = CommLedger()
                cs, secs, counts, _ = run(lambda: pipe.build(
                    spec.replace(fault_policy=policy), key=key, ledger=led,
                    transport=Transport(FaultPlan.none())))
                if not same(cs, base) or led.messages != led0.messages or cs.degraded:
                    fail(f"fault seam {engine} {task}: a null-plan transport under "
                         f"{policy} differs from the transportless build")
                if counts != base_counts:
                    fail(f"fault seam {engine} {task} {policy}: launches {counts}, the "
                         f"transportless build {base_counts}")
                times.append(f"{policy} {secs:.4f}")
            # chaos, replayed
            chaos = []
            for _ in range(2):
                led, tr = CommLedger(), Transport(FaultPlan(seed=123, drop=0.3,
                                                            max_retries=6))
                cs, secs, counts, _ = run(lambda: pipe.build(
                    spec.replace(fault_policy="retry"), key=key, ledger=led, transport=tr))
                chaos.append((cs, led, tr.stats.as_dict(), secs))
            (c1, l1, s1, t1), (c2, l2, s2, _) = chaos
            base_tags = {t: u for t, u in l1.by_tag().items() if not t.startswith("retry/")}
            if not (same(c1, c2) and l1.messages == l2.messages and s1 == s2):
                fail(f"fault seam {engine} {task}: the chaos build did not replay")
            if not (same_draw(c1, base) and base_tags == led0.by_tag()
                    and l1.total == led0.total + l1.by_prefix("retry/")
                    and c1.comm_units == l1.total and s1["retries"] > 0):
                fail(f"fault seam {engine} {task}: chaos billed {l1.total} = base "
                     f"{led0.total} + retry {l1.by_prefix('retry/')}? stats {s1}")
            times.append(f"chaos {t1:.4f}")
            # degrade (party 0 never answers) and quarantine (party 0 poisons its
            # table on an unverifying wire): the survivors' draw is a build on
            # select_parties([1, 2]) with the same key
            sub, sub_s, sub_counts, _ = run(lambda: CoresetPipeline(
                data.select_parties([1, 2])).build(spec, key=key))
            for policy, tr in (
                    ("degrade", Transport(FaultPlan(seed=0, drop={0: 1.0}, max_retries=2))),
                    ("quarantine", Transport(FaultPlan(seed=11, silent_corrupt={0: 1.0},
                                                       silent_kind="sign"), verify=False))):
                led = CommLedger()
                cs, secs, counts, _ = run(lambda: pipe.build(
                    spec.replace(fault_policy=policy), key=key, ledger=led, transport=tr))
                d = cs.degraded
                if d is None or d.surviving != (1, 2) or [x.party for x in d.dropped] != [0]:
                    fail(f"fault seam {engine} {task} {policy}: receipt {d}")
                if not same_draw(cs, sub):
                    fail(f"fault seam {engine} {task} {policy}: the survivors' draw differs "
                         f"from the select_parties build")
                if cs.comm_units != led.total or cs.comm_bits != led.total_bits:
                    fail(f"fault seam {engine} {task} {policy}: billed {cs.comm_units}, "
                         f"the ledger {led.total}")
                if policy == "degrade" and counts != sub_counts:
                    fail(f"fault seam {engine} {task} degrade: launches {counts}, the "
                         f"select_parties build {sub_counts}")
                if any(counts[nm] < sub_counts[nm] for nm in counts):
                    fail(f"fault seam {engine} {task} quarantine: launches {counts}")
                times.append(f"{policy} {secs:.4f}")
                log(f"  {engine} {task} {policy}: {d.describe()}; comm_units "
                    f"{cs.comm_units} == ledger; draw == select_parties([1, 2]) build")
            log(f"fault seam {engine} {task} m={m}"
                + (f" (block_size {SHARD_BLOCK}, sharded_masses)" if engine == "pipelined"
                   else "")
                + f": null plan x 4 policies == the transportless build bit for bit "
                f"(indices, weights, ledger, launches {base_counts}); chaos replays, ledger "
                f"{l1.total} = {led0.total} + retry {l1.by_prefix('retry/')} "
                f"({s1['retries']} retries, {s1['drops']} drops); build_s: "
                + ", ".join(times) + f"; path kernels {path}; {card}")
    stage_s["fault seam (b)"] = time.perf_counter() - t_stage
    log(f"phase 11 took {time.perf_counter() - phase_t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_s.items()) + f"); {card}")
    return errs


def planner_phase(torch, dev, seed, ds_host, ds, launches, card, reset_counts, read_counts):
    """Phase 12 from the host-resident copy ``ds_host`` of the main path's
    data (``ds`` the same data on the card): (a) checkpointed resume of
    pipelined builds at block 16,384, crashed at three points and rerun;
    (b) the planner's memory model against each engine's measured own peak;
    (c) auto plans under memory and bit budgets, and the plan cache; (d) the
    failover from pipelined to streamed under a memory budget.  Adds its
    counted builds to ``launches``; ``card`` is the card's name and power
    limit."""
    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CoresetPipeline, CoresetSpec, FaultPlan, PlanCache, StreamCheckpoint,
        Transport)
    from repro_torch.core.wire import CODEC_LADDER, predict_dis_bits

    T, n = T_PARTIES, N_FULL
    phase_t0 = time.perf_counter()
    m = BUDGETS[-1]
    C = 8
    nb, bs = ds_host.block_geometry(PIPE_BLOCK)
    nch = -(-nb // C)
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS,
                 "center_sample": CENTER_SAMPLE}
    keys = {task: rng.fold_in(rng.PRNGKey(seed + 600 + (task == "vkmc")), m)
            for task in ("vrlr", "vkmc")}

    def run(fn, data=ds_host):
        """(result, seconds, launches, peak bytes above the start, staged bytes)."""
        staged0 = data.staged_bytes
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        for nm in launches:
            launches[nm] += counts[nm]
        return (out, secs, counts, torch.cuda.max_memory_allocated() - before,
                data.staged_bytes - staged0)

    def same(a, b):
        return (torch.equal(a.indices, b.indices) and torch.equal(a.weights, b.weights)
                and (a.comm_units, a.comm_bits) == (b.comm_units, b.comm_bits))

    def chunk_bytes(s, done):
        """Bytes staged by the first ``done`` superchunks of a pass."""
        return sum(min(C, nb - c * C) for c in range(done)) * 4 * T * bs * s

    class Bomb:
        """A probe that raises at its ``at``-th call."""

        def __init__(self, at):
            self.at, self.calls = at, 0

        def __call__(self):
            self.calls += 1
            if self.calls == self.at:
                raise RuntimeError("killed mid-scan")

    def spec_of(task, **kw):
        return CoresetSpec(task=task, budgets=m, params={} if task == "vrlr" else vk_params,
                           **kw)

    # -- (a) checkpointed resume: pipelined at block 16,384 (4 superchunks of 8),
    #    prefetch on, crashed inside the first pass, inside the mass pass and
    #    after the mass pass's last superchunk, each rerun with its checkpoint
    log(f"resume: block_size {PIPE_BLOCK} ({nb} blocks, {nch} superchunks of {C}), prefetch "
        f"on, m={m}; a probe raises at its k-th call, the rerun takes the checkpoint")
    t_stage = time.perf_counter()
    full = {}
    for task in ("vrlr", "vkmc"):
        _, s = ds_host.stacked_widths(task == "vrlr")
        spec = spec_of(task, engine="pipelined", block_size=PIPE_BLOCK, chunk_blocks=C,
                       prefetch=True)
        pipe = CoresetPipeline(ds_host)
        led0 = CommLedger()
        pred0 = pipe.plan(spec, dev).predicted_peak_bytes
        out0, s0, counts0, peak0, h2d0 = run(lambda: pipe.build_failover(
            spec, key=keys[task], ledger=led0, memory_budget_bytes=pred0))
        if out0.attempts:
            fail(f"resume {task}: the build under its own prediction {pred0} failed over: "
                 f"{out0.attempts}")
        cs0 = out0.coreset
        full[task] = (cs0, counts0, peak0)
        off = 1 if task == "vkmc" else 0         # vkmc probes once after its centers
        first = "gram" if task == "vrlr" else "stats"
        for where, at in ((f"inside the {first} pass", off + 2),
                          ("inside the mass pass", off + nch + 2),
                          ("at the mass pass's last superchunk", off + 2 * nch)):
            ck = StreamCheckpoint()

            def crash():
                try:
                    pipe.build(spec, key=keys[task], checkpoint=ck, probe=Bomb(at))
                except RuntimeError as e:
                    if "killed mid-scan" not in str(e):
                        raise
                else:
                    fail(f"resume {task}: the probe at call {at} did not stop the build")

            _, crash_s, _, _, _ = run(crash)
            done_first, done_mass = min(at - off, nch), max(0, at - off - nch)
            led = CommLedger()
            cs, rerun_s, counts, _, h2d = run(lambda: pipe.build(
                spec, key=keys[task], ledger=led, checkpoint=ck))
            if not same(cs, cs0) or led.messages != led0.messages:
                fail(f"resume {task} ({where}): the rerun differs from the uninterrupted "
                     f"build")
            if ck.resumes <= 0 or ck.signature is not None:
                fail(f"resume {task} ({where}): resumes {ck.resumes}, signature "
                     f"{ck.signature!r} after the rerun")
            skipped = chunk_bytes(s, done_first) + chunk_bytes(s, done_mass)
            if h2d != h2d0 - skipped:
                fail(f"resume {task} ({where}): h2d_bytes {h2d}, the full build's {h2d0} "
                     f"less {skipped} skipped")
            want = dict(counts0)
            if task == "vrlr":
                want["weighted_gram"] -= done_first
                want["leverage"] -= done_mass
            else:
                want["kmeans_assign_update"] -= done_first
                want["kmeans_assign"] -= done_mass
            if counts != want:
                fail(f"resume {task} ({where}): rerun launches {counts}, counted {want}")
            log(f"resume {task} m={m} crashed {where} (probe call {at}; {done_first} + "
                f"{done_mass} superchunks saved): crash build_s={crash_s:.4f}, rerun "
                f"build_s={rerun_s:.4f}, uninterrupted build_s={s0:.4f}; the rerun == the "
                f"uninterrupted build bit for bit (indices, weights, bill, ledger; "
                f"indices_sha256={digest(cs.indices)}), resumes {ck.resumes}, signature "
                f"cleared, h2d_bytes {h2d} = {h2d0} - {skipped}, launches {counts}; {card}")
    stage_s = {"resume (a)": time.perf_counter() - t_stage}

    # -- (b) the memory model against each engine's own measured peak: the
    #    materialized engine at phase 4's shape (the card dataset), streamed at
    #    blocks 65,536 and 16,384, pipelined at 65,536 (one superchunk of 8) and
    #    16,384 (prefetch on: (a)'s build; off) from the host copy
    t_stage = time.perf_counter()
    cases = [("materialized", ds, mm, dict(engine="materialized")) for mm in BUDGETS]
    cases += [(label, ds_host, m, kw) for label, kw in (
        (f"streamed {BLOCK_SIZE}", dict(engine="streamed", block_size=BLOCK_SIZE)),
        (f"streamed {PIPE_BLOCK}", dict(engine="streamed", block_size=PIPE_BLOCK)),
        (f"pipelined {BLOCK_SIZE}", dict(engine="pipelined", block_size=BLOCK_SIZE,
                                         chunk_blocks=C, prefetch=True)),
        (f"pipelined {PIPE_BLOCK} off", dict(engine="pipelined", block_size=PIPE_BLOCK,
                                             chunk_blocks=C, prefetch=False)))]
    rows, low, peaks, builds = [], [], {}, {}
    for task in ("vrlr", "vkmc"):
        for label, data, mb, kw in cases + [(f"pipelined {PIPE_BLOCK} on", ds_host, m, None)]:
            if kw is None:                                 # (a)'s uninterrupted build
                spec = spec_of(task, engine="pipelined", block_size=PIPE_BLOCK,
                               chunk_blocks=C, prefetch=True)
                pred = CoresetPipeline(data).plan(spec, dev).predicted_peak_bytes
                cs, secs, counts, peak = full[task][0], None, full[task][1], full[task][2]
            else:
                params = {} if task == "vrlr" else dict(vk_params)
                if label == "materialized":
                    params.pop("center_sample", None)         # k-means on every row
                spec = CoresetSpec(task=task, budgets=mb, params=params, **kw)
                pred = CoresetPipeline(data).plan(spec, dev).predicted_peak_bytes
                led = CommLedger()
                out, secs, counts, peak, _ = run(
                    lambda: CoresetPipeline(data).build_failover(
                        spec, key=keys[task], ledger=led, memory_budget_bytes=pred),
                    data)
                if out.attempts:
                    fail(f"memory model: {task} {label} under its own prediction {pred} "
                         f"failed over: {out.attempts}")
                cs = out.coreset
                builds[(task, label)] = (cs, led)
            name = f"{label}" + (f" m={mb}" if label == "materialized" else "")
            peaks[(task, label)] = peak
            rows.append(f"{task} {name}: predicted {pred} measured {peak} "
                        f"ratio {pred / peak:.3f}"
                        + ("" if secs is None else f" build_s={secs:.4f}"))
            if pred < peak:
                low.append(rows[-1])
    log("memory model (the plan's predicted_peak_bytes against the build's own peak "
        "device memory, bytes; each build ran through build_failover under a "
        f"memory_budget_bytes of its prediction, with no attempt; {card}):")
    for r in rows:
        log("  " + r)
    if low:
        fail("memory model: predictions below the measured peak: " + "; ".join(low))
    stage_s["model (b)"] = time.perf_counter() - t_stage

    # -- (c) auto plans: budgets between the model's values select each engine
    #    in turn; the host-dataset rule; the codec under a bit budget, realised
    #    bits within the prediction; a repeated plan is a cache hit
    t_stage = time.perf_counter()
    base = dict(task="vrlr", budgets=m, block_size=PIPE_BLOCK, chunk_blocks=C)
    pipe = CoresetPipeline(ds)
    mm = pipe.plan(CoresetSpec(**base), dev).memory_model
    if not mm["streamed"] < mm["pipelined"] < mm["materialized"]:
        fail(f"auto plan: the model does not order the engines: {mm}")
    chosen = {}
    for B, want in ((mm["materialized"], "materialized"),
                    (mm["materialized"] - 1, "pipelined"),
                    (mm["pipelined"], "pipelined"),
                    (mm["pipelined"] - 1, "streamed"),
                    (mm["streamed"] - 1, "streamed")):
        ep = pipe.plan(CoresetSpec(memory_budget_bytes=B, **base), dev)
        if ep.engine != want or ep.budget_exceeded != (B < mm["streamed"]):
            fail(f"auto plan at memory_budget_bytes={B}: {ep.engine} "
                 f"(exceeded {ep.budget_exceeded}), want {want}")
        chosen.setdefault(want, ep)
    auto = {e: run(lambda: pipe.build(chosen[e], key=keys["vrlr"]), ds)
            for e in ("pipelined", "streamed")}
    if not same(auto["pipelined"][0], auto["streamed"][0]):
        fail("auto plan: the pipelined and streamed auto builds differ")
    host_plan = CoresetPipeline(ds_host).plan(CoresetSpec(**base), dev)
    host_tight = CoresetPipeline(ds_host).plan(
        CoresetSpec(memory_budget_bytes=mm["pipelined"] - 1, **base), dev)
    if (host_plan.engine, host_tight.engine) != ("pipelined", "streamed") or \
            host_plan.fallback_chain != ("streamed",):
        fail(f"auto plan, host dataset: {host_plan.engine} / {host_tight.engine}, chain "
             f"{host_plan.fallback_chain}")
    log(f"auto plan (vrlr m={m}, block_size {PIPE_BLOCK}, C={C}): model materialized "
        f"{mm['materialized']} pipelined {mm['pipelined']} streamed {mm['streamed']} bytes; "
        f"budgets at and one byte below each select materialized, pipelined, streamed, "
        f"streamed (flagged); the pipelined and streamed auto builds equal bit for bit "
        f"(build_s {auto['pipelined'][1]:.4f} / {auto['streamed'][1]:.4f}); the host "
        f"dataset plans pipelined with no budget and streamed under one "
        f"({'; '.join(host_plan.notes)})")
    mat = dict(task="vrlr", budgets=m, engine="materialized")
    for target in ("fp16", "int8_blockscale"):
        bits = predict_dis_bits(T, m, n, target)
        ep = pipe.plan(CoresetSpec(codec="auto", comm_budget_bits=bits, **mat), dev)
        # the reference's walk: the first codec of the ladder whose bits fit
        want = next(c for c in CODEC_LADDER if predict_dis_bits(T, m, n, c) <= bits)
        if (ep.codec, ep.predicted_wire_bits, ep.comm_budget_exceeded) != (want, bits, False):
            fail(f"codec auto under {bits} bits: {ep.codec} {ep.predicted_wire_bits}, "
                 f"want {want}")
        led = CommLedger()
        cs, secs, _, _, _ = run(lambda: pipe.build(
            ep, key=keys["vrlr"], ledger=led, transport=Transport(FaultPlan.none())), ds)
        if not cs.comm_bits <= ep.predicted_wire_bits or cs.comm_bits != led.total_bits:
            fail(f"codec {ep.codec}: realised {cs.comm_bits} bits, predicted "
                 f"{ep.predicted_wire_bits}")
        log(f"codec auto (materialized vrlr m={m}) under comm_budget_bits={bits} (raw_fp32 "
            f"predicts {predict_dis_bits(T, m, n, 'raw_fp32')}): {ep.codec}, as the "
            f"reference's ladder walk; transported build realised {cs.comm_bits} <= "
            f"{ep.predicted_wire_bits} predicted bits, build_s={secs:.4f}")
    cache = PlanCache()
    cached = CoresetPipeline(ds_host, plan_cache=cache)
    p1 = cached.plan(spec_of("vrlr", block_size=PIPE_BLOCK), dev)
    p2 = cached.plan(spec_of("vrlr", block_size=PIPE_BLOCK), dev)
    p3 = cached.plan(spec_of("vrlr", block_size=PIPE_BLOCK), "cpu")
    if p2 is not p1 or (cache.hits, cache.misses) != (1, 2) or p3.device.type != "cpu":
        fail(f"plan cache: hits {cache.hits} misses {cache.misses}")
    log(f"plan cache: the second plan of the same spec is a hit, a CPU plan of it a miss "
        f"({cache.stats()})")
    stage_s["auto plan (c)"] = time.perf_counter() - t_stage

    # -- (d) failover: a pipelined spec at block 16,384 under a memory budget
    #    from the model alone, its streamed prediction at 16,384 (the build's
    #    own bytes, as the watchdog counts them), falls back to streamed
    t_stage = time.perf_counter()
    for task in ("vrlr", "vkmc"):
        spec = spec_of(task, engine="pipelined", block_size=PIPE_BLOCK, chunk_blocks=C,
                       prefetch=True)
        streamed_peak = peaks[(task, f"streamed {PIPE_BLOCK}")]
        pipelined_peak = peaks[(task, f"pipelined {PIPE_BLOCK} on")]
        budget = CoresetPipeline(ds_host).plan(spec, dev).memory_model["streamed"]
        if not streamed_peak <= budget < pipelined_peak:
            fail(f"failover {task}: the streamed prediction {budget} is not between the "
                 f"streamed and pipelined peaks")
        ref, ref_led = builds[(task, f"streamed {PIPE_BLOCK}")]
        led = CommLedger()
        out, secs, counts, _, _ = run(lambda: CoresetPipeline(ds_host).build_failover(
            spec, key=keys[task], ledger=led, memory_budget_bytes=budget))
        fb = {t: u for t, u in led.by_tag().items() if t.startswith("fallback/")}
        rest = {t: u for t, u in led.by_tag().items() if not t.startswith("fallback/")}
        if out.fallback != "pipelined->streamed" or \
                "MemoryBudgetExceeded" not in out.attempts[0].error:
            fail(f"failover {task}: {out.fallback}, attempts {out.attempts}")
        if not same(out.coreset, ref) or rest != ref_led.by_tag() or \
                fb != {"fallback/pipelined->streamed": 0} or led.total != ref_led.total:
            fail(f"failover {task}: the build or its ledger differs from the forced "
                 f"streamed build's (fallback entries {fb})")
        log(f"failover {task} m={m}: memory_budget_bytes = {budget}, the model's streamed "
            f"prediction (measured own peaks: streamed {streamed_peak}, pipelined "
            f"{pipelined_peak}): "
            f"{out.fallback} ({out.attempts[0].error}); == the forced streamed build bit for "
            f"bit, ledger its bill {ref_led.total} + fallback/pipelined->streamed 0; "
            f"build_s={secs:.4f}, launches {counts}; {card}")
    stage_s["failover (d)"] = time.perf_counter() - t_stage
    log(f"phase 12 took {time.perf_counter() - phase_t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_s.items()) + f"); {card}")


def tree_phase(torch, dev, seed, ds_host, ds, lam, launches, card, reset_counts,
               read_counts):
    """Phase 13, the merge-and-reduce serving tree on the card: phase 4's
    host copy ``ds_host`` inserted in superchunks of TREE_CHUNK rows into a
    ``CoresetTree`` per task (leaves pipelined at block PIPE_BLOCK, prefetch
    on; merges over 2 x node_budget-row unions on the card).  (a) every leaf
    bit for bit the direct pipelined build at ``leaf_key(i)``; (b) the
    insert census; (c) the composed ledger; (d) query determinism and a
    replayed tree; (e) the reduced query fit and evaluated at full n against
    the flat build; (f) leaf failover under a budget from the memory model
    alone, with and without 1 GiB resident.  ``ds`` is the same data on the
    card (for the fits); adds its counted runs to ``launches``.

    Returns the trees' keys and, per task, (a)'s tree after each insert:
    the digest of its levels and of ``query(reduce_to=TREE_BUDGET)`` at that
    point (taken after the counted run on a copy of the tree with its
    levels of the time and a ledger of its own), for phase 14's tenants."""
    import copy

    import numpy as np

    from repro_torch import rng
    from repro_torch.core import (
        DEFAULT_CHUNK_BLOCKS, CommLedger, CommSchedule, PlanCache, VFLDataset,
        build_coreset, build_coreset_streaming, evaluate, fit_kmeans, fit_ridge,
        full_data_coreset, memory_model)
    from repro_torch.serve import CoresetTree

    T, n = T_PARTIES, N_FULL
    phase_t0 = time.perf_counter()
    m, nb = TREE_BUDGET, TREE_HEADROOM * TREE_BUDGET
    bounds = [(a, min(a + TREE_CHUNK, n)) for a in range(0, n, TREE_CHUNK)]
    host_parts = [p.numpy() for p in ds_host.parts]
    host_y = ds_host.y.numpy()
    params = {"vrlr": {}, "vkmc": {"k": K_CLUSTERS, "alpha": ALPHA,
                                   "local_iters": LOCAL_ITERS}}
    keys = {task: rng.PRNGKey(seed + 700 + (task == "vkmc")) for task in ("vrlr", "vkmc")}
    # the binary counter's carry chain: insert i merges once per trailing one of i
    want_merges = [((i + 1) & -(i + 1)).bit_length() - 1 for i in range(len(bounds))]

    class RecordingTree(CoresetTree):
        """A CoresetTree that keeps the leaves its level-0 merges consume and
        the host time of every merge (each ends in host copies)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.leaves, self.merge_s = [], []

        def _merge(self, left, right):
            if left.level == 0:
                self.leaves += [left.cs, right.cs]
            t0 = time.perf_counter()
            out = super()._merge(left, right)
            self.merge_s.append(time.perf_counter() - t0)
            return out

    def chunk(i, labels):
        a, b = bounds[i]
        return [p[a:b] for p in host_parts], (host_y[a:b] if labels else None)

    def counted(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        for nm in launches:
            launches[nm] += counts[nm]
        return out, secs, counts

    def grow(task, tree, snaps=None):
        stats = []
        for i in range(len(bounds)):
            stats.append(tree.insert(*chunk(i, task == "vrlr")))
            if snaps is not None:
                snaps.append(list(tree.levels))
        return stats

    def trail_of(tree, snaps):
        """(levels digest, query digest) after each insert: the query of a
        copy of the tree holding the levels and insert count of the time."""
        out = []
        for i, levels in enumerate(snaps):
            view = copy.copy(tree)
            view.levels, view.num_chunks, view.ledger = levels, i + 1, CommLedger()
            out.append((levels_digest(view), mat_digest(view.query(reduce_to=m))))
        return out

    def same_mat(a, b):
        return (np.array_equal(a.indices, b.indices) and np.array_equal(a.weights, b.weights)
                and all(np.array_equal(p, q) for p, q in zip(a.parts, b.parts))
                and (a.y is None) == (b.y is None)
                and (a.y is None or np.array_equal(a.y, b.y))
                and (a.comm_units, a.comm_bits) == (b.comm_units, b.comm_bits))

    def same_levels(t1, t2):
        return len(t1.levels) == len(t2.levels) and all(
            (x is None and y is None) or (x is not None and y is not None
                                          and same_mat(x.cs, y.cs))
            for x, y in zip(t1.levels, t2.levels))

    def tree_of(task, cls=CoresetTree, **kw):
        return cls(task, m, key=keys[task], block_size=PIPE_BLOCK, prefetch=True,
                   params=params[task], plan_cache=PlanCache(), **kw)

    log(f"tree: phase 4's host copy in {len(bounds)} superchunks of {TREE_CHUNK} rows "
        f"(the last {bounds[-1][1] - bounds[-1][0]}), budget {m}, headroom "
        f"{TREE_HEADROOM} (nodes keep {nb}), leaves pipelined at block {PIPE_BLOCK}, "
        f"prefetch on; {card}")
    stage_s = {}
    trees, bills, trail = {}, {}, {}
    for task in ("vrlr", "vkmc"):
        t_stage = time.perf_counter()
        tree = tree_of(task, RecordingTree)
        snaps = []
        stats, grow_s, counts = counted(lambda: grow(task, tree, snaps))
        need = (("weighted_gram", "leverage", "categorical") if task == "vrlr"
                else ("kmeans_assign_update", "kmeans_assign", "categorical"))
        if any(counts[nm] == 0 for nm in need):
            fail(f"tree {task}: a kernel of the path was not launched: {counts}")
        messages = list(tree.ledger.messages)
        bills[task] = (messages, tree.ledger.total, tree.ledger.total_bits)
        trees[task] = tree
        # (b) the census: the carry chain, never a full-data rescore
        got = [s.merges for s in stats]
        if got != want_merges or tree.height != 4 or tree.n_total != n or \
                tree.num_chunks != len(bounds):
            fail(f"tree {task}: merges {got} (want {want_merges}), height {tree.height}, "
                 f"rows {tree.n_total}")
        for i, s in enumerate(stats):
            rows = bounds[i][1] - bounds[i][0]
            if s.chunk_rows != rows or s.leaf_builds != 1 or \
                    s.rescored_rows != rows + 2 * nb * s.merges or \
                    (i > 0 and s.rescored_rows >= bounds[i][1]):
                fail(f"tree {task}: insert {i} census {s}")
        # (c) the ledger: 8 leaf DIS bills + 7 x (merge + the union's DIS)
        leaf_bill = CommSchedule.dis_total(T, nb)
        merge_bill = CommSchedule.merge(T, nb, nb).total + leaf_bill
        want_total = len(bounds) * leaf_bill + sum(want_merges) * merge_bill
        if tree.ledger.total != want_total or sum(s.comm_delta for s in stats) != want_total:
            fail(f"tree {task}: ledger {tree.ledger.total}, want {want_total}")
        if tree.query().comm_units != tree.ledger.total:
            fail(f"tree {task}: the root's composed comm_units differs from the ledger")
        # (a) every leaf bit for bit the direct pipelined build at leaf_key(i)
        if len(tree.leaves) != len(bounds):
            fail(f"tree {task}: {len(tree.leaves)} leaves recorded")
        leaf_s = []
        for i, leaf in enumerate(tree.leaves):
            parts, y = chunk(i, task == "vrlr")
            cds = VFLDataset([torch.from_numpy(p) for p in parts],
                             None if y is None else torch.from_numpy(y))
            led = CommLedger()
            direct, secs, _ = counted(lambda: build_coreset_streaming(
                task, cds, nb, key=tree.leaf_key(i), block_size=PIPE_BLOCK, prefetch=True,
                ledger=led, **params[task]))
            leaf_s.append(secs)
            idx = direct.indices.cpu().numpy().astype(np.int64) + bounds[i][0]
            if not (np.array_equal(idx, leaf.indices)
                    and np.array_equal(direct.weights.cpu().numpy(), leaf.weights)
                    and (direct.comm_units, direct.comm_bits) == (leaf.comm_units,
                                                                  leaf.comm_bits)
                    and led.total == leaf.comm_units):
                fail(f"tree {task}: leaf {i} differs from the direct pipelined build")
        lat = sorted(s.latency_s for s in stats)
        merge_s = sorted(tree.merge_s)
        log(f"tree {task}: {len(bounds)} inserts in {grow_s:.4f} s, merges per insert {got}, "
            f"height {tree.height}, rescored rows {[s.rescored_rows for s in stats]} (never "
            f"n_total); ledger {tree.ledger.total} = {len(bounds)} x {leaf_bill} + "
            f"{sum(want_merges)} x {merge_bill} ({tree.ledger.total_bits} bits); every leaf "
            f"== the direct pipelined build at leaf_key(i) bit for bit (indices + offset, "
            f"weights, bill); leaf build_s median {leaf_s[len(leaf_s) // 2]:.4f} max "
            f"{max(leaf_s):.4f} (direct builds), merge median {merge_s[len(merge_s) // 2]:.4f} "
            f"max {merge_s[-1]:.4f} s, insert latency_s median {lat[len(lat) // 2]:.4f} max "
            f"{lat[-1]:.4f}; plan cache {tree.plan_cache.stats()['hits']} hits "
            f"{tree.plan_cache.stats()['misses']} misses; launches {counts}; {card}")
        if (tree.plan_cache.hits, tree.plan_cache.misses) != (len(bounds) - 2, 2):
            fail(f"tree {task}: plan cache {tree.plan_cache.stats()}")
        trail[task] = trail_of(tree, snaps)
        # (d) two queries between inserts give the same bits
        (q1, q2), q_s, _ = counted(lambda: (tree.query(reduce_to=m), tree.query(reduce_to=m)))
        if not same_mat(q1, q2) or q1.m != m:
            fail(f"tree {task}: two queries of an unchanged tree differ")
        # (e) the reduced query fit on the card, evaluated at full n against the
        #     flat equal-budget build
        def quality():
            flat = build_coreset(task, ds, m, key=rng.PRNGKey(seed + 760))
            if task == "vrlr":
                base = fit_ridge(ds, full_data_coreset(ds), lam).params
                r_tree = evaluate(ds, fit_ridge(ds, q1.coreset(dev), lam),
                                  baseline=base).rel_error
                r_flat = evaluate(ds, fit_ridge(ds, flat, lam), baseline=base).rel_error
            else:
                kev = rng.PRNGKey(seed + 770)
                base = fit_kmeans(ds, full_data_coreset(ds), K_CLUSTERS, key=kev,
                                  restarts=3).params
                r_tree = evaluate(ds, fit_kmeans(ds, q1.coreset(dev), K_CLUSTERS,
                                                 key=rng.fold_in(kev, 1), restarts=3),
                                  baseline=base).rel_error
                r_flat = evaluate(ds, fit_kmeans(ds, flat, K_CLUSTERS,
                                                 key=rng.fold_in(kev, 2), restarts=3),
                                  baseline=base).rel_error
            return r_tree, r_flat

        (r_tree, r_flat), fit_s, _ = counted(quality)
        if not (math.isfinite(r_tree) and r_tree < 0.25
                and r_tree <= max(8.0 * max(r_flat, 0.0), 0.05)):
            fail(f"tree {task}: query rel_error {r_tree} (flat {r_flat}) outside the "
                 f"reference test's bounds")
        ratio = r_tree / r_flat if r_flat > 0 else float("inf")
        log(f"tree {task}: query(reduce_to={m}) twice, the same bits "
            f"(indices_sha256={digest(torch.from_numpy(q1.indices))}, {q_s:.4f} s for "
            f"both); rel_error {r_tree:.6g} against the flat build's {r_flat:.6g} (ratio "
            f"{ratio:.3f}; benchmarks/serve.py gates the seed average at 2x; held here to "
            f"< 0.25 and <= max(8 x flat, 0.05)); fits and evaluation {fit_s:.4f} s; {card}")
        stage_s[task] = time.perf_counter() - t_stage

    # (d) a second vrlr tree with the same key replays the first bit for bit
    t_stage = time.perf_counter()
    replay = tree_of("vrlr")
    _, replay_s, _ = counted(lambda: grow("vrlr", replay))
    if not same_levels(replay, trees["vrlr"]) or replay.ledger.messages != bills["vrlr"][0]:
        fail("tree vrlr: a second tree with the same key does not replay the first")
    log(f"tree vrlr: a second tree with the same key replays the first bit for bit "
        f"(nodes, ledger) in {replay_s:.4f} s")
    stage_s["replay"] = time.perf_counter() - t_stage

    # (f) leaf failover under a budget from the memory model alone: the
    #     streamed prediction for one full leaf; again with 1 GiB resident
    t_stage = time.perf_counter()
    _, s = ds_host.stacked_widths(True)
    budget = memory_model(T, TREE_CHUNK, s, PIPE_BLOCK, DEFAULT_CHUNK_BLOCKS,
                          m_cap=nb)["streamed"]
    outcomes = []
    for resident in (0, 1 << 30):
        extra = torch.empty(resident, dtype=torch.uint8, device=dev) if resident else None
        tree = tree_of("vrlr", failover=True, memory_budget_bytes=budget)
        stats, secs, counts = counted(lambda: grow("vrlr", tree))
        fb = [st.fallback for st in stats]
        messages = tree.ledger.messages
        rest = [msg for msg in messages if not msg.tag.startswith("fallback/")]
        fbs = [msg for msg in messages if msg.tag.startswith("fallback/")]
        if fb[:-1] != ["pipelined->streamed"] * (len(bounds) - 1) or \
                tree.fallbacks != sum(f is not None for f in fb) or tree.fallbacks < 7:
            fail(f"failover tree ({resident} bytes resident): fallbacks {fb}")
        if not same_levels(tree, trees["vrlr"]) or rest != bills["vrlr"][0] or \
                len(fbs) != tree.fallbacks or any(msg.units for msg in fbs) or \
                tree.ledger.total != bills["vrlr"][1]:
            fail(f"failover tree ({resident} bytes resident): the nodes or the ledger "
                 f"differ from (a)'s tree")
        outcomes.append((fb, tree.fallbacks))
        log(f"failover tree vrlr, memory_budget_bytes={budget} (memory_model's streamed "
            f"prediction for one {TREE_CHUNK}-row leaf), {resident} bytes resident before "
            f"it: fallbacks {tree.fallbacks} {fb}; nodes == (a)'s tree bit for bit, ledger "
            f"its bill {bills['vrlr'][1]} + {len(fbs)} x fallback/ 0; {secs:.4f} s, "
            f"launches {counts}; {card}")
        del extra
    if outcomes[0] != outcomes[1]:
        fail(f"failover tree: 1 GiB resident changed the outcome: {outcomes}")
    stage_s["failover (f)"] = time.perf_counter() - t_stage
    log(f"phase 13 took {time.perf_counter() - phase_t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_s.items()) + f"); {card}")
    return keys, trail


def service_phase(torch, dev, seed, ds_host, ds, launches, card, reset_counts, read_counts,
                  tree_keys, tree_trail):
    """Phase 14, the multi-tenant ``CoresetService`` on the card, at phase
    13's shapes (superchunks of TREE_CHUNK rows of phase 4's host copy,
    budget TREE_BUDGET, headroom TREE_HEADROOM, leaves pipelined at block
    PIPE_BLOCK with prefetch).  (a) three streaming tenants inserted round
    robin, a reduced query after each insert: ``v`` and ``k`` (phase 13's
    keys) bit for bit phase 13's trees after every insert (``tree_trail``),
    ``v2`` hitting ``v``'s plans, each ledger the sum of its receipts'
    deltas; (b) a hostile mix on a ticking ``SimClock``: a rate limit shed
    and recovered, a deadline breached mid-leaf leaving tree and ledger
    bit for bit, a tenant whose transport drops everything opening its
    breaker, a normal tenant bit for bit alone on a fresh service, a
    failover tenant bit for bit its unforced twin, every request a receipt
    or a party failure its breaker recorded; (c) a flush of six requests
    from two tenants on phase 4's card dataset ``ds``: two batched builds,
    K1 once for the ``vrlr`` group, the m = m_cap cells bit for bit their
    eager builds, the bills exact."""
    import numpy as np

    from repro_torch import rng
    from repro_torch.core import (
        DEFAULT_CHUNK_BLOCKS, CommSchedule, Deadline, FaultPlan, PartyUnavailable,
        SimClock, Transport, build_coreset, memory_model)
    from repro_torch.serve import CoresetService, InsertReceipt, QueryReceipt, ShedReceipt

    T, n = T_PARTIES, N_FULL
    phase_t0 = time.perf_counter()
    m = TREE_BUDGET
    bounds = [(a, min(a + TREE_CHUNK, n)) for a in range(0, n, TREE_CHUNK)]
    host_parts = [p.numpy() for p in ds_host.parts]
    host_y = ds_host.y.numpy()
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS}
    tree_kw = dict(budget=m, block_size=PIPE_BLOCK, prefetch=True, headroom=TREE_HEADROOM)

    def chunk(i, labels):
        a, b = bounds[i]
        return [p[a:b] for p in host_parts], (host_y[a:b] if labels else None)

    def counted(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        for nm in launches:
            launches[nm] += counts[nm]
        return out, secs, counts

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    stage_s = {}
    # (a) three streaming tenants, round robin, a reduced query after each insert
    t_stage = time.perf_counter()
    svc = CoresetService(device=dev)
    tasks = {"v": "vrlr", "k": "vkmc", "v2": "vrlr"}
    svc.register("v", task="vrlr", key=tree_keys["vrlr"], **tree_kw)
    svc.register("k", task="vkmc", key=tree_keys["vkmc"], **tree_kw, **vk_params)
    svc.register("v2", task="vrlr", seed=seed + 702, **tree_kw)
    recs = {name: [] for name in tasks}

    def stream():
        for i in range(len(bounds)):
            for name, task in tasks.items():
                ins = svc.insert(name, *chunk(i, task == "vrlr"))
                q = svc.query(name, reduce_to=m)
                if not (isinstance(ins, InsertReceipt) and isinstance(q, QueryReceipt)):
                    fail(f"service (a): tenant {name} insert {i} was shed: {ins} {q}")
                recs[name].append((ins, q, levels_digest(svc.state(name).tree),
                                   mat_digest(q.result)))

    _, stream_s, counts = counted(stream)
    if any(c == 0 for c in counts.values()):
        fail(f"service (a): a kernel of the path was not launched: {counts}")
    for name, task in (("v", "vrlr"), ("k", "vkmc")):
        got = [(lv, qd) for _, _, lv, qd in recs[name]]
        if got != tree_trail[task]:
            bad = [i for i, (a, b) in enumerate(zip(got, tree_trail[task])) if a != b]
            fail(f"service (a): tenant {name} differs from phase 13's {task} tree after "
                 f"inserts {bad}")
    for name in tasks:
        st = svc.state(name)
        delta = sum(ins.stats.comm_delta + q.comm_delta for ins, q, _, _ in recs[name])
        last = recs[name][-1][1]
        if not (st.ledger.total == delta == last.ledger_total
                and st.ledger.total_bits == last.ledger_bits):
            fail(f"service (a): tenant {name}: ledger {st.ledger.total}, receipts' deltas "
                 f"{delta}, last receipt {last.ledger_total}")
    hits = {name: [ins.plan_hit for ins, _, _, _ in recs[name]] for name in tasks}
    if not all(hits["v2"]) or hits["v"][0] or hits["k"][0]:
        fail(f"service (a): plan hits {hits}")
    log(f"service (a): tenants v (vrlr), k (vkmc) and v2 (vrlr, seed + 702) on {dev}, "
        f"{len(bounds)} superchunks each round robin, query(reduce_to={m}) after every "
        f"insert, {stream_s:.4f} s; v and k bit for bit phase 13's trees after every insert "
        f"(levels and queries); v2's leaves hit v's plans {hits['v2']}; each ledger the sum "
        f"of its receipts' deltas ({ {nm: svc.state(nm).ledger.total for nm in tasks} }); "
        f"plan cache {svc.plan_cache.stats()['hits']} hits "
        f"{svc.plan_cache.stats()['misses']} misses; launches {counts}; {card}")
    for task, names in (("vrlr", ("v", "v2")), ("vkmc", ("k",))):
        ins_l = [ins.latency_s for nm in names for ins, _, _, _ in recs[nm]]
        q_l = [q.latency_s for nm in names for _, q, _, _ in recs[nm]]
        first = [recs[nm][0][0].latency_s for nm in names]
        warm = [ins.latency_s for nm in names for ins, _, _, _ in recs[nm][1:-1]]
        log(f"service (a) {task}: insert latency_s p50 {pct(ins_l, 50):.4f} p99 "
            f"{pct(ins_l, 99):.4f}, query latency_s p50 {pct(q_l, 50):.4f} p99 "
            f"{pct(q_l, 99):.4f} ({len(ins_l)} each); first insert(s) "
            f"{[round(x, 4) for x in first]} against the full warm inserts' median "
            f"{pct(warm, 50):.4f} (no gate: the port compiles nothing); {card}")
    stage_s["tenants (a)"] = time.perf_counter() - t_stage
    del svc, recs

    # (b) the hostile mix on a SimClock that ticks a second every read, three
    #     full superchunks
    t_stage = time.perf_counter()
    clock = SimClock(tick=1.0)
    svc = CoresetService(device=dev, clock=clock)
    _, s_w = ds_host.stacked_widths(True)
    fo_budget = memory_model(T, TREE_CHUNK, s_w, PIPE_BLOCK, DEFAULT_CHUNK_BLOCKS,
                             m_cap=TREE_HEADROOM * m)["streamed"]
    svc.register("g", task="vrlr", seed=seed + 710, rate_limit=(0.01, 2), **tree_kw)
    svc.register("d", task="vrlr", seed=seed + 711, **tree_kw)
    svc.register("bad", task="vrlr", seed=seed + 712, fault_policy="retry",
                 transport=Transport(FaultPlan(seed=3, drop=1.0, max_retries=1),
                                     clock=clock),
                 breaker_threshold=2, breaker_cooldown_s=50.0, **tree_kw)
    svc.register("n", task="vrlr", seed=seed + 713, **tree_kw)
    svc.register("f", task="vrlr", seed=seed + 713, failover=True,
                 memory_budget_bytes=fo_budget, **tree_kw)
    issued, outcomes = 0, []

    def call(fn, *a, **kw):
        nonlocal issued
        issued += 1
        try:
            out = fn(*a, **kw)
        except PartyUnavailable as e:
            outcomes.append(("party_failure", str(e)))
            return None
        outcomes.append(out)
        return out

    def mix():
        for i in range(3):
            for name in ("n", "f", "bad"):
                call(svc.insert, name, *chunk(i, True))
        g = [call(svc.insert, "g", *chunk(i, True)) for i in range(3)]
        clock.advance(200.0)                      # the bucket refills
        g.append(call(svc.insert, "g", *chunk(2, True)))
        call(svc.insert, "d", *chunk(0, True))
        st = svc.state("d")
        before = (levels_digest(st.tree), list(st.ledger.messages), st.ledger.total,
                  st.ledger.total_bits, st.tree.num_chunks)
        # admission reads the clock twice (the deadline, the breaker), then the
        # leaf's first superchunk probe reads past the 2.5 s budget
        d = call(svc.insert, "d", *chunk(1, True), deadline=Deadline.after(clock, 2.5))
        after = (levels_digest(st.tree), list(st.ledger.messages), st.ledger.total,
                 st.ledger.total_bits, st.tree.num_chunks)
        qs = {name: call(svc.query, name, reduce_to=m) for name in ("n", "f")}
        return g, d, before, after, qs

    (g, d, before, after, qs), mix_s, counts = counted(mix)
    shed_g = [isinstance(r, ShedReceipt) and r.reason for r in g]
    if shed_g != [False, False, "rate_limit", False]:
        fail(f"service (b): the rate-limited tenant's inserts: {g}")
    if not (isinstance(d, ShedReceipt) and d.reason == "deadline") or before != after:
        fail(f"service (b): the deadlined insert gave {d}; tree and ledger unchanged: "
             f"{before == after}")
    bad_out = [o for o in outcomes if isinstance(o, tuple)]
    br = svc.stats()["breakers"]["bad"]
    shed_bad = [o for o in outcomes if isinstance(o, ShedReceipt) and o.tenant == "bad"]
    if len(bad_out) != 2 or br["state"] != "open" or br["trips"] != 1 or \
            [o.reason for o in shed_bad] != ["breaker_open"]:
        fail(f"service (b): the dropping tenant: failures {bad_out}, breaker {br}, sheds "
             f"{shed_bad}")
    fb = [o.fallback for o in outcomes if isinstance(o, InsertReceipt) and o.tenant == "f"]
    if fb != ["pipelined->streamed"] * 3:
        fail(f"service (b): the failover tenant's receipts: {fb}")
    receipts = [o for o in outcomes if not isinstance(o, tuple)]
    if issued != len(receipts) + len(bad_out) or br["failures"] != len(bad_out):
        fail(f"service (b): {issued} requests, {len(receipts)} receipts, {len(bad_out)} "
             f"party failures")
    # the normal tenant alone on a fresh service, and its failover twin
    alone = CoresetService(device=dev)
    alone.register("n", task="vrlr", seed=seed + 713, **tree_kw)
    for i in range(3):
        alone.insert("n", *chunk(i, True))
    q_alone = alone.query("n", reduce_to=m)
    dg = {name: mat_digest(q.result) for name, q in qs.items()}
    if not (dg["n"] == dg["f"] == mat_digest(q_alone.result)
            and levels_digest(alone.state("n").tree) == levels_digest(svc.state("n").tree)
            == levels_digest(svc.state("f").tree)
            and alone.state("n").ledger.total == svc.state("n").ledger.total
            == svc.state("f").ledger.total):
        fail(f"service (b): the normal tenant, alone and its failover twin differ: {dg}, "
             f"{mat_digest(q_alone.result)}")
    reasons = sorted({o.reason for o in receipts if isinstance(o, ShedReceipt)})
    log(f"service (b): hostile mix on a SimClock ticking 1 s a read, {issued} requests in "
        f"{mix_s:.4f} s: {len(receipts)} receipts ({sum(isinstance(o, ShedReceipt) for o in receipts)} "
        f"shed: {reasons}) + {len(bad_out)} party failures recorded by the breaker (state "
        f"{br['state']}, {br['trips']} trip); rate limit shed then recovered after 200 s; "
        f"the deadline breached mid-leaf left tree and ledger bit for bit; the failover "
        f"tenant's receipts {fb}, memory_budget_bytes={fo_budget}; tenants n, f and n alone "
        f"on a fresh service query the same bits ({dg['n']}); launches {counts}; {card}")
    stage_s["hostile mix (b)"] = time.perf_counter() - t_stage
    del svc, alone

    # (c) the batched flush on phase 4's card dataset
    t_stage = time.perf_counter()
    svc = CoresetService(device=dev)
    for name, off in (("a", 720), ("b", 721)):
        svc.register(name, task="vrlr", seed=seed + off, **tree_kw)
    svc.attach_dataset("main", ds)
    try:
        svc.attach_dataset("host", ds_host)
    except ValueError as e:
        refused = str(e)
    else:
        fail("service (c): a host dataset was attached to a service on the card")
    reqs = [("a", "vrlr", BUDGETS[0]), ("a", "vrlr", BUDGETS[1]), ("b", "vrlr", BUDGETS[0]),
            ("b", "vrlr", BUDGETS[1]), ("a", "vkmc", BUDGETS[0]), ("b", "vkmc", BUDGETS[0])]
    keys = [rng.fold_in(rng.PRNGKey(seed + 730), i) for i in range(len(reqs))]
    tickets = [svc.submit(t, "main", mb, key=k, task=task,
                          **(vk_params if task == "vkmc" else {}))
               for (t, task, mb), k in zip(reqs, keys)]
    out, flush_s, counts = counted(svc.flush)
    want = {"leverage": 1, "weighted_gram": 0, "kmeans_assign": 0,
            "kmeans_assign_update": 2 * (LOCAL_ITERS + 1),
            "categorical": 4 * len(BUDGETS) * 2 + 2 * (T * K_CLUSTERS + 2)}
    if (svc.batched_flushes, svc.batched_cells) != (2, len(reqs)) or counts != want:
        fail(f"service (c): {svc.batched_flushes} batched builds of {svc.batched_cells} "
             f"cells, launches {counts}; counted {want} from the code")
    solo_s = 0.0
    for (t, task, mb), k, tk in zip(reqs, keys, tickets):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = build_coreset(task, ds, mb, key=k, **(vk_params if task == "vkmc" else {}))
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t0
        cell = out[tk]
        cap = BUDGETS[-1] if task == "vrlr" else BUDGETS[0]
        if cell.comm_units != CommSchedule.dis_total(T, mb) or cell.indices.shape != (mb,):
            fail(f"service (c): ticket {tk} billed {cell.comm_units} for m={mb}")
        if mb == cap and not (torch.equal(cell.indices, solo.indices)
                              and torch.equal(cell.weights, solo.weights)):
            fail(f"service (c): the {task} m={mb} cell of ticket {tk} differs from its "
                 f"eager build")
    for name in ("a", "b"):
        want_units = sum(CommSchedule.dis_total(T, mb) for t, _, mb in reqs if t == name)
        if svc.state(name).ledger.total != want_units:
            fail(f"service (c): tenant {name} billed {svc.state(name).ledger.total}, "
                 f"want {want_units}")
    log(f"service (c): flush of {len(reqs)} requests from two tenants on phase 4's card "
        f"dataset (vrlr at m in {BUDGETS}, vkmc at m={BUDGETS[0]}, k={K_CLUSTERS}): "
        f"{svc.batched_flushes} batched builds, flush_s={flush_s:.4f} against "
        f"{solo_s:.4f} s for the same requests built one by one; launches {counts} (K1 "
        f"once for the vrlr group); the m = m_cap cells bit for bit their eager builds, "
        f"every cell billed dis_total, each tenant's ledger exact; a host dataset refused "
        f"at attach: {refused!r}; {card}")
    stage_s["flush (c)"] = time.perf_counter() - t_stage
    log(f"phase 14 took {time.perf_counter() - phase_t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in stage_s.items()) + f"); {card}")


def synthetic_phase(torch, dev, seed, launches, card, reset_counts, read_counts):
    """Phase 15, the synthetic datasets on the card: ``rng.normal``'s words
    on the card bit for bit the CPU's, ``year_prediction_like`` and
    ``correlated_vfl_data`` at the reference's ``--fast`` n against the
    port's CPU ones; then ``benchmarks/common.py``'s recipe at the paper's
    YearPredictionMSD n on the card, each build through ``end_to_end``."""
    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CommSchedule, CoresetSpec, VFLDataset, end_to_end, standardize)
    from repro_torch.data import correlated_vfl_data, year_prediction_like

    T = T_PARTIES
    phase_t0 = time.perf_counter()
    n_fast = SYNTH_FAST_N
    # the normal words of year_prediction_like's largest draw, card and CPU
    k3 = rng.split(rng.split(rng.PRNGKey(7), 3)[0], 4)[2]
    z_card = rng.normal(k3.to(dev), (n_fast, D_FULL)).cpu()
    z_cpu = rng.normal(k3, (n_fast, D_FULL))
    if not torch.equal(z_card.view(torch.int32), z_cpu.view(torch.int32)):
        fail("synthetic: rng.normal's words differ on the card and the CPU")
    X_c, y_c = year_prediction_like(rng.PRNGKey(7), n=n_fast, device=dev)
    X_h, y_h = year_prediction_like(rng.PRNGKey(7), n=n_fast, device="cpu")
    x_err = float((X_c.cpu() - X_h).abs().max())
    y_err = float(((y_c.cpu() - y_h).abs() / y_h.abs()).max())
    C_c = correlated_vfl_data(rng.PRNGKey(seed + 60), n_fast, SYNTH_CORR_D, T,
                              cross_correlation=0.6, k_clusters=K_CLUSTERS, device=dev)
    C_h = correlated_vfl_data(rng.PRNGKey(seed + 60), n_fast, SYNTH_CORR_D, T,
                              cross_correlation=0.6, k_clusters=K_CLUSTERS, device="cpu")
    c_err = float((C_c.cpu() - C_h).abs().max())
    if not (x_err <= SYNTH_X_ATOL and y_err <= SYNTH_Y_RTOL and c_err <= SYNTH_X_ATOL):
        fail(f"synthetic: card against CPU at n={n_fast}: X {x_err:.3e}, y {y_err:.3e} "
             f"(rtol), correlated {c_err:.3e}")
    log(f"synthetic: rng.normal's {n_fast * D_FULL} words of year_prediction_like's noise "
        f"bit for bit on the card and the CPU; at n={n_fast}: X max abs {x_err:.3e} (atol "
        f"{SYNTH_X_ATOL}), y max rel {y_err:.3e} (rtol {SYNTH_Y_RTOL}), correlated_vfl_data "
        f"(d={SYNTH_CORR_D}, k={K_CLUSTERS}) max abs {c_err:.3e}")
    del X_c, y_c, X_h, y_h, C_c, C_h, z_card, z_cpu

    def generate(key):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        X, y = year_prediction_like(key, n=SYNTH_FULL_N, device=dev)
        torch.cuda.synchronize()
        return X, y, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    # vrlr: PRNGKey(7), targets centred on the train split, a 10% test split
    X, y, gen_s, gen_peak = generate(rng.PRNGKey(7))
    n_test = SYNTH_FULL_N // 10
    y = y - y[:-n_test].mean()
    full = VFLDataset.from_dense(X, y, T=T)
    train = VFLDataset([p[:-n_test] for p in full.parts], full.y[:-n_test])
    X_test, y_test = X[-n_test:], y[-n_test:]
    del X, full
    log(f"synthetic: year_prediction_like(PRNGKey(7), n={SYNTH_FULL_N}) on the card in "
        f"{gen_s:.4f} s, its own peak {gen_peak} bytes (X is {SYNTH_FULL_N * D_FULL * 4}); "
        f"train {train.n} rows, test {n_test}; {card}")
    lam = 0.1 * train.n
    per_e2e = {"vrlr": {"leverage": 1, "weighted_gram": 2, "kmeans_assign": 0,
                        "kmeans_assign_update": 0, "categorical": 2},
               "vkmc": {"leverage": 0, "weighted_gram": 0, "kmeans_assign": 4,
                        "kmeans_assign_update": LOCAL_ITERS + 1 + 2 * FIT_ITERS,
                        "categorical": T * K_CLUSTERS + 2 + 2 * K_CLUSTERS}}

    def run(task, ds_, mb, key, **kw):
        led = CommLedger()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs, fit, rep = end_to_end(CoresetSpec(task=task, budgets=mb, params=kw.pop("params", {})),
                                  ds_, key=key, ledger=led, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        reset_counts()
        for nm in launches:
            launches[nm] += counts[nm]
        want = CommSchedule.dis_total(T, mb)
        if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
            fail(f"synthetic {task} m={mb}: rel_error {rep.rel_error}")
        if cs.comm_units != want or led.total != want + 2 * mb * T or counts != per_e2e[task]:
            fail(f"synthetic {task} m={mb}: bill {cs.comm_units} (dis_total {want}), ledger "
                 f"{led.total}, launches {counts} (want {per_e2e[task]})")
        return fit, rep, secs, counts

    for mb in BUDGETS:
        fit, rep, secs, counts = run("vrlr", train, mb, rng.fold_in(rng.PRNGKey(seed + 800), mb),
                                     lam=lam)
        test_mse = float(((X_test @ fit.params - y_test) ** 2).mean())
        log(f"synthetic vrlr m={mb}: end_to_end {secs:.4f} s, rel_error {rep.rel_error:.6g} "
            f"(gate {REL_ERROR_GATE}), test MSE {test_mse:.6g}, bill dis_total + 2mT, "
            f"launches {counts}; {card}")
    del train, X_test, y_test

    # vkmc: PRNGKey(11), standardize, k = 10
    X, _, gen_s, gen_peak = generate(rng.PRNGKey(11))
    ds_k = standardize(VFLDataset.from_dense(X, None, T=T))
    del X
    mb = BUDGETS[-1]
    fit, rep, secs, counts = run(
        "vkmc", ds_k, mb, rng.fold_in(rng.PRNGKey(seed + 900), mb), k=K_CLUSTERS,
        iters=FIT_ITERS,
        params={"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS})
    log(f"synthetic vkmc m={mb}: year_prediction_like(PRNGKey(11)) {gen_s:.4f} s (own peak "
        f"{gen_peak} bytes), standardized; end_to_end {secs:.4f} s, rel_error "
        f"{rep.rel_error:.6g}, bill dis_total + 2mT, launches {counts}; {card}")
    log(f"phase 15 took {time.perf_counter() - phase_t0:.1f} s; {card}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device; this check runs on the card only")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is not at {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    import repro_torch  # noqa: F401  (pins fp32 matmul precision)
    from repro_torch import rng
    from repro_torch.core import (
        CommLedger, CommSchedule, CoresetPipeline, CoresetSpec, VFLDataset,
        build_coreset, build_coreset_jit, build_coresets_batched, elastic_cost, end_to_end,
        evaluate, fit_kmeans, fit_ridge, full_data_coreset, kmeans_plusplus,
        lasso_cost, lloyd, ridge_cost, saga_ridge, solve, sq_loss)
    from repro_torch.core.api import vkmc_scores, vrlr_scores
    from repro_torch.core.dis import dis_plan_full
    from repro_torch.core.integrity import health_from_masses
    from repro_torch.core.sensitivity import (
        batched_gram_pinv, kmeans_update, total_sensitivity_bound_vkmc,
        vkmc_local_scores)
    from repro_torch.kernels import _build
    from repro_torch.kernels import categorical as kcat
    from repro_torch.kernels import kmeans_assign as kka
    from repro_torch.kernels import kmeans_assign_update as kkau
    from repro_torch.kernels import leverage as klev
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import weighted_gram as kwg

    from repro_torch.kernels.ops import COUNTED as counted

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail(f"the port pulled in {bad}")

    # ---- 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"precision={torch.get_float32_matmul_precision()}")
    dev = torch.device("cuda", 0)

    # ---- 2. build -----------------------------------------------------------
    build_s = _build.timed_build()
    log(f"build: {build_s:.2f}s -> {_build.build().name}")
    build_log = _build.build().with_suffix(".log")
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- data at the main path's scale (set-up) ------------------------------
    X_np, y_np = make_data(args.seed, N_FULL, D_FULL)
    ds = VFLDataset.from_dense(X_np, y_np, T=T_PARTIES)       # on the card
    lam = 0.1 * N_FULL
    torch.cuda.synchronize()
    log(f"data: n={ds.n} d={ds.d} T={ds.T} dims={ds.dims} on {ds.device}")

    # ---- 3. kernels against their plain versions ----------------------------
    log("kernels vs plain (fp32, TF32 off):")
    gen = torch.Generator(device="cpu").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def psd(batch, s):
        A = randn(*batch, s, s)
        return A @ A.transpose(-1, -2) / s

    lev_scale = lambda X, M: klev.plain(X, M).abs().max().item()
    gram_scale = lambda X, w: kwg.plain(X.abs(), w.abs()).max().item()

    blocks = ds.stacked(with_labels=True).blocks                  # (3, n, 31)
    M = batched_gram_pinv(blocks.transpose(1, 2) @ blocks)        # (3, 31, 31)
    lev_err = check_kernel(torch, "leverage", klev.leverage, klev.plain,
                           (blocks, M), lev_scale, LEVERAGE_TOL)
    # K1 against the wide kernel, bit for bit, at the main path's shape
    # (timed), over the sweep and at the edges below
    check_k1_oracle(torch, klev, blocks, M, timed=True)
    for n, s, xb, mb in [(1, 5, (), ()), (7, 1, (), ()), (129, 31, (3,), ()),
                         (1001, 64, (), (2,)), (4097, 33, (2,), (2,)),
                         (513, 238, (), ()),
                         # the wide kernel, past M whole in shared memory
                         (4097, 239, (), ()), (1001, 256, (2,), ()),
                         (777, 512, (), ())]:
        Xs, Ms = randn(*xb, n, s), psd(mb, s)
        check_kernel(torch, "leverage", klev.leverage, klev.plain, (Xs, Ms),
                     lev_scale, LEVERAGE_TOL)
        check_k1_oracle(torch, klev, Xs, Ms)
    # K1's edges: the register kernel at s = 1, 31, 30 and 28 (a warp's rows
    # starting in 32, 16 and 8 banks), s = 8, 16, 24, 32 and 33 (the
    # shared-memory kernel), a short last tile over many CTAs, parties whose
    # rows start off 16-byte alignment, an all-zero row and an all-zero M
    for n, s, xb, mb in [(1, 1, (), ()), (300, 8, (), ()), (1000, 16, (2,), ()),
                         (2049, 24, (), (2,)), (4097, 32, (3,), (3,)),
                         (300, 33, (), ()), (100_003, 31, (3,), (3,)),
                         (257, 31, (2,), ()), (1001, 30, (3,), ()),
                         (1001, 28, (), (3,))]:
        Xs, Ms = randn(*xb, n, s), psd(mb, s)
        Xs[..., n // 2, :] = 0.0
        check_k1_oracle(torch, klev, Xs, Ms)
    check_k1_oracle(torch, klev, randn(3, 1001, 31), torch.zeros(3, 31, 31, device=dev))
    Xw, Mw = randn(N_WIDE, 512), psd((), 512)
    levw_err = check_kernel(torch, "leverage", klev.leverage, klev.plain,
                            (Xw, Mw), lev_scale, LEVERAGE_TOL)

    X_full = ds.full()
    ones = torch.ones(N_FULL, device=dev)
    Xc = X_full[:5000].contiguous()
    wc = torch.rand(5000, generator=gen).to(dev) * 100.0
    def check_gram(X, w):
        err = check_kernel(torch, "weighted_gram", kwg.weighted_gram, kwg.plain,
                           (X, w), gram_scale, GRAM_TOL)
        G = kwg.weighted_gram(X, w)
        if not torch.equal(G, G.transpose(-1, -2)):
            fail(f"weighted_gram {tuple(X.shape)}: G is not exactly symmetric")
        return err

    gram_err = check_gram(X_full, ones)
    check_gram(Xc, wc)
    for n, d, xb, wb in [(1, 1, (), ()), (7, 1, (), ()), (255, 9, (), ()),
                         (1001, 90, (3,), ()), (3001, 17, (), (2,)),
                         (2049, 31, (3,), (3,)), (777, 200, (), ()),
                         (33, 90, (), ()), (5000, 13, (), ())]:
        check_gram(randn(*xb, n, d), torch.rand(*wb, n, generator=gen).to(dev))
    log("  weighted_gram: G exactly symmetric at every shape")

    # rng on the card gives the CPU's bits (the draws depend on nothing else)
    key = rng.PRNGKey(args.seed + 11)
    g_cpu = rng.gumbel(key, (257, 1001))
    g_gpu = rng.gumbel(key.to(dev), (257, 1001)).cpu()
    if not torch.equal(g_cpu.view(torch.int32), g_gpu.view(torch.int32)):
        fail("gumbel bits on the card differ from the CPU's")
    log("rng: gumbel (257, 1001) bitwise equal on card and CPU")
    # past 2**32 - 1 counters a draw is blocks of 2**32 - 1 words under split
    # subkeys: the words there, a full block's pad slot and the last block's
    # among them, are the same on the card and the CPU
    limit = 2 ** 32 - 1
    size = 3 * limit + 7
    pos = torch.tensor([2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32, 2 * limit + 5, size - 1,
                        2 ** 31 - 1, limit + 2 ** 31 - 1, 3 * limit + 3], dtype=torch.int64)
    if not torch.equal(rng._bits_at(key, pos, size),
                       rng._bits_at(key.to(dev), pos.to(dev), size).cpu()):
        fail("threefry words past 2**32 - 1 counters differ on the card and the CPU")
    log(f"rng: words at {pos.tolist()} of a {size}-word draw equal on card and CPU")
    # K5, the DIS draw: the kernel against its plain version, bit for bit,
    # over the sweep (both entry shapes) and at the main path's shapes
    def check_k5(keys, lg, cap, counts, label):
        """Both entry shapes against the plain version on the card (party
        j's one-stream draw against party j's rows of the plain draw); two
        launches bitwise equal."""
        a = torch.tensor(counts, dtype=torch.int64, device=dev)
        got = kops.categorical_parties(keys, lg, cap, a, total=sum(counts))
        again = kops.categorical_parties(keys, lg, cap, a, total=sum(counts))
        want = rng.categorical_parties_plain(keys, lg, cap, a)
        if not (torch.equal(got, again) and torch.equal(got, want)):
            fail(f"categorical {label}: the kernel's parties draw differs from the "
                 f"plain version's or from itself")
        for j, (c, w) in enumerate(zip(counts, torch.split(want, counts))):
            if not torch.equal(kops.categorical(keys[j], lg[j], cap, take=c), w):
                fail(f"categorical {label}: party {j}'s one-stream draw differs")
        log(f"  categorical {label}: T={len(counts)} n={lg.shape[1]} cap={cap} "
            f"counts={counts}: kernel == plain, bit for bit (both entry shapes)")

    log("categorical (the DIS draw) vs its plain version, bit for bit:")
    for n, cap, counts in [(37, 20, [5, 0, 15]), (1, 1, [1, 0]), (7, 3, [2]),
                           (33, 9, [0, 9, 0, 0]), (kcat.ROW_THREAD_MAX, 5, [2, 3]),
                           (kcat.ROW_THREAD_MAX + 1, 5, [3, 1]), (999, 7, [0, 0, 7]),
                           (100_003, 3, [1, 2, 0])]:
        T_ = len(counts)
        check_k5(rng.split(rng.PRNGKey(n + cap), T_).to(dev),
                 torch.log(torch.rand(T_, n, generator=gen) + 0.01).to(dev), cap, counts,
                 "sweep")
    # the main path's shapes: round 1 (n = T over m rows), a k-means++ pick
    # over the full rows and over a coreset's, round 2 over the parties
    m5 = BUDGETS[-1]
    G_lg = torch.log(torch.rand(1, T_PARTIES, generator=gen) + 0.01).to(dev)
    k5_keys = rng.split(rng.PRNGKey(args.seed + 12), T_PARTIES).to(dev)
    check_k5(k5_keys[:1], G_lg, m5, [m5], "round 1")
    lg3 = torch.log(torch.rand(T_PARTIES, N_FULL, generator=gen) + 0.01).to(dev)
    check_k5(k5_keys[:1], lg3[:1], 1, [1], "k-means++ pick")
    check_k5(k5_keys[:1], lg3[:1, :m5].contiguous(), 1, [1], "k-means++ pick at m")
    draws = kops.categorical(k5_keys[0], G_lg[0], m5)
    k5_a = torch.zeros(T_PARTIES, dtype=torch.int64, device=dev).scatter_add_(
        0, draws, torch.ones_like(draws))
    k5_call = lambda: kops.categorical_parties(k5_keys, lg3, m5, k5_a, total=m5)
    k5_got = k5_call()
    want, k5_plain = cuda_once(torch, lambda: rng.categorical_parties_plain(
        k5_keys, lg3, m5, k5_a))
    if not (torch.equal(k5_got, want) and torch.equal(k5_got, k5_call())):
        fail(f"categorical round 2 ({T_PARTIES}, {N_FULL}) cap {m5}: the kernel differs "
             f"from the plain version or from itself")
    k5_err = float((k5_got - want).abs().max())
    k5_ms = cuda_ms(torch, k5_call, iters=5, warmup=1)
    k5_bound, k5_by = categorical_bound_ms(m5 * N_FULL,
                                           4 * T_PARTIES * N_FULL + 8 * m5
                                           + 8 * T_PARTIES + 16 * T_PARTIES)
    log(f"  categorical round 2 ({T_PARTIES}, {N_FULL}) cap {m5}, counts "
        f"{k5_a.tolist()} on the device: kernel == plain, bit for bit")
    log(f"time categorical ({T_PARTIES}, {N_FULL}) cap {m5}: kernel {k5_ms:.4f} ms, "
        f"plain {k5_plain:.4f} ms, bound {k5_bound:.4f} ms ({k5_by}; "
        f"{m5 * N_FULL} candidates of {K5_INT32_OPS} int32 and {K5_FP32_OPS} fp32 "
        f"operations each)")
    # one draw with cap * n just past the counter limit, timed; its rows
    # across the first block edge, the head and the last equal the plain rows
    lg = torch.log(torch.rand(N_FULL, generator=gen) + 0.01).to(dev)
    kd = key.to(dev)
    idx, cat_ms = cuda_once(torch, lambda: kops.categorical(kd, lg, CAP_PAST_LIMIT))
    edge = (2 ** 32 - 1) // N_FULL
    sample = sorted({0, 1, 2, CAP_PAST_LIMIT // 2, edge - 1, edge, CAP_PAST_LIMIT - 1})
    cols = torch.arange(N_FULL, dtype=torch.int64, device=dev)
    for r in sample:
        row = rng._gumbel_of(rng._bits_at(kd, r * N_FULL + cols, CAP_PAST_LIMIT * N_FULL)) + lg
        if int(idx[r]) != int(torch.argmax(row)):
            fail(f"categorical past the counter limit: row {r} is {int(idx[r])}, the "
                 f"plain row's {int(torch.argmax(row))}")
    if idx.shape != (CAP_PAST_LIMIT,) or int(idx.min()) < 0 or int(idx.max()) >= N_FULL:
        fail(f"categorical past the counter limit: malformed draw {tuple(idx.shape)}")
    log(f"rng: categorical cap={CAP_PAST_LIMIT} n={N_FULL} (cap*n = "
        f"{CAP_PAST_LIMIT * N_FULL} > 2**32 - 1) drew in {cat_ms:.4f} ms; rows "
        f"{sample} (the first block edge is in row {edge}) equal the plain rows")

    # timing at the main path's shapes
    T, n, s = blocks.shape
    lev_ms = cuda_ms(torch, lambda: klev.leverage(blocks, M))
    lev_plain = cuda_ms(torch, lambda: klev.plain(blocks, M))
    lev_lib = cuda_ms(torch, lambda: torch.einsum("tns,tsr,tnr->tn", blocks, M, blocks))
    lev_bound, lev_by = bound_ms(4 * (T * n * s + T * s * s + T * n),
                                 2 * T * n * (s * s + s))
    d = D_FULL
    wg_ms = cuda_ms(torch, lambda: kwg.weighted_gram(X_full, ones))
    wg_plain = cuda_ms(torch, lambda: kwg.plain(X_full, ones))
    wg_lib = cuda_ms(torch, lambda: torch.einsum("nd,n,ne->de", X_full, ones, X_full))
    wg_bound, wg_by = bound_ms(4 * (N_FULL * d + N_FULL + d * d), gram_flops(N_FULL, d))
    wc_ms = cuda_ms(torch, lambda: kwg.weighted_gram(Xc, wc))
    wc_plain = cuda_ms(torch, lambda: kwg.plain(Xc, wc))
    wc_lib = cuda_ms(torch, lambda: torch.einsum("nd,n,ne->de", Xc, wc, Xc))
    wc_bound, wc_by = bound_ms(4 * (5000 * d + 5000 + d * d), gram_flops(5000, d))
    log(f"time leverage {tuple(blocks.shape)}: kernel {lev_ms:.4f} ms, plain "
        f"{lev_plain:.4f} ms, einsum {lev_lib:.4f} ms, bound {lev_bound:.4f} ms ({lev_by})")
    log(f"time weighted_gram {tuple(X_full.shape)}: kernel {wg_ms:.4f} ms, plain "
        f"{wg_plain:.4f} ms, einsum {wg_lib:.4f} ms, bound {wg_bound:.4f} ms ({wg_by})")
    log(f"time weighted_gram {tuple(Xc.shape)}: kernel {wc_ms:.4f} ms, plain "
        f"{wc_plain:.4f} ms, einsum {wc_lib:.4f} ms, bound {wc_bound:.4f} ms ({wc_by})")

    # the k-means kernels at the main path's shapes: Lloyd and scoring on
    # the stacked parties (w = None), the full-data baseline fit (unit
    # weights), the coreset fit (weights) and kmeans_cost
    kb = ds.stacked().blocks                                      # (3, n, 30)
    rows = torch.randperm(N_FULL, generator=gen)[:K_CLUSTERS].to(dev)
    Cb = kb[:, rows, :].contiguous()                              # (3, 10, 30)
    Cf = X_full[rows].contiguous()                                # (10, 90)
    kau_err = check_kmeans(torch, kref, "kmeans_assign_update",
                           kkau.kmeans_assign_update, kkau.plain, kb, Cb, fused=True)
    kau_err = max(kau_err, check_kmeans(
        torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update,
        kkau.plain, X_full, Cf, ones, fused=True))
    check_kmeans(torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update,
                 kkau.plain, Xc, Cf, wc, fused=True)
    # the fast K2 against its global variant, bit for bit, at the main path's
    # shapes (timed) and below over the sweep and the edge cases
    for Xo, Co, wo in [(kb, Cb, None), (X_full, Cf, ones), (Xc, Cf, wc)]:
        check_k2_oracle(torch, kkau, Xo, Co, wo, timed=True)
    ka_err = check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign,
                          kka.plain, X_full, Cf)
    check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign, kka.plain, Xc, Cf)
    # the fast K4 against its global variant, bit for bit, at the main path's
    # shapes (timed) and below over the sweep and the edge cases
    for Xo in (X_full, Xc):
        check_k4_oracle(torch, kka, Xo, Cf, timed=True)
    # the sweep: odd n, d = 1, k = 1, duplicate centers (a tie takes the
    # first index), batch on X only, C only and both, w None / given /
    # batched / all zero, and k*d at the shared-memory limit
    kmax = max(k for k in range(1, 2000)
               if kkau.smem_bytes(k, 64, 32) <= kka.MAX_SMEM_BYTES)
    for n, k, dk, xb, cb, wk in [(1, 1, 1, (), (), None), (7, 3, 1, (), (), "w"),
                                (37, 1, 5, (), (), "w"), (1001, 8, 13, (), (), None),
                                (129, 4, 5, (3,), (), "w"), (65, 5, 9, (), (2,), "wb"),
                                (301, 8, 13, (3,), (3,), "wb"),
                                (200, 6, 4, (2,), (2,), "zero"),
                                (1001, kmax, 64, (), (), "w")]:
        Xs, Cs = randn(*xb, n, dk), randn(*cb, k, dk)
        if k > 2:
            Cs[..., 2, :] = Cs[..., 0, :]
        lead = xb or cb
        w = {None: None, "w": torch.rand(n, generator=gen).to(dev),
             "wb": torch.rand(*lead, n, generator=gen).to(dev),
             "zero": torch.zeros(n, device=dev)}[wk]
        check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign,
                     kka.plain, Xs, Cs)
        check_kmeans(torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update,
                     kkau.plain, Xs, Cs, w, fused=True)
        check_k2_oracle(torch, kkau, Xs, Cs, w)
        check_k4_oracle(torch, kka, Xs, Cs)
        if k > 2 and bool((kkau.kmeans_assign_update(Xs, Cs, w)[0] == 2).any()):
            fail(f"kmeans_assign_update k={k}: a duplicate center took a row")
    # K2's ragged edges: every row in one cluster of ten (several ranges, a
    # short last tile), one cluster empty in most tiles, and a one-row range
    Cs = randn(10, 90)
    for Xs in (Cs[3] + 1e-3 * randn(100_003, 90),
               torch.cat([randn(4000, 90), Cs[7] + 1e-3 * randn(3, 90)])[
                   torch.randperm(4003, generator=gen).to(dev)],
               randn(2, 257, 90)):
        check_k2_oracle(torch, kkau, Xs, Cs, torch.rand(Xs.shape[-2], generator=gen).to(dev))
    # K4's edges: fewer rows than a tile, one row, a short last tile over
    # many CTAs, d = 1, k = 1, k = 9 (a last block of one center), duplicate
    # centers, batch on X, on C and on both; and each one-buffer layout
    # (32, 16 and 8 rows), at the largest k whose one-tile layout fits
    for n, k, dk, xb, cb in [(1, 1, 1, (), ()), (7, 9, 90, (), ()), (100, 10, 90, (), ()),
                             (100_003, 10, 90, (), ()), (129, 9, 1, (3,), ()),
                             (1000, 10, 90, (), (2,)), (257, 17, 13, (2,), (2,)),
                             (300, 856, 64, (), ()), (300, 19_336, 2, (), ()),
                             (300, 29_040, 1, (), ())]:
        Xs, Cs = randn(*xb, n, dk), randn(*cb, k, dk)
        if k > 2:
            Cs[..., 2, :] = Cs[..., 0, :]
        check_k4_oracle(torch, kka, Xs, Cs)
    # past the shared-memory layout the global variants run, with the same
    # assignments as the plain version
    # (K4 keeps its smaller layout at k = kmax + 1, d = 64)
    for n, k, dk, xb, cb, wk, k4 in [(1001, kmax + 1, 64, (), (), "w", 128),
                                    (N_WIDE, 2000, 64, (), (), None, kka.GLOBAL),
                                    (N_WIDE, 10, 2048, (), (), "w", kka.GLOBAL),
                                    (2001, 10, 2048, (2,), (2,), "wb", kka.GLOBAL)]:
        plans = (kka.assign_layout(k, dk), kka.tile_rows(k, dk, kkau.smem_bytes))
        if plans != (k4, kka.GLOBAL):
            fail(f"k-means kernels at (k, d) = ({k}, {dk}) planned {plans}, "
                 f"not ({k4}, {kka.GLOBAL})")
        Xs, Cs = randn(*xb, n, dk), randn(*cb, k, dk)
        w = {None: None, "w": torch.rand(n, generator=gen).to(dev),
             "wb": torch.rand(*xb, n, generator=gen).to(dev)}[wk]
        check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign,
                     kka.plain, Xs, Cs, exact=True)
        check_kmeans(torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update,
                     kkau.plain, Xs, Cs, w, fused=True, exact=True)
        if k4 != kka.GLOBAL:
            check_k4_oracle(torch, kka, Xs, Cs)
            # K4's shared-memory layout and K2's global variant: the same bits
            same = all(torch.equal(a, b) for a, b in zip(
                kka.kmeans_assign(Xs, Cs), kkau.kmeans_assign_update(Xs, Cs, w)[:2]))
            if not same:
                fail(f"(k, d) = ({k}, {dk}): K2's global variant and K4's "
                     f"shared-memory kernel assign differently")
            log(f"  (k, d) = ({k}, {dk}): K2's global variant gives K4's "
                f"shared-memory assign and d2 bit for bit")
    log(f"  k*d limit: k={kmax} at d=64 takes the shared-memory layout, "
        f"k={kmax + 1} and d=2048 the global variants")

    n, B, s = kb.shape[1], kb.shape[0], kb.shape[2]
    kau_ms = cuda_ms(torch, lambda: kkau.kmeans_assign_update(kb, Cb))
    kau_plain = cuda_ms(torch, lambda: kkau.plain(kb, Cb))
    kau_lib = cuda_ms(torch, lambda: library_assign_update(torch, kb, Cb))
    kau_bound, kau_by = bound_ms(kmeans_bytes(B, n, K_CLUSTERS, s, True, 0, True),
                                 B * kmeans_flops(n, K_CLUSTERS, s, True))
    kf_ms = cuda_ms(torch, lambda: kkau.kmeans_assign_update(X_full, Cf, ones))
    kf_plain = cuda_ms(torch, lambda: kkau.plain(X_full, Cf, ones))
    kf_lib = cuda_ms(torch, lambda: library_assign_update(torch, X_full, Cf, ones))
    kf_bound, kf_by = bound_ms(kmeans_bytes(1, N_FULL, K_CLUSTERS, d, False, N_FULL, True),
                               kmeans_flops(N_FULL, K_CLUSTERS, d, True))
    kc_ms = cuda_ms(torch, lambda: kkau.kmeans_assign_update(Xc, Cf, wc))
    kc_plain = cuda_ms(torch, lambda: kkau.plain(Xc, Cf, wc))
    kc_lib = cuda_ms(torch, lambda: library_assign_update(torch, Xc, Cf, wc))
    kc_bound, kc_by = bound_ms(kmeans_bytes(1, 5000, K_CLUSTERS, d, False, 5000, True),
                               kmeans_flops(5000, K_CLUSTERS, d, True))
    ka_ms = cuda_ms(torch, lambda: kka.kmeans_assign(X_full, Cf))
    ka_plain = cuda_ms(torch, lambda: kka.plain(X_full, Cf))
    ka_lib = cuda_ms(torch, lambda: torch.cdist(X_full, Cf).min(-1))
    ka_bound, ka_by = bound_ms(kmeans_bytes(1, N_FULL, K_CLUSTERS, d, False, 0, False),
                               kmeans_flops(N_FULL, K_CLUSTERS, d, False))
    kac_ms = cuda_ms(torch, lambda: kka.kmeans_assign(Xc, Cf))
    kac_plain = cuda_ms(torch, lambda: kka.plain(Xc, Cf))
    kac_lib = cuda_ms(torch, lambda: torch.cdist(Xc, Cf).min(-1))
    kac_bound, kac_by = bound_ms(kmeans_bytes(1, 5000, K_CLUSTERS, d, False, 0, False),
                                 kmeans_flops(5000, K_CLUSTERS, d, False))
    # the general variants, at N_WIDE rows
    variants = {"leverage": [], "kmeans_assign": [], "kmeans_assign_update": []}

    def time_variant(nm, shape, fn, plain_fn, lib_fn, nbytes, flops, err):
        km, pm, lm = cuda_ms(torch, fn), cuda_ms(torch, plain_fn), cuda_ms(torch, lib_fn)
        bd, by = bound_ms(nbytes, flops)
        log(f"time {nm} {shape} (general variant): kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, library {lm:.4f} ms, bound {bd:.4f} ms ({by})")
        variants[nm].append({"shape": shape, "max_abs_err": err, "ms": km,
                             "plain_ms": pm, "library_ms": lm, "bound_ms": bd,
                             "bound_by": by})

    sw = Xw.shape[1]
    time_variant("leverage", f"{tuple(Xw.shape)} x {tuple(Mw.shape)}",
                 lambda: klev.leverage(Xw, Mw), lambda: klev.plain(Xw, Mw),
                 lambda: torch.einsum("ns,sr,nr->n", Xw, Mw, Xw),
                 4 * (N_WIDE * sw + sw * sw + N_WIDE), 2 * N_WIDE * (sw * sw + sw), levw_err)
    for k, dk in [(2000, 64), (10, 2048)]:
        Xg, Cg = randn(N_WIDE, dk), randn(k, dk)
        wg = torch.rand(N_WIDE, generator=gen).to(dev)
        shape = f"{tuple(Xg.shape)} x {tuple(Cg.shape)}"
        err = check_kmeans(torch, kref, "kmeans_assign", kka.kmeans_assign,
                           kka.plain, Xg, Cg, exact=True)
        time_variant("kmeans_assign", shape, lambda: kka.kmeans_assign(Xg, Cg),
                     lambda: kka.plain(Xg, Cg), lambda: torch.cdist(Xg, Cg).min(-1),
                     kmeans_bytes(1, N_WIDE, k, dk, False, 0, False),
                     kmeans_flops(N_WIDE, k, dk, False), err)
        err = check_kmeans(torch, kref, "kmeans_assign_update", kkau.kmeans_assign_update,
                           kkau.plain, Xg, Cg, wg, fused=True, exact=True)
        time_variant("kmeans_assign_update", shape + " w",
                     lambda: kkau.kmeans_assign_update(Xg, Cg, wg),
                     lambda: kkau.plain(Xg, Cg, wg),
                     lambda: library_assign_update(torch, Xg, Cg, wg),
                     kmeans_bytes(1, N_WIDE, k, dk, False, N_WIDE, True),
                     kmeans_flops(N_WIDE, k, dk, True), err)

    lib_kau = "cdist(X, C).min(-1) + index_add_ x3"
    for nm, shape, km, pm, lm, lname, bd, by in [
            ("kmeans_assign_update", f"{tuple(kb.shape)} x {tuple(Cb.shape)} w=None",
             kau_ms, kau_plain, kau_lib, lib_kau, kau_bound, kau_by),
            ("kmeans_assign_update", f"{tuple(X_full.shape)} x {tuple(Cf.shape)} w=ones",
             kf_ms, kf_plain, kf_lib, lib_kau, kf_bound, kf_by),
            ("kmeans_assign_update", f"{tuple(Xc.shape)} x {tuple(Cf.shape)} w",
             kc_ms, kc_plain, kc_lib, lib_kau, kc_bound, kc_by),
            ("kmeans_assign", f"{tuple(X_full.shape)} x {tuple(Cf.shape)}",
             ka_ms, ka_plain, ka_lib, "cdist(X, C).min(-1)", ka_bound, ka_by),
            ("kmeans_assign", f"{tuple(Xc.shape)} x {tuple(Cf.shape)}",
             kac_ms, kac_plain, kac_lib, "cdist(X, C).min(-1)", kac_bound, kac_by)]:
        log(f"time {nm} {shape}: kernel {km:.4f} ms, plain {pm:.4f} ms, "
            f"{lname} {lm:.4f} ms, bound {bd:.4f} ms ({by})")

    # the checks' own large tensors go before the main path, so its
    # peak_bytes counts the path's memory and the dataset only
    del Xw, Mw, Xg, Cg, wg, Xs, Cs, Ms, w, lg, idx, lg3, want, k5_got
    torch.cuda.empty_cache()

    # ---- 4. main path: vrlr ---------------------------------------------------
    launches = {fn.__name__: 0 for fn in counted}
    mat_peaks = {}
    pipeline = CoresetPipeline(ds)
    results = {}
    for m in BUDGETS:
        spec = CoresetSpec(task="vrlr", budgets=m)
        key = rng.fold_in(rng.PRNGKey(args.seed), m)
        led = CommLedger()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        cs = pipeline.build(spec, key=key, ledger=led)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        built_units = led.total
        fit = fit_ridge(ds, cs, lam, ledger=led)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rep = evaluate(ds, fit)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = read_counts()
        nl, nw = counts["leverage"], counts["weighted_gram"]
        peak = torch.cuda.max_memory_allocated()
        mat_peaks[("vrlr", m)] = peak
        for nm, c in counts.items():
            launches[nm] += c
        results[m] = (cs, rep)
        log(f"m={m}: build_s={t1 - t0:.4f} fit_s={t2 - t1:.4f} eval_s={t3 - t2:.4f} "
            f"rel_error={rep.rel_error:.6g} indices_sha256={digest(cs.indices)} "
            f"comm_units={cs.comm_units} "
            f"comm_bits={cs.comm_bits} peak_bytes={peak} "
            f"launches {counts}")
        want = CommSchedule.dis_total(T_PARTIES, m)
        if cs.comm_units != want or built_units != want:
            fail(f"m={m}: bill {cs.comm_units} (ledger {built_units}) != "
                 f"dis_total {want}")
        if led.total - built_units != 2 * m * T_PARTIES:
            fail(f"m={m}: fit_ridge billed {led.total - built_units}, "
                 f"Theorem 2.5 says {2 * m * T_PARTIES}")
        if nl < 1 or nw < 2:
            fail(f"m={m}: the path did not go through the kernels "
                 f"(leverage {nl}, weighted_gram {nw})")
        if counts["kmeans_assign"] or counts["kmeans_assign_update"]:
            fail(f"m={m}: vrlr launched a k-means kernel: {counts}")
        if counts["categorical"] != 2:
            fail(f"m={m}: {counts['categorical']} categorical launches, not 2 (one a "
                 f"DIS round)")
        if args.seed == 0 and digest(cs.indices) != PARENT_DIGESTS[("vrlr", m)]:
            fail(f"m={m}: indices_sha256 {digest(cs.indices)}, recorded "
                 f"{PARENT_DIGESTS[('vrlr', m)]}")
        if cs.indices.shape != (m,) or not torch.isfinite(cs.weights).all():
            fail(f"m={m}: malformed coreset")
        if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
            fail(f"m={m}: rel_error {rep.rel_error} not finite or >= {REL_ERROR_GATE}")

    # where the build's time goes (outside the counted runs): scoring, the
    # DIS draw, the host copy of the mass table for the health report; the
    # draw runs with any host synchronisation an error
    m = BUDGETS[-1]
    key = rng.fold_in(rng.PRNGKey(args.seed), m).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, dis_key = vrlr_scores(key, ds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = dis_plan_full(dis_key, scores, m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    health_from_masses(scores.cpu().numpy())
    t3 = time.perf_counter()
    if not torch.equal(plan.indices, results[m][0].indices):
        fail(f"m={m}: rerunning the build's stages drew another coreset")
    log(f"breakdown m={m}: score_s={t1 - t0:.4f} dis_s={t2 - t1:.4f} "
        f"health_s={t3 - t2:.4f}; dis_plan_full ran under "
        f"set_sync_debug_mode('error')")

    # end_to_end is the staged path above: same key, same draw, same error
    m = BUDGETS[0]
    cs_e, _, rep_e = end_to_end(CoresetSpec(task="vrlr", budgets=m), ds,
                                key=rng.fold_in(rng.PRNGKey(args.seed), m), lam=lam)
    if not torch.equal(cs_e.indices, results[m][0].indices) or rep_e.rel_error != results[m][1].rel_error:
        fail("end_to_end differs from build -> fit_ridge -> evaluate")
    ident = evaluate(ds, fit_ridge(ds, full_data_coreset(ds), lam))
    log(f"identity coreset: rel_error={ident.rel_error:.3e}")
    if not abs(ident.rel_error) <= 1e-5:
        fail(f"identity coreset rel_error {ident.rel_error} above 1e-5")

    # small input: the card against the port's plain path on the CPU
    Xs, ys = make_data(args.seed + 1, 2000, 12)
    ds_gpu = VFLDataset.from_dense(Xs, ys, T=3)
    ds_cpu = VFLDataset.from_dense(Xs, ys, T=3, device="cpu")
    key = rng.PRNGKey(args.seed + 2)
    spec = CoresetSpec(task="vrlr", budgets=128)
    cs_g, fit_g, rep_g = end_to_end(spec, ds_gpu, key=key, lam=200.0)
    cs_c, fit_c, rep_c = end_to_end(spec, ds_cpu, key=key, lam=200.0, device="cpu")
    same = torch.equal(cs_g.indices.cpu(), cs_c.indices)
    log(f"small input card vs CPU: indices equal={same} rel_error "
        f"{rep_g.rel_error:.6g} vs {rep_c.rel_error:.6g}")
    if cs_g.comm_units != cs_c.comm_units or abs(rep_g.rel_error - rep_c.rel_error) > 1e-3:
        fail("small input: card and CPU disagree")
    sc = torch.rand(3, 2000, generator=gen) + 0.01
    pg = dis_plan_full(key.to(dev), sc.to(dev), 128)
    pc = dis_plan_full(key, sc, 128)
    if not (torch.equal(pg.indices.cpu(), pc.indices) and torch.equal(pg.counts.cpu(), pc.counts)):
        fail("DIS on shared scores draws different indices on the card and the CPU")
    log("DIS on shared scores: card and CPU draw the same indices")

    # ---- 5. main path: vkmc ---------------------------------------------------
    # launches per end_to_end, counted from the code: K2 once per Lloyd
    # iteration (15 local on the party stack, 25 in fit_kmeans, 25 in the
    # full-data baseline fit) and once for the scoring pass; K4 once for
    # the coreset objective and three times at full n (cost_fit, the
    # baseline's own objective, cost_opt)
    want_k2 = LOCAL_ITERS + 1 + 2 * FIT_ITERS
    want_k4 = 1 + 3
    # K5: k picks of local k-means++ per party, the two DIS rounds, and k
    # picks each for k-means++ on the coreset and on the full data
    want_k5 = T_PARTIES * K_CLUSTERS + 2 + 2 * K_CLUSTERS
    lemma = total_sensitivity_bound_vkmc(K_CLUSTERS, 1, ALPHA)
    vk_results = {}
    for m in BUDGETS:
        spec = CoresetSpec(task="vkmc", budgets=m,
                           params={"k": K_CLUSTERS, "alpha": ALPHA,
                                   "local_iters": LOCAL_ITERS})
        key = rng.fold_in(rng.PRNGKey(args.seed + 100), m)
        sk = rng.fold_in(key, 1)
        led = CommLedger()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        cs = pipeline.build(spec, key=key, ledger=led)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        built_units = led.total
        fit = fit_kmeans(ds, cs, K_CLUSTERS, key=sk, iters=FIT_ITERS, ledger=led)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rep = evaluate(ds, fit, key=sk, iters=FIT_ITERS)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        mat_peaks[("vkmc", m)] = peak
        for nm, c in counts.items():
            launches[nm] += c
        vk_results[m] = (cs, rep, fit)
        best_rel = rep.cost_fit / min(rep.cost_fit, rep.cost_opt) - 1.0
        log(f"vkmc m={m}: build_s={t1 - t0:.4f} fit_s={t2 - t1:.4f} "
            f"eval_s={t3 - t2:.4f} rel_error={rep.rel_error:.6g} "
            f"indices_sha256={digest(cs.indices)} "
            f"rel_error_vs_best={best_rel:.6g} cost_fit={rep.cost_fit:.8g} "
            f"cost_opt={rep.cost_opt:.8g} comm_units={cs.comm_units} "
            f"comm_bits={cs.comm_bits} peak_bytes={peak} launches {counts}")
        want = CommSchedule.dis_total(T_PARTIES, m)
        if cs.comm_units != want or built_units != want:
            fail(f"vkmc m={m}: bill {cs.comm_units} (ledger {built_units}) != "
                 f"dis_total {want}")
        if led.total - built_units != 2 * m * T_PARTIES:
            fail(f"vkmc m={m}: fit_kmeans billed {led.total - built_units}, "
                 f"Theorem 2.5 says {2 * m * T_PARTIES}")
        if (counts["kmeans_assign_update"], counts["kmeans_assign"],
                counts["categorical"]) != (want_k2, want_k4, want_k5):
            fail(f"vkmc m={m}: launches {counts}, counted K2 {want_k2}, K4 {want_k4} "
                 f"and K5 {want_k5} from the code")
        if args.seed == 0 and digest(cs.indices) != PARENT_DIGESTS[("vkmc", m)]:
            fail(f"vkmc m={m}: indices_sha256 {digest(cs.indices)}, recorded "
                 f"{PARENT_DIGESTS[('vkmc', m)]}")
        if cs.indices.shape != (m,) or not torch.isfinite(cs.weights).all():
            fail(f"vkmc m={m}: malformed coreset")
        if fit.params.shape != (K_CLUSTERS, D_FULL) or not torch.isfinite(fit.params).all():
            fail(f"vkmc m={m}: malformed centers")
        if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
            fail(f"vkmc m={m}: rel_error {rep.rel_error} not finite or >= {REL_ERROR_GATE}")

    # where the vkmc build's time goes (outside the counted runs), stage by
    # stage with the build's key: the same draw, and Lemma F.2's sum
    m = BUDGETS[-1]
    key = rng.fold_in(rng.PRNGKey(args.seed + 100), m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_sub = key
    subs = []
    for _ in range(T_PARTIES):
        k_sub, sub = rng.split(k_sub)
        subs.append(sub)
    k_sub, dis_key = rng.split(k_sub)
    blocks = ds.stacked().blocks
    init = torch.stack([kmeans_plusplus(sub, Xb, K_CLUSTERS)
                        for sub, Xb in zip(subs, blocks)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    local_c = lloyd(blocks, init, iters=LOCAL_ITERS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    scores = vkmc_local_scores(blocks, local_c, ALPHA)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    plan = dis_plan_full(dis_key, scores, m)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    health_from_masses(scores.cpu().numpy())
    t5 = time.perf_counter()
    if not torch.equal(plan.indices, vk_results[m][0].indices):
        fail(f"vkmc m={m}: rerunning the build's stages drew another coreset")
    sizes = kmeans_update(blocks, local_c)[3]
    sums = scores.sum(-1).double()
    log(f"breakdown vkmc m={m}: kmeanspp_s={t1 - t0:.4f} lloyd_s={t2 - t1:.4f} "
        f"score_s={t3 - t2:.4f} dis_s={t4 - t3:.4f} health_s={t5 - t4:.4f}; "
        f"score sums per party {sums.tolist()} (Lemma F.2: {lemma}), "
        f"smallest local cluster {int(sizes.min())}")
    if bool((sizes > 0).all()) and not torch.allclose(
            sums, torch.full_like(sums, lemma), rtol=1e-4, atol=0.0):
        fail(f"vkmc: per-party score sums {sums.tolist()} != Lemma F.2's {lemma}")

    # end_to_end is the staged path above, and the identity coreset fit
    # with the baseline's key reproduces the baseline
    m = BUDGETS[0]
    key = rng.fold_in(rng.PRNGKey(args.seed + 100), m)
    cs_e, _, rep_e = end_to_end(
        CoresetSpec(task="vkmc", budgets=m,
                    params={"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS}),
        ds, key=key, k=K_CLUSTERS, iters=FIT_ITERS)
    if (not torch.equal(cs_e.indices, vk_results[m][0].indices)
            or rep_e.rel_error != vk_results[m][1].rel_error):
        fail("vkmc end_to_end differs from build -> fit_kmeans -> evaluate")
    sk = rng.fold_in(key, 1)
    ident = evaluate(ds, fit_kmeans(ds, full_data_coreset(ds), K_CLUSTERS, key=sk,
                                    iters=FIT_ITERS), key=sk, iters=FIT_ITERS)
    log(f"vkmc identity coreset: rel_error={ident.rel_error:.3e}")
    if ident.rel_error != 0.0:
        fail(f"vkmc identity coreset rel_error {ident.rel_error} is not 0")

    # small input: the card against the port's plain path on the CPU, at
    # widths 5, 4, 4, so the batched K2 sees zero-padded columns
    Xs, _ = make_data(args.seed + 3, 2000, 13)
    ds_gpu = VFLDataset.from_dense(Xs, None, T=3)
    ds_cpu = VFLDataset.from_dense(Xs, None, T=3, device="cpu")
    key = rng.PRNGKey(args.seed + 4)
    same_seeds = all(
        torch.equal(kmeans_plusplus(sub, ds_gpu.parts[j], 6).cpu(),
                    kmeans_plusplus(sub, ds_cpu.parts[j], 6))
        for j, sub in enumerate(rng.split(key, 3)))
    if not same_seeds:
        fail("small input: k-means++ picks other rows on the card than on the CPU")
    sg, dkg = vkmc_scores(key, ds_gpu, k=6)
    sc_, dkc = vkmc_scores(key, ds_cpu, backend="ref", k=6)
    score_gap = float(((sg.cpu() - sc_).abs() / sc_.abs()).max())
    if not torch.equal(dkg.cpu(), dkc) or score_gap > 1e-4:
        fail(f"small input: vkmc scores differ by {score_gap:.3e} (rtol 1e-4)")
    spec = CoresetSpec(task="vkmc", budgets=128, params={"k": 6})
    cs_g, _, rep_g = end_to_end(spec, ds_gpu, key=key, k=6)
    cs_c, _, rep_c = end_to_end(spec, ds_cpu, key=key, k=6, device="cpu")
    same = torch.equal(cs_g.indices.cpu(), cs_c.indices)
    differ = "" if same else (
        f" ({int((cs_g.indices.cpu() != cs_c.indices).sum())} of 128 differ)")
    log(f"small input vkmc card vs CPU, widths {ds_gpu.dims}: k-means++ rows "
        f"equal, scores rtol {score_gap:.3e}, indices equal={same}{differ}, "
        f"rel_error {rep_g.rel_error:.6g} vs {rep_c.rel_error:.6g}")
    if cs_g.comm_units != cs_c.comm_units:
        fail("small input: vkmc bills differ on the card and the CPU")

    # ---- 6. the solver grid: paper Table 1 left and Figs 6-8 -----------------
    # benchmarks/common.py's lambdas at the full n, on three samplings of the
    # phase 4 data: all rows, phase 4's vrlr coreset at m = 5000 (its key)
    # and a uniform coreset; each solver's rel_error is the full-data
    # objective at the sampled theta over the same at the full-data theta,
    # minus 1
    m = BUDGETS[-1]
    lam1, lam2 = 2.0 * N_FULL, 1.0 * N_FULL
    y_full = ds.y
    objectives = {
        "ridge": lambda th: ridge_cost(X_full, y_full, th, lam),
        "linear": lambda th: sq_loss(X_full, y_full, th),
        "lasso": lambda th: lasso_cost(X_full, y_full, th, lam1),
        "elastic": lambda th: elastic_cost(X_full, y_full, th, lam1, lam2),
        "saga": lambda th: ridge_cost(X_full, y_full, th, lam),
    }
    reset_counts()
    u_cs = build_coreset("uniform", ds, m, key=rng.fold_in(rng.PRNGKey(args.seed + 200), m))
    samplings = {"full": (X_full, y_full, None),
                 "coreset": results[m][0].materialize(ds),
                 "uniform": u_cs.materialize(ds)}
    saga_key = rng.fold_in(rng.PRNGKey(args.seed + 300), 1)
    full_cost = {}
    for sname, (Xs_, ys_, ws_) in samplings.items():
        row = []
        for kind in objectives:
            led = CommLedger()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "saga":
                theta = saga_ridge(saga_key, Xs_, ys_, lam, ws_, steps=SAGA_STEPS,
                                   dims=ds.dims, ledger=led)
            else:
                theta = solve(kind, Xs_, ys_, ws_, lam=lam, lam1=lam1, lam2=lam2)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            cost = float(objectives[kind](theta))
            if not (bool(torch.isfinite(theta).all()) and math.isfinite(cost)):
                fail(f"solver grid: {kind} on {sname}: theta or cost not finite")
            if sname == "full":
                full_cost[kind] = cost
            rel = cost / full_cost[kind] - 1.0
            name_s = "saga_s" if kind == "saga" else "solve_s"
            row.append(f"{kind} {name_s}={solve_s:.4f} rel_error={rel:.6g}")
            if kind == "saga" and (led.total, led.by_tag()) != (
                    2 * SAGA_STEPS * T_PARTIES,
                    {"saga/partials": SAGA_STEPS * T_PARTIES,
                     "saga/residuals": SAGA_STEPS * T_PARTIES}):
                fail(f"solver grid: saga on {sname} billed {led.by_tag()}, not "
                     f"2 * {SAGA_STEPS} * {T_PARTIES}")
            if sname == "coreset" and kind != "saga" and not rel < REL_ERROR_GATE:
                fail(f"solver grid: {kind} on the coreset: rel_error {rel} >= "
                     f"{REL_ERROR_GATE}")
        log(f"solver grid {sname} (m={Xs_.shape[0]}): " + "; ".join(row))
    counts = read_counts()
    for nm, c in counts.items():
        launches[nm] += c
    want = {"leverage": 0, "weighted_gram": 2 * len(samplings), "kmeans_assign": 0,
            "kmeans_assign_update": 0, "categorical": 0}
    log(f"solver grid launches {counts}")
    if counts != want:
        fail(f"solver grid: launches {counts}, counted {want} from the code "
             f"(K3 for ridge and linear on each sampling)")
    del samplings, u_cs

    # ---- 7. the batched engine -------------------------------------------------
    # K5 at the grids' own shapes against its plain version, bit for bit
    # (outside the counts): every cell draws round 1 over T parties and
    # round 2 at the grid's capacity, m_cap = its largest budget, with the
    # device counts of a round-1 draw of the cell's budget; each vkmc seed
    # also picks k-means++ centers over its N_WIDE rows
    def check_k5_grid(cap, budgets, n, label):
        keys = rng.split(rng.PRNGKey(args.seed + 13 + cap), T_PARTIES).to(dev)
        G_lg = torch.log(torch.rand(1, T_PARTIES, generator=gen) + 0.01).to(dev)
        lg = torch.log(torch.rand(T_PARTIES, n, generator=gen) + 0.01).to(dev)
        for mb in budgets:
            check_k5(keys[:1], G_lg, cap, [mb], f"{label} round 1 m={mb}")
            draws = kops.categorical(keys[0], G_lg[0], cap, take=mb)
            a = torch.zeros(T_PARTIES, dtype=torch.int64, device=dev).scatter_add_(
                0, draws, torch.ones_like(draws))
            check_k5(keys, lg, cap, a.tolist(), f"{label} round 2 m={mb}")

    # (the vrlr grid's m = 5000 cells draw at phase 3's main-path shapes)
    vk_ms = (200, 500)
    check_k5_grid(BUDGETS[-1], BUDGETS[:1], N_FULL, "batched vrlr")
    check_k5_grid(vk_ms[-1], vk_ms, N_WIDE, "batched vkmc")
    check_k5(rng.split(rng.PRNGKey(args.seed + 14), 1).to(dev),
             torch.log(torch.rand(1, N_WIDE, generator=gen) + 0.01).to(dev), 1, [1],
             "batched vkmc k-means++ pick")
    # vrlr: a 2-seed x (1000, 5000) grid at full scale, scored once (its
    # scores do not depend on the key), each cell drawn at capacity 5000;
    # seed 0 is phase 4's m = 5000 key, so cell (0, 1) is held to that build
    gkeys = torch.stack([rng.fold_in(rng.PRNGKey(args.seed), BUDGETS[-1]),
                         rng.fold_in(rng.PRNGKey(args.seed + 400), BUDGETS[-1])])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = build_coresets_batched("vrlr", ds, BUDGETS, keys=gkeys)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    counts = read_counts()
    for nm, c in counts.items():
        launches[nm] += c
    log(f"batched vrlr 2 x {BUDGETS}: grid_s={grid_s:.4f} launches {counts}")
    if counts != {"leverage": 1, "weighted_gram": 0, "kmeans_assign": 0,
                  "kmeans_assign_update": 0, "categorical": 2 * 2 * len(BUDGETS)}:
        fail(f"batched vrlr: launches {counts}; the grid scores once (one K1) and "
             f"draws twice a cell")
    eager = results[BUDGETS[-1]][0]
    cell = grid.coreset(0, 1)
    if not (torch.equal(cell.indices, eager.indices)
            and torch.equal(cell.weights, eager.weights)):
        fail("batched vrlr: cell (0, 1) differs from phase 4's build at its key")
    for r in range(2):
        for i, mb in enumerate(BUDGETS):
            if grid.schedule(r, i).total != CommSchedule.dis_total(T_PARTIES, mb):
                fail(f"batched vrlr: cell ({r}, {i}) billed "
                     f"{grid.schedule(r, i).total}")
        m0 = BUDGETS[0]
        w0, i0 = grid.weights[r, 0], grid.indices[r, 0]
        if not (bool((w0[:m0] > 0).all()) and not bool(w0[m0:].any())
                and not bool(i0[m0:].any()) and int(grid.counts[r, 0].sum()) == m0):
            fail(f"batched vrlr: cell ({r}, 0) is not {m0} real entries and a "
                 f"zero tail")
    log(f"batched vrlr: cell (0, 1) equals phase 4's build bit for bit "
        f"(indices_sha256={digest(cell.indices)}); the m={BUDGETS[0]} cells hold "
        f"{BUDGETS[0]} real entries and a zero tail; every bill dis_total")

    # vkmc: 2 seeds x vk_ms on the first N_WIDE rows, scored per seed
    ds_w = VFLDataset.from_dense(X_np[:N_WIDE], None, T=T_PARTIES)
    vk_params = {"k": K_CLUSTERS, "alpha": ALPHA, "local_iters": LOCAL_ITERS}
    # K2 at the grid's shape, (3, N_WIDE, 30) x (3, 10, 30) with w = None,
    # against its plain version and its global variant (outside the count)
    bw = ds_w.stacked().blocks
    Cw = bw[:, torch.randperm(N_WIDE, generator=gen)[:K_CLUSTERS].to(dev), :].contiguous()
    kau_err = max(kau_err, check_kmeans(torch, kref, "kmeans_assign_update",
                                        kkau.kmeans_assign_update, kkau.plain,
                                        bw, Cw, fused=True))
    check_k2_oracle(torch, kkau, bw, Cw)
    del bw, Cw
    gkey = rng.PRNGKey(args.seed + 500)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vgrid = build_coresets_batched("vkmc", ds_w, vk_ms, key=gkey, num_seeds=2,
                                   **vk_params)
    torch.cuda.synchronize()
    vgrid_s = time.perf_counter() - t0
    counts = read_counts()
    for nm, c in counts.items():
        launches[nm] += c
    log(f"batched vkmc 2 x {vk_ms} at n={N_WIDE}: grid_s={vgrid_s:.4f} "
        f"launches {counts}")
    if counts != {"leverage": 0, "weighted_gram": 0, "kmeans_assign": 0,
                  "kmeans_assign_update": 2 * (LOCAL_ITERS + 1),
                  "categorical": 2 * (T_PARTIES * K_CLUSTERS + 2 * len(vk_ms))}:
        fail(f"batched vkmc: launches {counts}; {LOCAL_ITERS + 1} K2 per seed, "
             f"K5 for k-means++ and two a cell")
    for r, k in enumerate(rng.split(gkey, 2)):
        eager = build_coreset("vkmc", ds_w, vk_ms[-1], key=k, **vk_params)
        cell = vgrid.coreset(r, 1)
        if not (torch.equal(cell.indices, eager.indices)
                and torch.equal(cell.weights, eager.weights)):
            fail(f"batched vkmc: cell ({r}, 1) differs from build_coreset")
        for i, mb in enumerate(vk_ms):
            if vgrid.schedule(r, i).total != CommSchedule.dis_total(T_PARTIES, mb):
                fail(f"batched vkmc: cell ({r}, {i}) billed {vgrid.schedule(r, i).total}")
    log(f"batched vkmc: the m={vk_ms[-1]} cells equal build_coreset bit for bit")
    # the vkmc grid split by stage (outside the counted run), seed by seed
    # with the grid's keys: the same cells
    stage = {"kmeanspp_s": 0.0, "lloyd_s": 0.0, "score_s": 0.0, "dis_s": 0.0}
    bw = ds_w.stacked().blocks
    for r, k in enumerate(rng.split(gkey, 2).to(dev)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        subs = []
        for _ in range(T_PARTIES):
            k, sub = rng.split(k)
            subs.append(sub)
        k, dis_key = rng.split(k)
        init = torch.stack([kmeans_plusplus(sub, Xb, K_CLUSTERS)
                            for sub, Xb in zip(subs, bw)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        local_c = lloyd(bw, init, iters=LOCAL_ITERS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores = vkmc_local_scores(bw, local_c, ALPHA)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        plans = [dis_plan_full(dis_key, scores, mb, m_cap=vk_ms[-1]) for mb in vk_ms]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for i, p in enumerate(plans):
            if not (torch.equal(p.indices, vgrid.indices[r, i])
                    and torch.equal(p.weights, vgrid.weights[r, i])):
                fail(f"batched vkmc: the staged rerun of cell ({r}, {i}) drew another coreset")
        for nm, dt in zip(stage, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stage[nm] += dt
    log("breakdown batched vkmc (2 seeds): " + " ".join(
        f"{nm}={dt:.4f}" for nm, dt in stage.items()) + "; the staged cells equal the grid's")
    del grid, vgrid, ds_w, bw

    # ---- 8. the fused engine ---------------------------------------------------
    # build_coreset_jit on phase 4's data for both tasks, and the uniform
    # baseline, at both budgets: the first call captures a CUDA graph (after
    # an eager warm-up), later calls replay it; each is held to the eager
    # build of the same key (vrlr and vkmc also to phases 4 and 5), and the
    # graph is replayed for a second key and on a second dataset of the
    # same shapes
    X2_np, y2_np = make_data(args.seed + 7, N_FULL, D_FULL)
    ds2 = VFLDataset.from_dense(X2_np, y2_np, T=T_PARTIES)
    del X2_np, y2_np
    per_replay = {"vrlr": {"leverage": 1, "weighted_gram": 0, "kmeans_assign": 0,
                           "kmeans_assign_update": 0, "categorical": 2},
                  "vkmc": {"leverage": 0, "weighted_gram": 0, "kmeans_assign": 0,
                           "kmeans_assign_update": LOCAL_ITERS + 1,
                           "categorical": T_PARTIES * K_CLUSTERS + 2},
                  "uniform": dict.fromkeys(launches, 0)}
    phase_of = {"vrlr": (4, results), "vkmc": (5, vk_results), "uniform": (8, None)}
    for task, params, off in (("vrlr", {}, 0), ("vkmc", vk_params, 100),
                              ("uniform", {}, 200)):
        phase, eager_results = phase_of[task]
        for m in BUDGETS:
            key = rng.fold_in(rng.PRNGKey(args.seed + off), m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager = build_coreset(task, ds, m, key=key, **params)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            runs = []
            for _ in range(2):        # the capture (first call), then a replay
                led = CommLedger()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cs_f = build_coreset_jit(task, ds, m, key=key, ledger=led, **params)
                torch.cuda.synchronize()
                runs.append((cs_f, led.total, time.perf_counter() - t0, read_counts()))
            (first, _, capture_s, c_first), (cs_f, units, replay_s, c_replay) = runs
            for nm, c in c_replay.items():
                launches[nm] += c
            want = (CommSchedule.uniform(T_PARTIES, m).total if task == "uniform"
                    else CommSchedule.dis_total(T_PARTIES, m))
            held = eager if eager_results is None else eager_results[m][0]
            for label, got in (("first call", first), ("replay", cs_f)):
                if not torch.equal(got.indices, held.indices):
                    fail(f"fused {task} m={m}: the {label}'s indices differ from phase "
                         f"{phase}'s build")
                if not torch.equal(got.weights, eager.weights):
                    fail(f"fused {task} m={m}: the {label}'s weights differ from the "
                         f"eager build's")
                if (got.comm_units, got.comm_bits) != (eager.comm_units, eager.comm_bits):
                    fail(f"fused {task} m={m}: the {label} billed {got.comm_units}")
            if units != want or eager.comm_units != want or c_replay != per_replay[task]:
                fail(f"fused {task} m={m}: ledger {units} (dis_total {want}), replay "
                     f"launches {c_replay}, counted {per_replay[task]}")
            if c_first != {nm: 2 * c for nm, c in per_replay[task].items()}:
                fail(f"fused {task} m={m}: first call launched {c_first}; the eager "
                     f"warm-up and the replay, twice {per_replay[task]}")
            # a second key, and a second dataset of the same shapes, replay the
            # same graph and equal their eager builds
            key2 = rng.fold_in(rng.PRNGKey(args.seed + off + 600), m)
            for label, ds_, k_ in (("second key", ds, key2), ("second dataset", ds2, key)):
                got = build_coreset_jit(task, ds_, m, key=k_, **params)
                ref_ = build_coreset(task, ds_, m, key=k_, **params)
                if not (torch.equal(got.indices, ref_.indices)
                        and torch.equal(got.weights, ref_.weights)
                        and got.comm_units == ref_.comm_units):
                    fail(f"fused {task} m={m}: the {label}'s replay differs from its "
                         f"eager build")
            log(f"fused {task} m={m}: capture_s={capture_s:.4f} (first call: eager "
                f"warm-up, capture, replay) build_s={replay_s:.4f} (replay) eager "
                f"build_s={eager_s:.4f}; indices_sha256={digest(cs_f.indices)} equal to "
                f"phase {phase}'s, weights bitwise equal to the "
                f"eager build's, comm_units={cs_f.comm_units}, replay launches "
                f"{c_replay}; second key and second dataset equal their eager builds")
    del ds2

    # ---- 9. the streamed engine ---------------------------------------------------
    mat_coresets = {(task, m): res[m][0] for task, res in (("vrlr", results),
                                                           ("vkmc", vk_results)) for m in BUDGETS}
    ds_host = VFLDataset.from_dense(X_np, y_np, T=T_PARTIES, device="cpu")
    errs, streamed = streamed_phase(torch, dev, args.seed, ds_host, ds, lam, launches,
                                    mat_peaks, mat_coresets, check_k5, reset_counts,
                                    read_counts)
    lev_err = max(lev_err, errs["leverage"])
    gram_err = max(gram_err, errs["weighted_gram"])
    kau_err = max(kau_err, errs["kmeans_assign_update"])
    ka_err = max(ka_err, errs["kmeans_assign"])

    # ---- 10. the pipelined engine ---------------------------------------------------
    errs = pipelined_phase(torch, dev, args.seed, ds_host, launches, streamed, check_k5,
                           reset_counts, read_counts)
    lev_err = max(lev_err, errs["leverage"])
    gram_err = max(gram_err, errs["weighted_gram"])
    kau_err = max(kau_err, errs["kmeans_assign_update"])
    ka_err = max(ka_err, errs["kmeans_assign"])

    # ---- 11. sharded masses and the fault seam -----------------------------------
    before = dict(launches)
    errs = sharded_phase(torch, dev, args.seed, ds_host, ds, lam, launches, smi[0],
                         reset_counts, read_counts)
    log(f"phase 11 launches: {({nm: launches[nm] - before[nm] for nm in launches})}")

    # ---- 12. checkpointed resume, the planner and engine failover ---------------
    before = dict(launches)
    planner_phase(torch, dev, args.seed, ds_host, ds, launches, smi[0], reset_counts,
                  read_counts)
    log(f"phase 12 launches: {({nm: launches[nm] - before[nm] for nm in launches})}")

    # ---- 13. the merge-and-reduce serving tree ----------------------------------
    before = dict(launches)
    tree_keys, tree_trail = tree_phase(torch, dev, args.seed, ds_host, ds, lam, launches,
                                       smi[0], reset_counts, read_counts)
    log(f"phase 13 launches: {({nm: launches[nm] - before[nm] for nm in launches})}")

    # ---- 14. the multi-tenant service ---------------------------------------------
    before = dict(launches)
    service_phase(torch, dev, args.seed, ds_host, ds, launches, smi[0], reset_counts,
                  read_counts, tree_keys, tree_trail)
    log(f"phase 14 launches: {({nm: launches[nm] - before[nm] for nm in launches})}")
    del ds_host, ds

    # ---- 15. the synthetic datasets ------------------------------------------------
    before = dict(launches)
    synthetic_phase(torch, dev, args.seed, launches, smi[0], reset_counts, read_counts)
    log(f"phase 15 launches: {({nm: launches[nm] - before[nm] for nm in launches})}")
    lev_err = max(lev_err, errs["leverage"])
    gram_err = max(gram_err, errs["weighted_gram"])
    ka_err = max(ka_err, errs["kmeans_assign"])

    # ---- records ----------------------------------------------------------------
    record = {"kernels": [
        {"name": "leverage", "route": "cuda",
         "source": "src/repro_torch/csrc/leverage.cu",
         "replaces": "src/repro/kernels/leverage.py:59",
         "launches": launches["leverage"], "max_abs_err": lev_err,
         "ms": lev_ms, "plain_ms": lev_plain, "bound_ms": lev_bound,
         "bound_by": lev_by, "library_ms": lev_lib,
         "variants": variants["leverage"]},
        {"name": "weighted_gram", "route": "cuda",
         "source": "src/repro_torch/csrc/weighted_gram.cu",
         "replaces": "src/repro/kernels/weighted_gram.py:67",
         "launches": launches["weighted_gram"], "max_abs_err": gram_err,
         "ms": wg_ms, "plain_ms": wg_plain, "bound_ms": wg_bound,
         "bound_by": wg_by, "library_ms": wg_lib,
         "variants": [{"shape": str(tuple(Xc.shape)), "ms": wc_ms,
                       "plain_ms": wc_plain, "library_ms": wc_lib,
                       "bound_ms": wc_bound, "bound_by": wc_by}]},
        {"name": "kmeans_assign_update", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign_update.cu",
         "replaces": "src/repro/kernels/kmeans_assign_update.py:158",
         "launches": launches["kmeans_assign_update"], "max_abs_err": kau_err,
         "ms": kau_ms, "plain_ms": kau_plain, "bound_ms": kau_bound,
         "bound_by": kau_by, "library_ms": kau_lib,
         "variants": variants["kmeans_assign_update"]},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:89",
         "launches": launches["kmeans_assign"], "max_abs_err": ka_err,
         "ms": ka_ms, "plain_ms": ka_plain, "bound_ms": ka_bound,
         "bound_by": ka_by, "library_ms": ka_lib,
         "variants": variants["kmeans_assign"]},
        # no TPU kernel behind it: the reference's XLA-compiled
        # jax.random.categorical (DIS round 2); no PyTorch call draws these bits
        {"name": "categorical", "route": "cuda",
         "source": "src/repro_torch/csrc/categorical.cu",
         "replaces": "src/repro/core/dis.py:196",
         "launches": launches["categorical"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None},
    ]}
    print(json.dumps(record))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
