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
   CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function, beside the card's bound;
4. main path: ``vrlr`` coreset -> ``fit_ridge`` -> ``evaluate`` at the
   YearPrediction scale (n = 463,715, d = 90, T = 3) for m = 1000 and 5000
   on data made from the seed, with the exact DIS bill, the Theorem 2.5
   +2mT, rising launch counters, a finite relative error under the
   benchmark gate, and the identity coreset reproducing the full solve;
   the build's time split into scoring, DIS draw and health report; then
   agreement with the CPU plain path on a small input.

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

N_FULL, D_FULL, T_PARTIES = 463_715, 90, 3   # YearPrediction, paper Table 1
BUDGETS = (1000, 5000)
REL_ERROR_GATE = 0.5                          # benchmarks/e2e.py's gate
# kernel-vs-plain tolerances, relative to the largest magnitude the sum can
# reach (fp32 sums of up to n products in another order than cuBLAS's)
LEVERAGE_TOL = 1e-5        # max|k - p| / max|p|
GRAM_TOL = 1e-5            # max|k - p| / max(|X|^T |w| |X|)


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
        end_to_end, evaluate, fit_ridge, full_data_coreset)
    from repro_torch.core.api import vrlr_scores
    from repro_torch.core.dis import dis_plan_full
    from repro_torch.core.integrity import health_from_masses
    from repro_torch.core.sensitivity import batched_gram_pinv
    from repro_torch.kernels import _build
    from repro_torch.kernels import leverage as klev
    from repro_torch.kernels import weighted_gram as kwg

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
    for n, s, xb, mb in [(1, 5, (), ()), (7, 1, (), ()), (129, 31, (3,), ()),
                         (1001, 64, (), (2,)), (4097, 33, (2,), (2,)),
                         (513, 238, (), ())]:
        check_kernel(torch, "leverage", klev.leverage, klev.plain,
                     (randn(*xb, n, s), psd(mb, s)), lev_scale, LEVERAGE_TOL)

    X_full = ds.full()
    ones = torch.ones(N_FULL, device=dev)
    Xc = X_full[:5000].contiguous()
    wc = torch.rand(5000, generator=gen).to(dev) * 100.0
    gram_err = check_kernel(torch, "weighted_gram", kwg.weighted_gram, kwg.plain,
                            (X_full, ones), gram_scale, GRAM_TOL)
    check_kernel(torch, "weighted_gram", kwg.weighted_gram, kwg.plain,
                 (Xc, wc), gram_scale, GRAM_TOL)
    for n, d, xb, wb in [(1, 1, (), ()), (7, 1, (), ()), (255, 9, (), ()),
                         (1001, 90, (3,), ()), (3001, 17, (), (2,)),
                         (2049, 31, (3,), (3,)), (777, 200, (), ())]:
        check_kernel(torch, "weighted_gram", kwg.weighted_gram, kwg.plain,
                     (randn(*xb, n, d), torch.rand(*wb, n, generator=gen).to(dev)),
                     gram_scale, GRAM_TOL)

    # rng on the card gives the CPU's bits (the draws depend on nothing else)
    key = rng.PRNGKey(args.seed + 11)
    g_cpu = rng.gumbel(key, (257, 1001))
    g_gpu = rng.gumbel(key.to(dev), (257, 1001)).cpu()
    if not torch.equal(g_cpu.view(torch.int32), g_gpu.view(torch.int32)):
        fail("gumbel bits on the card differ from the CPU's")
    log("rng: gumbel (257, 1001) bitwise equal on card and CPU")

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

    # ---- 4. main path ---------------------------------------------------------
    launches = {"leverage": 0, "weighted_gram": 0}
    pipeline = CoresetPipeline(ds)
    results = {}
    for m in BUDGETS:
        spec = CoresetSpec(task="vrlr", budgets=m)
        key = rng.fold_in(rng.PRNGKey(args.seed), m)
        led = CommLedger()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        klev.leverage.launches = 0
        kwg.weighted_gram.launches = 0
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
        nl, nw = klev.leverage.launches, kwg.weighted_gram.launches
        peak = torch.cuda.max_memory_allocated()
        launches["leverage"] += nl
        launches["weighted_gram"] += nw
        results[m] = (cs, rep)
        log(f"m={m}: build_s={t1 - t0:.4f} fit_s={t2 - t1:.4f} eval_s={t3 - t2:.4f} "
            f"rel_error={rep.rel_error:.6g} comm_units={cs.comm_units} "
            f"comm_bits={cs.comm_bits} peak_bytes={peak} "
            f"launches leverage={nl} weighted_gram={nw}")
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
        if cs.indices.shape != (m,) or not torch.isfinite(cs.weights).all():
            fail(f"m={m}: malformed coreset")
        if not (math.isfinite(rep.rel_error) and rep.rel_error < REL_ERROR_GATE):
            fail(f"m={m}: rel_error {rep.rel_error} not finite or >= {REL_ERROR_GATE}")

    # where the build's time goes (outside the counted runs): scoring, the
    # DIS draw, the host copy of the mass table for the health report
    m = BUDGETS[-1]
    key = rng.fold_in(rng.PRNGKey(args.seed), m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, dis_key = vrlr_scores(key, ds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plan = dis_plan_full(dis_key, scores, m)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    health_from_masses(scores.cpu().numpy())
    t3 = time.perf_counter()
    if not torch.equal(plan.indices, results[m][0].indices):
        fail(f"m={m}: rerunning the build's stages drew another coreset")
    log(f"breakdown m={m}: score_s={t1 - t0:.4f} dis_s={t2 - t1:.4f} "
        f"health_s={t3 - t2:.4f}")

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

    # ---- 5. records -----------------------------------------------------------
    record = {"kernels": [
        {"name": "leverage", "route": "cuda",
         "source": "src/repro_torch/csrc/leverage.cu",
         "replaces": "src/repro/kernels/leverage.py:59",
         "launches": launches["leverage"], "max_abs_err": lev_err,
         "ms": lev_ms, "plain_ms": lev_plain, "bound_ms": lev_bound,
         "bound_by": lev_by, "library_ms": lev_lib},
        {"name": "weighted_gram", "route": "cuda",
         "source": "src/repro_torch/csrc/weighted_gram.cu",
         "replaces": "src/repro/kernels/weighted_gram.py:67",
         "launches": launches["weighted_gram"], "max_abs_err": gram_err,
         "ms": wg_ms, "plain_ms": wg_plain, "bound_ms": wg_bound,
         "bound_by": wg_by, "library_ms": wg_lib},
    ]}
    print(json.dumps(record))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
