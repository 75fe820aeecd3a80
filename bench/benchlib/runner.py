"""One run of one cell: set-up, the measured window, the traced slice, the
metrics, the check, and the result line.

:func:`run_cell` does everything after the look for a chip, on any
device, so that the CPU tests can drive a whole run at a tiny size;
``bench/run.py`` looks for the chip first and prints the result.  The
cell's loop (``bench/loops/<loop>.py``) decides when each request of the
window is sent; a :class:`Window` serves, times and traces it.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
import traceback
from typing import List, Optional, Tuple

import torch

from benchlib import check, tracing, traffic
from benchlib.manifest import Cell

#: the traced slice of a ``--trace 1`` run: it starts at the first request
#: sent this many seconds into the window, and closes after the request
#: that ends this many seconds after the profiler started
TRACE_SLICE = (2.0, 8.0)


class Run:
    """What the metric readers read: the window's requests and clocks, the
    set-up time, the device peak and, in a traced run, the trace slice."""

    def __init__(self, cell: Cell, device: torch.device):
        self.cell, self.device = cell, device
        self.config, self.mix = cell.config, cell.mix
        self.latencies: List[float] = []   # seconds, every request of the window
        self.fits = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_bytes: Optional[int] = None
        # the traced slice (``--trace 1``)
        self.events: List[tracing.Event] = []
        self.lo = self.hi = 0.0            # microseconds on the trace's clock
        self.traced: List[traffic.Request] = []

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    # -- helpers for the trace readers -----------------------------------
    def request_spans(self) -> List[tracing.Event]:
        return [s for s in tracing.spans(self.events, "request")
                if s.start >= self.lo and s.end <= self.hi]

    def traced_fits(self) -> int:
        return sum(len(r.ms) for r in self.traced)

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the slice's kernels whose base name matches
        ``pattern`` (a regular expression, searched)."""
        import re

        rx = re.compile(pattern)
        return sum(e.end - e.start for e in tracing.device_events(self.events, self.lo, self.hi)
                   if rx.search(tracing.kernel_base_name(e.name))) / 1e6

    def least_s(self, req: traffic.Request, kernels=None) -> float:
        """The request's least seconds on the chip from the work counts of
        its stages (``bench/work/task_<task>.py``, ``fit_<kind>.py``),
        restricted to ``kernels`` when given."""
        total = 0.0
        for name in (f"task_{self.config['task']}", f"fit_{self.config['fit']['kind']}"):
            for kernel, least in self.cell.work(name).stages(self.cell, req):
                if kernels is None or kernel in kernels:
                    total += least
        return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The measured window: the loop hands it each request through
    :meth:`serve`, which times it on the host clock from ``arrived`` (the
    moment the loop sent it; by default now) to its parameters on the
    host, records what it returned for the check, and opens and closes the
    profiler's slice in a traced run."""

    def __init__(self, run: "Run", prog, trace: bool, slice_s: Tuple[float, float]):
        self.run, self.prog, self.trace = run, prog, trace
        self.skip_s, self.length_s = slice_s
        self.done: list = []               # [(Request, [Fitted])] for the check
        self.failed = 0
        self.prof = None
        self.traced_from = 0.0
        if run.on_card:
            torch.cuda.reset_peak_memory_stats(run.device)
        self.start = self.last = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds from the window's start to the last request's end."""
        return self.last - self.start

    def _open_slice(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.run.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.traced_from = time.perf_counter()   # starting the profiler takes seconds

    def _close_slice(self):
        _sync(self.run.device)
        self.prof.__exit__(None, None, None)
        self.run.events = tracing.events(self.prof)
        self.prof = None

    def serve(self, req: traffic.Request, arrived: Optional[float] = None) -> None:
        run = self.run
        if (self.trace and self.prof is None and not run.traced
                and self.elapsed() >= self.skip_s):
            self._open_slice()
        t = time.perf_counter() if arrived is None else arrived
        try:
            span = (torch.profiler.record_function("bench.request") if self.prof is not None
                    else contextlib.nullcontext())
            with span:
                served = self.prog.serve(req)
        except Exception:                    # a failed request is counted, not fatal
            traceback.print_exc()
            self.failed += 1
            self.last = time.perf_counter()
            return
        self.last = time.perf_counter()
        run.latencies.append(self.last - t)
        run.fits += len(served)
        if self.prof is not None:
            run.traced.append(req)
            if self.last - self.traced_from >= self.length_s:
                self._close_slice()
        self.done.append((req, self.prog.cells(served)))

    def close(self) -> None:
        run = self.run
        run.window_s = self.elapsed()
        if self.prof is not None:            # the window closed inside the slice
            self._close_slice()
        if run.on_card:
            run.peak_bytes = int(torch.cuda.max_memory_allocated(run.device))
        if run.events:
            req_spans = tracing.spans(run.events, "request")
            if req_spans:
                run.lo, run.hi = req_spans[0].start, req_spans[-1].end


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             slice_s: Tuple[float, float] = TRACE_SLICE) -> dict:
    """Set up, measure, read, check.  ``t0`` is the process's start on
    the host clock (set-up counts from it).  Returns the result's fields
    and the compared numbers."""
    cfg = cell.config
    mix = cell.engine.validate(cell.mix)
    run = Run(cell, device)
    inputs = cell.inputs.make(cfg, seed, device)
    prog = cell.engine.setup(cfg, mix, inputs, traced=trace)
    for req in cell.loop.warmup(mix, seed):
        prog.serve(req)
    _sync(device)
    run.setup_s = time.perf_counter() - t0

    window = Window(run, prog, trace, slice_s)
    cell.loop.drive(window, mix, seed, seconds)
    window.close()

    metrics_list = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_list:
        v = cell.readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    done, failed = window.done, window.failed
    out = {"attempted": len(done) + failed, "failed": failed, "metrics": metrics,
           "peak_bytes": run.peak_bytes}
    if trace and run.events and run.hi > run.lo:
        out["busy_s"] = tracing.device_busy_us(run.events, run.lo, run.hi) / 1e6
        out["window_s"] = (run.hi - run.lo) / 1e6
        out["breakdown"] = tracing.breakdown(run.events, run.lo, run.hi)

    del prog, run, window
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.judge.judge(cfg, inputs, done, seed, failed)
    limits = check.limits_of(cfg)
    out["correct"] = bool(done) and check.verdict(numbers, limits)
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def check_lines(checks: dict) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}" for k, v in checks.items()]


def finite(x):
    """A JSON-safe number: NaN and infinities as strings."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def result_line(out: dict, device: dict) -> dict:
    """The result's JSON object, in the contract's key order; the compared
    numbers come last."""
    res = {"correct": out["correct"], "attempted": out["attempted"],
           "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        res["breakdown"] = out["breakdown"]
    res["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in out["checks"].items()}
    return res


def forbidden_modules(modules=None) -> List[str]:
    """JAX, its libraries and the JAX package among ``modules`` (default
    ``sys.modules``), by whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & banned)
