"""Reading a ``torch.profiler`` trace: device events, busy time, the op
census, the benchmark's own spans and the breakdown.

``kernel_base_name``, ``Event``, ``events``, ``op_census`` and
``device_busy_us`` are frozen copies of the port's
``repro_torch/launch/trace.py`` (the busy time is the union of the device
events' intervals), kept here so the yardstick does not move with the
program.  The spans are the benchmark's ``record_function`` annotations
(``bench.*``), which share the trace's clock with the device events.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."


def kernel_base_name(name: str) -> str:
    """A device kernel's identifier, without its namespaces, template
    arguments and parameters: ``void (anonymous
    namespace)::kau_partial_kernel<4>(float const*, ...)`` ->
    ``kau_partial_kernel``."""
    name = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


class Event:
    """One event of a trace: ``name``, ``start`` / ``end`` in microseconds,
    and whether it ran on the device."""

    __slots__ = ("name", "start", "end", "on_device")

    def __init__(self, name, start, end, on_device):
        self.name, self.start, self.end, self.on_device = name, start, end, on_device


def events(prof) -> List[Event]:
    """The trace's events in start order, from the profiler's kineto
    records; the device's user annotations are left out (they are spans,
    not work)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), start, start + e.duration_ns() / 1e3, on_device))
    return sorted(out, key=lambda e: e.start)


def op_census(evs: List[Event], lo: float, hi: float) -> Dict[str, Dict[str, float]]:
    """Device kernels (and copies) that start in [lo, hi), by name:
    ``{name: {"count", "device_us"}}``, the most device time first."""
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "device_us": 0.0})
    for e in device_events(evs, lo, hi):
        out[e.name]["count"] += 1
        out[e.name]["device_us"] += e.end - e.start
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_us"]))


def device_events(evs: List[Event], lo: float, hi: float) -> List[Event]:
    return [e for e in evs if e.on_device and lo <= e.start < hi]


def device_busy_us(evs: List[Event], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi) in which at least one device event ran:
    the union of the device events' intervals, clipped to the slice."""
    busy, end = 0.0, lo
    for e in evs:
        if not e.on_device or e.end <= end or e.start >= hi:
            continue
        busy += min(e.end, hi) - max(e.start, end)
        end = min(e.end, hi)
    return busy


def spans(evs: List[Event], name: Optional[str] = None) -> List[Event]:
    """The benchmark's host spans (``bench.<name>``), in start order."""
    want = None if name is None else SPAN_PREFIX + name
    return [e for e in evs if not e.on_device and e.name.startswith(SPAN_PREFIX)
            and (want is None or e.name == want)]


def idle_gaps(evs: List[Event], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi) in which no device event ran."""
    gaps, end = [], lo
    for e in evs:
        if not e.on_device or e.end <= end or e.start >= hi:
            continue
        if e.start > end:
            gaps.append((end, e.start))
        end = min(e.end, hi)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def _innermost(span_list: List[Event], t: float) -> str:
    best = None
    for s in span_list:
        if s.start <= t < s.end and (best is None or s.start >= best.start):
            best = s
    return "no span" if best is None else best.name[len(SPAN_PREFIX):]


def breakdown(evs: List[Event], lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps, each named by the benchmark span open at its
    middle: ``{"device_ops": [[name, s]], "idle_gaps": [[span, s]]}``."""
    census = op_census(evs, lo, hi)
    by_base: Dict[str, float] = defaultdict(float)
    for name, v in census.items():
        by_base[kernel_base_name(name)] += v["device_us"]
    ops = sorted(by_base.items(), key=lambda kv: -kv[1])[:top]
    sp = spans(evs)
    gaps = sorted(idle_gaps(evs, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[_innermost(sp, (a + b) / 2), (b - a) / 1e6] for a, b in gaps]}
