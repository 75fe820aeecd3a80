"""The whole request: its least time on the chip (every stage of the
build and the fits at the larger of its operation and byte bounds, from
the frozen arithmetic, whatever implements it) over its measured time
(the ``bench.request`` spans of the traced slice), in %."""


def read(run):
    sp = run.request_spans()
    if not sp or not run.on_card:
        return None
    measured = sum(s.end - s.start for s in sp) / 1e6
    least = sum(run.least_s(r) for r in run.traced[:len(sp)])
    return 100.0 * least / measured
