"""The fused engine (``core.api.build_coreset_jit``): the mean of the
benchmark's ``bench.build`` span, which ends in a synchronise, per request
of the traced slice."""


def read(run):
    if run.mix["engine"] != "fused":
        return None
    from benchlib import tracing

    sp = [s for s in tracing.spans(run.events, "build") if run.lo <= s.start < run.hi]
    return sum(s.end - s.start for s in sp) / len(sp) / 1e3 if sp else None
