"""Host dispatch: device operations (kernels, copies, sets) the profiler
records in the traced slice, per fitted coreset."""


def read(run):
    from benchlib import tracing

    fits = run.traced_fits()
    ops = len(tracing.device_events(run.events, run.lo, run.hi))
    return ops / fits if fits and ops else None
