"""The device: the share of the traced slice in which no device operation
ran, 100 (1 - busy / slice), busy the union of the device intervals."""


def read(run):
    from benchlib import tracing

    span = run.hi - run.lo
    busy = tracing.device_busy_us(run.events, run.lo, run.hi)
    return 100.0 * (1.0 - busy / span) if span > 0 and busy > 0 else None
