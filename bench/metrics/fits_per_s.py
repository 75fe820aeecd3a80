"""Fitted coresets returned over the window's seconds: all the work over
all the time of the window (host clock)."""


def read(run):
    return run.fits / run.window_s if run.window_s > 0 and run.fits else None
