"""One client in a closed loop: it sends its next request when the last
one has returned, until the window's seconds are up.  A user running the
paper's sweep, who waits for each result, sends such traffic."""

from benchlib import traffic


def drive(window, mix: dict, seed: int, seconds: float) -> None:
    """Serve the window's requests through ``window`` (a
    :class:`benchlib.runner.Window`), one after another."""
    gen = traffic.requests(mix, seed, 0)
    while window.elapsed() < seconds:
        window.serve(next(gen))


def warmup(mix: dict, seed: int) -> list:
    """Set-up's requests: one of each shape the window sends."""
    return traffic.warmup(mix, seed)
