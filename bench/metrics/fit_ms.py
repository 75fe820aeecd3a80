"""The solve (``core.solve.fit_ridge`` / ``fit_kmeans``): the mean of the
benchmark's ``bench.fit`` span per fitted coreset of the traced slice; the
span ends with the parameters on the host."""


def read(run):
    from benchlib import tracing

    sp = [s for s in tracing.spans(run.events, "fit") if run.lo <= s.start < run.hi]
    return sum(s.end - s.start for s in sp) / len(sp) / 1e3 if sp else None
