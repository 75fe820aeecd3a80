"""The 95th percentile of every request of the window, from its start to
its fitted parameters on the host (host clock; linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) if run.latencies else None
