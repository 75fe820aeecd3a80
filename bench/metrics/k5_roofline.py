"""K5 ``categorical`` (``kernels.categorical``): its least time for the
candidates the traced requests need (round 1 T m, round 2 m n a cell,
each k-means++ pick n), from the frozen operation rates, over the device
time of its kernels, in %.  Kernels are attributed by base name."""

PATTERN = r"^categorical_"


def read(run):
    t = run.kernel_s(PATTERN)
    if t <= 0:
        return None
    least = sum(run.least_s(r, kernels=("categorical",)) for r in run.traced)
    return 100.0 * least / t
