"""K2 ``kmeans_assign_update`` (``kernels.kmeans_assign_update``): the
least time of its launches at their shapes (``kmeans_flops`` /
``kmeans_bytes``, the frozen arithmetic) over the device time of its
kernels, in %.  Kernels are attributed by base name."""

PATTERN = r"^kau_"


def read(run):
    t = run.kernel_s(PATTERN)
    if t <= 0:
        return None
    least = sum(run.least_s(r, kernels=("kmeans_assign_update",)) for r in run.traced)
    return 100.0 * least / t
