"""K4 ``kmeans_assign``: the least time of one assignment sweep (the
k-means cost) of ``n`` rows, ``d`` columns, ``k`` centers, ``w_rows``
weights read."""

from benchlib.yardstick import bound_s, kmeans_bytes, kmeans_flops


def least_s(n: int, k: int, d: int, w_rows: int = 0) -> float:
    return bound_s(kmeans_bytes(1, n, k, d, False, w_rows, False),
                   kmeans_flops(n, k, d, False))
