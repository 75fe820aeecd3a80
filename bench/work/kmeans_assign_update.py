"""K2 ``kmeans_assign_update``: the least time of one fused assignment
and update sweep of ``B`` batches of ``n`` rows, ``d`` columns, ``k``
centers (per batch when ``c_batched``), with ``w_rows`` weights read."""

from benchlib.yardstick import bound_s, kmeans_bytes, kmeans_flops


def least_s(B: int, n: int, k: int, d: int, c_batched: bool, w_rows: int) -> float:
    return bound_s(kmeans_bytes(B, n, k, d, c_batched, w_rows, True),
                   B * kmeans_flops(n, k, d, True))
