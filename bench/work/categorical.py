"""K5 ``categorical``: the least time of gumbel-max draws.

A draw of ``rows`` rows over ``n`` candidates costs ``rows * n``
candidates of the frozen per-candidate operations, and reads its ``T``
rows of float32 logits once and writes its int64 rows once."""

from benchlib.yardstick import categorical_bound_s


def least_s(rows: int, n: int, streams: int = 1) -> float:
    return categorical_bound_s(rows * n, 4 * streams * n + 8 * rows)
