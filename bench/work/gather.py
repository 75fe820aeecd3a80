"""Row gathers (a coreset's rows materialized, a center's row picked):
``rows`` rows of ``d`` float32 columns read once and written once."""

from benchlib.yardstick import bound_s


def least_s(rows: int, d: int) -> float:
    return bound_s(8 * rows * d, 0)
