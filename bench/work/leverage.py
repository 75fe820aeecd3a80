"""K1 ``leverage``: the least time of x_i^T M x_i over ``T`` party stacks
of ``n`` rows and ``s`` columns: X, M read once, the scores written once;
2 n (s^2 + s) operations a party."""

from benchlib.yardstick import bound_s


def least_s(T: int, n: int, s: int) -> float:
    return bound_s(4 * (T * n * s + T * s * s + T * n), 2 * T * n * (s * s + s))
