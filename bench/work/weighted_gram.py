"""K3 ``weighted_gram`` (and any Gram X^T diag(w) X, whatever computes
it): one triangle of ``B`` Grams of ``n`` rows and ``d`` columns; X and w
read once, G written once."""

from benchlib.yardstick import bound_s, gram_flops


def least_s(n: int, d: int, B: int = 1) -> float:
    return bound_s(4 * B * (n * d + n + d * d), B * gram_flops(n, d))
