"""Plain PyTorch versions of the port's kernels — the semantic ground truth.

Each function mirrors :mod:`repro.kernels.ref` in float32, with the same
leading-batch-dim rule: either operand may carry one leading batch axis
(or several, equal on both), and an operand without one is shared across
the batch.  The CPU path of every kernel wrapper runs these; the card
runs them only when a caller asks for ``backend="ref"``, and the kernel
checks compare against them.
"""

from __future__ import annotations

import torch


def leverage(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Row-wise quadratic form x_i^T M x_i.  X: (..., n, d); M: (..., d, d)
    -> (..., n) float32."""
    Xf = X.to(torch.float32)
    Mf = M.to(torch.float32)
    return ((Xf @ Mf) * Xf).sum(dim=-1)


def weighted_gram(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^T diag(w) X.  X: (..., n, d); w: (..., n) -> (..., d, d) float32."""
    Xf = X.to(torch.float32)
    Xw = Xf * w.to(torch.float32)[..., :, None]
    return Xw.transpose(-1, -2) @ Xf
