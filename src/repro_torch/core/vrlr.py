"""Vertical regularized linear regression (Definition 2.1): objectives and
the closed-form ridge solver (port of :mod:`repro.core.vrlr`).

``ridge_closed_form`` builds the weighted normal equations with the
``weighted_gram`` kernel; ``X^T (w y)`` and the solve stay plain torch in
full fp32, as the reference leaves them to XLA.  FISTA and SAGA wait for a
later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comm import CommLedger, null_ledger
from repro_torch.kernels import ops as kops


def sq_loss(X: torch.Tensor, y: torch.Tensor, theta: torch.Tensor,
            w: Optional[torch.Tensor] = None) -> torch.Tensor:
    r = X @ theta - y
    if w is None:
        return torch.sum(r * r)
    return torch.sum(w * r * r)


def ridge_cost(X, y, theta, lam: float, w=None) -> torch.Tensor:
    """cost^R with R(theta) = lam * ||theta||^2."""
    return sq_loss(X, y, theta, w) + lam * torch.sum(theta * theta)


def ridge_closed_form(
    X: torch.Tensor, y: torch.Tensor, lam: float,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """argmin_theta sum_i w_i (x_i^T theta - y_i)^2 + lam ||theta||^2."""
    n, d = X.shape
    ww = torch.ones((n,), dtype=torch.float32, device=X.device) if w is None else w
    G = kops.weighted_gram(X, ww) + lam * torch.eye(d, dtype=torch.float32,
                                                    device=X.device)
    b = X.T @ (ww * y)
    return torch.linalg.solve(G, b.to(torch.float32))


def central_comm_cost(n: int, dims, ledger: Optional[CommLedger] = None) -> int:
    """CENTRAL transfers every party's raw block to the server: n * d_j each
    (plus labels already at the server's side party).  Matches Table 1's
    4.2e7 for (n=463715, d=90)."""
    led = null_ledger(ledger)
    for j, dj in enumerate(dims):
        led.party_to_server("central/raw_block", j, n * int(dj))
    return led.total
