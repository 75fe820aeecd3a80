"""Vertical regularized linear regression (Definition 2.1): objectives and
solvers (port of :mod:`repro.core.vrlr`).

  * ``ridge_closed_form`` — the weighted normal equations, the Gram built
    by the ``weighted_gram`` kernel; ``X^T (w y)`` and the solve stay plain
    torch in full fp32, as the reference leaves them to XLA;
  * ``fista`` — proximal gradient for lasso / elastic net (appendix A.2);
    its products are plain ``torch.matmul``, as the reference's are XLA's;
  * ``saga_ridge`` — SAGA run "in a VFL fashion", 2T units a step on the
    ledger.

All solvers take per-row weights, so they run unchanged on (S, w)
coresets (Theorem 2.5).  The iterations are eager Python loops of a few
launches each, in the reference's order of operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
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


def lasso_cost(X, y, theta, lam: float, w=None) -> torch.Tensor:
    return sq_loss(X, y, theta, w) + lam * torch.sum(torch.abs(theta))


def elastic_cost(X, y, theta, lam1: float, lam2: float, w=None) -> torch.Tensor:
    return (sq_loss(X, y, theta, w) + lam1 * torch.sum(torch.abs(theta))
            + lam2 * torch.sum(theta * theta))


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


def _soft(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def fista(
    X: torch.Tensor, y: torch.Tensor, lam1: float, lam2: float = 0.0,
    w: Optional[torch.Tensor] = None, iters: int = 500,
) -> torch.Tensor:
    """Proximal-gradient solve of weighted lasso/elastic net.

    min_theta sum w_i (x_i^T theta - y_i)^2 + lam1 |theta|_1 + lam2 |theta|_2^2

    The step size 1/L and the momentum schedule are scalars the host
    computes once in float32, as the reference's traced scalars are.
    """
    n, d = X.shape
    ww = torch.ones((n,), dtype=torch.float32, device=X.device) if w is None else w
    Xw = X * ww[:, None]
    # Lipschitz constant of the smooth part: 2*(sigma_max(X^T W X) + lam2)
    G = Xw.T @ X
    L = np.float32(float(2.0 * (torch.linalg.matrix_norm(G, ord=2) + lam2) + 1e-6))
    b = Xw.T @ y
    step, thresh = float(L), float(np.float32(lam1) / L)
    theta = torch.zeros((d,), dtype=torch.float32, device=X.device)
    z, t = theta, np.float32(1.0)
    for _ in range(iters):
        grad = 2.0 * (G @ z - b + lam2 * z)
        theta_new = _soft(z - grad / step, thresh)
        t_new = np.float32(0.5) * (np.float32(1.0)
                                   + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        z = theta_new + float((t - np.float32(1.0)) / t_new) * (theta_new - theta)
        theta, t = theta_new, t_new
    return theta


def saga_ridge(
    key: rng.Key,
    X: torch.Tensor,
    y: torch.Tensor,
    lam: float,
    w: Optional[torch.Tensor] = None,
    steps: int = 20000,
    lr: Optional[float] = None,
    dims: Optional[Tuple[int, ...]] = None,
    ledger: Optional[CommLedger] = None,
) -> torch.Tensor:
    """SAGA on the (weighted) ridge objective, with VFL comm accounting.

    Per step on row i: every party j sends the scalar partial inner product
    x_i^(j).theta^(j) to the server (T units), the server returns the shared
    residual scalar to every party (T units) -> 2T units/step.  Parameter
    updates stay party-local.

    The row stream is the reference's exactly: ``split(key, steps)`` and one
    scalar ``randint`` per subkey, drawn at once and copied to the host
    once.  Each step is then a handful of eager launches.
    """
    n, d = X.shape
    ww = torch.ones((n,), dtype=torch.float32, device=X.device) if w is None else w
    lam_n = lam / n
    if lr is None:
        # 1/(3 * max_i L_i): per-sample smoothness of f_i = w_i(x'th-y)^2 + lam/n |th|^2
        L = 2.0 * torch.max(ww * torch.sum(X * X, dim=1)) + 2.0 * lam_n
        lr = float(1.0 / (3.0 * torch.clamp_min(L, 1e-9)))
    rows = rng.randint_each(rng.split(key.to(X.device), steps), 0, n).tolist()
    theta = torch.zeros((d,), dtype=torch.float32, device=X.device)
    table = torch.zeros((n, d), dtype=torch.float32, device=X.device)  # per-row gradients
    avg = torch.zeros((d,), dtype=torch.float32, device=X.device)
    for i in rows:
        xi = X[i]
        r = xi @ theta - y[i]
        g_new = 2.0 * ww[i] * r * xi + 2.0 * lam_n * theta
        diff = g_new - table[i]            # table[i] is still g_old here
        theta = theta - lr * (diff + avg)
        avg = avg + diff / n
        table[i] = g_new
    if ledger is not None:
        T = len(dims) if dims is not None else 1
        ledger.party_to_server("saga/partials", 0, steps * T)
        ledger.server_to_party("saga/residuals", 0, steps * T)
    return theta


def solve(
    kind: str,
    X: torch.Tensor,
    y: torch.Tensor,
    w: Optional[torch.Tensor] = None,
    *,
    lam: float = 0.0,
    lam1: float = 0.0,
    lam2: float = 0.0,
    key: Optional[rng.Key] = None,
    saga_steps: int = 20000,
    saga_lr: float = 1e-3,
) -> torch.Tensor:
    """Uniform solver entry point used by benchmarks."""
    if kind == "ridge":
        return ridge_closed_form(X, y, lam, w)
    if kind == "linear":
        return ridge_closed_form(X, y, 1e-6, w)  # tiny jitter for conditioning
    if kind == "lasso":
        return fista(X, y, lam1, 0.0, w)
    if kind == "elastic":
        return fista(X, y, lam1, lam2, w)
    if kind == "saga":
        if key is None:
            raise ValueError("solve('saga') needs a key for its row stream")
        return saga_ridge(key, X, y, lam, w, steps=saga_steps, lr=saga_lr)
    raise ValueError(f"unknown solver {kind!r}")
