"""Plain PyTorch versions of the port's kernels — the semantic ground truth.

Each function mirrors :mod:`repro.kernels.ref` in float32, with the same
leading-batch-dim rule: either operand may carry one leading batch axis
(or several, equal on both), and an operand without one is shared across
the batch.  The CPU path of every kernel wrapper runs these; the card
runs them only when a caller asks for ``backend="ref"``, and the kernel
checks compare against them.
"""

from __future__ import annotations

from typing import Optional

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


def kmeans_assign(X: torch.Tensor, C: torch.Tensor):
    """(argmin_l ||x_i - c_l||^2, min_l ||x_i - c_l||^2).

    X: (..., n, d); C: (..., k, d) -> (int32 (..., n), float32 (..., n)).
    As :func:`repro.kernels.ref.kmeans_assign`, the expanded distance
    ``(||x||^2 + ||c||^2) - 2 x.c`` is clamped at 0 BEFORE the argmin (the
    hand kernel, like the Pallas one, takes the argmin of the unclamped
    distance and clamps the minimum; the two differ only where a row has a
    negative expanded distance to two or more centers).  Ties take the
    first index."""
    Xf = X.to(torch.float32)
    Cf = C.to(torch.float32)
    x2 = torch.sum(Xf * Xf, dim=-1, keepdim=True)                 # (..., n, 1)
    c2 = torch.sum(Cf * Cf, dim=-1)[..., None, :]                 # (..., 1, k)
    xc = Xf @ Cf.transpose(-1, -2)                                # (..., n, k)
    d2 = torch.clamp_min(x2 + c2 - 2.0 * xc, 0.0)
    mn, idx = torch.min(d2, dim=-1)
    return idx.to(torch.int32), mn


def segment_sums(X: torch.Tensor, w: Optional[torch.Tensor],
                 assign: torch.Tensor, d2: torch.Tensor, k: int):
    """(csum (..., k, d), wsum (..., k), ccost (..., k)): sum_i w_i x_i,
    sum_i w_i and sum_i w_i d2_i grouped by ``assign`` (..., n), with
    ``w=None`` meaning unit weights — the three segment sums of
    :func:`kmeans_assign_update`, for any given assignment."""
    n, d = X.shape[-2:]
    batch = tuple(assign.shape[:-1])
    ww = (torch.ones((n,), dtype=torch.float32, device=X.device) if w is None
          else w.to(torch.float32)).expand(batch + (n,))
    Xw = (ww[..., None] * X.to(torch.float32)).expand(batch + (n, d))
    idx = assign.to(torch.int64)
    zeros = lambda *s: torch.zeros(batch + s, dtype=torch.float32,
                                   device=X.device)
    csum = zeros(k, d).scatter_add_(-2, idx[..., None].expand(batch + (n, d)), Xw)
    wsum = zeros(k).scatter_add_(-1, idx, ww)
    ccost = zeros(k).scatter_add_(-1, idx, ww * d2.expand(batch + (n,)))
    return csum, wsum, ccost


def kmeans_assign_update(X: torch.Tensor, C: torch.Tensor,
                         w: Optional[torch.Tensor] = None):
    """Assignment followed by three segment sums, grouped by the assigned
    cluster: (assign (..., n) i32, d2 (..., n) f32, csum (..., k, d) =
    sum_i w_i x_i, wsum (..., k) = sum_i w_i, ccost (..., k) = sum_i w_i
    d2_i).  ``w=None`` means unit weights (wsum is the cluster size, ccost
    the cluster cost of Algorithm 3).  X, C and w may each carry the batch
    axis or not, independently."""
    n = X.shape[-2]
    batch = tuple(torch.broadcast_shapes(X.shape[:-2], C.shape[:-2],
                                         () if w is None else w.shape[:-1]))
    assign, d2 = kmeans_assign(X, C)
    assign, d2 = assign.expand(batch + (n,)), d2.expand(batch + (n,))
    return (assign, d2) + segment_sums(X, w, assign, d2, C.shape[-2])
