"""Party-local sensitivity scores — Algorithms 2 (VRLR) and 3 (VKMC) of
:mod:`repro.core.sensitivity`, over torch tensors.

Everything here is computed from ONE party's block ``X^(j)`` only (or the
party-batched stack of them); the cross-party combination happens inside
DIS (Algorithm 1).  The Gram products and ``eigh`` stay plain torch in
full fp32, as the reference leaves them to XLA; the O(n s^2) row sweep is
the ``leverage`` kernel.  The k-means half runs on the ``kmeans_assign``
and ``kmeans_assign_update`` kernels; every function there also takes the
(T, n, s) party stack, with the party axis folded into one launch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops


def _pinv_from_eigh(evals: torch.Tensor, evecs: torch.Tensor, rcond: float):
    """(M, keep, top): the eigen-pseudo-inverse of a batch of symmetric
    Grams from their ``eigh``, with eigenvalues at or below
    ``rcond * max(top eigenvalue, 0)`` dropped."""
    top = torch.clamp_min(evals.max(dim=-1).values, 0.0)
    keep = evals > (rcond * top)[..., None]
    inv = torch.where(keep, 1.0 / torch.clamp_min(evals, 1e-30),
                      torch.zeros_like(evals))
    M = (evecs * inv[..., None, :]) @ evecs.transpose(-1, -2)
    return M, keep, top


def leverage_scores(Xj: torch.Tensor, rcond: float = 1e-6,
                    use_kernel: bool = True) -> torch.Tensor:
    """Row leverage scores ||u_i^(j)||^2 of the orthonormal basis of
    col(X^(j)), computed Gram-side: lev_i = x_i^T (X^T X)^+ x_i, clipped to
    [0, 1].  Handles rank deficiency via the eigen-pseudo-inverse."""
    Xj = Xj.to(torch.float32)
    evals, evecs = torch.linalg.eigh(Xj.T @ Xj)
    M, _, _ = _pinv_from_eigh(evals, evecs, rcond)
    return torch.clamp(kops.leverage(Xj, M, use_kernel), 0.0, 1.0)


def ridge_leverage_scores(X: torch.Tensor, ridge: float = 1e-4,
                          use_kernel: bool = False) -> torch.Tensor:
    """Regularised leverage x_i^T (X^T X + ridge*I)^{-1} x_i in float32,
    clipped to [0, 1] — the selector's per-shard scores.

    ``use_kernel=False`` (the reference's default) is the plain row-wise
    quadratic form; ``use_kernel=True`` is the ``leverage`` kernel, which at
    a width past 238 launches its tiled product and fold."""
    f32 = X.to(torch.float32)
    dl = f32.shape[-1]
    G = f32.T @ f32 + ridge * torch.eye(dl, dtype=torch.float32, device=f32.device)
    M = torch.linalg.inv(G)
    return torch.clamp(kops.leverage(f32, M, use_kernel), 0.0, 1.0)


def norm_scores(X: torch.Tensor) -> torch.Tensor:
    """Plain row-norm^2 — the cheap ablation backend (``norm``)."""
    f32 = X.to(torch.float32)
    return torch.sum(f32 * f32, dim=-1)


def vrlr_local_scores(Xj: torch.Tensor, y: Optional[torch.Tensor] = None,
                      use_kernel: bool = True) -> torch.Tensor:
    """Algorithm 2 lines 2-3: g_i^(j) = ||u_i^(j)||^2 + 1/n.

    Party T passes its labels: the basis is taken over [X^(T), y].
    """
    if y is not None:
        Xj = torch.cat([Xj, y[:, None].to(Xj.dtype)], dim=1)
    return leverage_scores(Xj, use_kernel=use_kernel) + 1.0 / Xj.shape[0]


def batched_gram_pinv(G: torch.Tensor, rcond: float = 1e-6,
                      return_cond: bool = False, expected_rank=None):
    """Eigen-pseudo-inverse of a (T, s, s) stack of party Grams.

    Zero padding contributes zero eigenvalues that fall below the rcond
    cutoff, so the batched pinv equals the per-party one embedded.
    ``return_cond=True`` additionally returns the (T,) retained condition
    numbers (top eigenvalue over the smallest eigenvalue clearing the
    cutoff; +inf when nothing clears it).  A party whose retained rank
    falls short of ``expected_rank`` (its valid width) — a constant or
    duplicated feature slice — reports +inf.  The pinv is the same either
    way.
    """
    evals, evecs = torch.linalg.eigh(G)
    M, keep, top = _pinv_from_eigh(evals, evecs, rcond)
    if not return_cond:
        return M
    inf = torch.full_like(evals, float("inf"))
    small = torch.where(keep, evals, inf).min(dim=-1).values
    cond = torch.where(torch.isfinite(small) & (small > 0.0),
                       top / torch.clamp_min(small, 1e-30),
                       torch.full_like(top, float("inf")))
    if expected_rank is not None:
        rank = keep.sum(dim=-1)
        expected = torch.as_tensor(expected_rank, device=rank.device)
        cond = torch.where(rank < expected, torch.full_like(cond, float("inf")),
                           cond)
    return M, cond


def vrlr_scores_stacked(blocks: torch.Tensor, rcond: float = 1e-6,
                        use_kernel: bool = True) -> torch.Tensor:
    """Algorithm 2 lines 2-3 for ALL parties at once.

    ``blocks`` is the (T, n, s) zero-padded stack from
    :meth:`repro_torch.core.vfl.VFLDataset.stacked` (labels already
    appended to party T's block).  Returns (T, n) scores.  The O(T n s^2)
    row sweep is ONE party-batched ``leverage`` kernel launch.
    """
    f, M = vrlr_pinv_stacked(blocks, rcond)
    return vrlr_leverage_stacked(f, M, use_kernel)


def vrlr_pinv_stacked(blocks: torch.Tensor, rcond: float = 1e-6):
    """The first half of :func:`vrlr_scores_stacked`: ``(f, M)``, the
    float32 stack and the pseudo-inverses of its batched Gram.  ``eigh``
    on the card reads its error flag on the host, so the fused engine runs
    this half eagerly."""
    f = blocks.to(torch.float32)
    G = f.transpose(1, 2) @ f                              # (T, s, s)
    return f, batched_gram_pinv(G, rcond)


def vrlr_leverage_stacked(f: torch.Tensor, M: torch.Tensor,
                          use_kernel: bool = True) -> torch.Tensor:
    """The second half of :func:`vrlr_scores_stacked`: the leverage sweep
    over ``(f, M)``, clipped to [0, 1], plus 1/n."""
    lev = kops.leverage(f, M, use_kernel)                  # (T, n)
    return torch.clamp(lev, 0.0, 1.0) + 1.0 / f.shape[1]


# --------------------------------------------------------------------------
# Algorithm 3: VKMC local sensitivities
# --------------------------------------------------------------------------

def kmeans_assignment(Xj: torch.Tensor, centers: torch.Tensor,
                      use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmin_l d(x_i, c_l), min_l d(x_i, c_l)^2) as (int32, float32) —
    the O(nkd) sweep, served by the ``kmeans_assign`` kernel.  The plain
    branch keeps the reference's inline formula and order:
    ``(||x||^2 - 2 X C^T) + ||c||^2``, clamped at 0, then the argmin."""
    if use_kernel:
        return kops.kmeans_assign(Xj, centers)
    d2 = (torch.sum(Xj * Xj, dim=-1, keepdim=True)
          - 2.0 * Xj @ centers.transpose(-1, -2)
          + torch.sum(centers * centers, dim=-1)[..., None, :])
    mn, idx = torch.min(torch.clamp_min(d2, 0.0), dim=-1)
    return idx.to(torch.int32), mn


def kmeans_update(Xj: torch.Tensor, centers: torch.Tensor,
                  w: Optional[torch.Tensor] = None, use_kernel: bool = True):
    """One fused Lloyd read: (assign, d2, csum, wsum, ccost).

    An alias of ``kernels.ops.kmeans_assign_update``, kept under the
    reference's name for ``lloyd`` and ``vkmc_local_scores``.
    ``use_kernel=True`` is the single-pass ``kmeans_assign_update`` kernel;
    ``use_kernel=False`` the plain assignment + segment-sum composition."""
    return kops.kmeans_assign_update(Xj, centers, w, use_kernel)


def vkmc_local_scores(Xj: torch.Tensor, centers: torch.Tensor, alpha: float,
                      use_kernel: bool = True) -> torch.Tensor:
    """Algorithm 3 lines 3-11 for one party, or for the (T, n, s) party
    stack with (T, k, s) centers in one launch.

    g_i^(j) = alpha*d(x_i, c_pi(i))^2 / cost
            + alpha * (sum_{i' in B_pi(i)} d(x_i', c_pi(i'))^2) / (|B_pi(i)| * cost)
            + 2*alpha / |B_pi(i)|

    Cluster sizes and costs come out of the same fused pass that computes
    the assignment (unit weights: wsum = |B_l|, ccost = cost_l).
    """
    assign, d2, _, cluster_size, cluster_cost = kmeans_update(
        Xj, centers, use_kernel=use_kernel)
    cost = torch.clamp_min(d2.sum(dim=-1, keepdim=True), 1e-30)
    cluster_size = torch.clamp_min(cluster_size, 1.0)
    idx = assign.to(torch.int64)
    size_i = torch.gather(cluster_size, -1, idx)
    term1 = alpha * d2 / cost
    term2 = alpha * torch.gather(cluster_cost, -1, idx) / (size_i * cost)
    term3 = 2.0 * alpha / size_i
    return term1 + term2 + term3


def total_sensitivity_bound_vrlr(dims, T: int) -> float:
    """Thm 4.2: G = sum_j d'_j + T <= d + T + 1 (used by tests)."""
    return float(sum(dims) + T)


def total_sensitivity_bound_vkmc(k: int, T: int, alpha: float) -> float:
    """Lemma F.2: G = 2(k+1) * alpha * T exactly when no local cluster is
    empty (each party's scores sum to 2(k+1) alpha)."""
    return 2.0 * (k + 1) * alpha * T
