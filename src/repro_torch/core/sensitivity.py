"""Party-local sensitivity scores — the Algorithm 2 (VRLR) half of
:mod:`repro.core.sensitivity`, over torch tensors.

Everything here is computed from ONE party's block ``X^(j)`` only (or the
party-batched stack of them); the cross-party combination happens inside
DIS (Algorithm 1).  The Gram products and ``eigh`` stay plain torch in
full fp32, as the reference leaves them to XLA; the O(n s^2) row sweep is
the ``leverage`` kernel.  The Algorithm 3 (VKMC) half waits for the
k-means kernels.
"""

from __future__ import annotations

from typing import Optional

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
    f = blocks.to(torch.float32)
    n = f.shape[1]
    G = f.transpose(1, 2) @ f                              # (T, s, s)
    M = batched_gram_pinv(G, rcond)
    lev = kops.leverage(f, M, use_kernel)                  # (T, n)
    return torch.clamp(lev, 0.0, 1.0) + 1.0 / n

