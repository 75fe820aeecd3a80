"""Vertical k-means clustering (Definition 2.2): solvers and baselines
(port of :mod:`repro.core.vkmc`).

  * ``kmeans_plusplus``  — D^2 seeding (Arthur & Vassilvitskii), weighted,
    with the reference's key choreography and bit-exact draws
    (:mod:`repro_torch.rng`);
  * ``lloyd``            — weighted Lloyd; each iteration is ONE
    ``kmeans_assign_update`` launch, over the party stack when X carries a
    leading batch axis;
  * ``kmeans``           — seeding + Lloyd, the paper's KMEANS++ baseline;
  * ``distdim``          — Ding et al. "k-means with distributed
    dimensions", the O(nT)-communication VFL baseline;
  * ``kmeans_cost``      — cost^C over the ``kmeans_assign`` kernel.

All solvers take optional per-point weights so they run unchanged on (S, w)
coresets.  Keys move to the data's device before they are used.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import rng
from repro_torch.core.comm import CommLedger, null_ledger
from repro_torch.core.sensitivity import kmeans_assignment, kmeans_update
from repro_torch.core.vfl import VFLDataset
from repro_torch.kernels import ops as kops


def kmeans_cost(X: torch.Tensor, centers: torch.Tensor,
                w: Optional[torch.Tensor] = None,
                use_kernel: bool = True) -> torch.Tensor:
    _, d2 = kmeans_assignment(X, centers, use_kernel=use_kernel)
    return torch.sum(d2 if w is None else w * d2)


def kmeans_plusplus(key: rng.Key, X: torch.Tensor, k: int,
                    w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted D^2 seeding of k centers from the rows of X (n, d).

    Distances use the cached-norm expansion ``||x||^2 - 2 x.c + ||c||^2``,
    clamped at 0, as the reference does.  Each pick is
    ``jax.random.categorical(key, log(p))`` with no shape, which is
    :func:`~repro_torch.kernels.ops.categorical` with ``cap=1``; the
    logits go through the bit-exact :func:`rng.log`.  Key use: one
    ``split`` for the first pick, then ``split(key, k - 1)`` for the
    rest."""
    n, d = X.shape
    key = key.to(X.device)
    ww = (torch.ones((n,), dtype=torch.float32, device=X.device) if w is None
          else torch.clamp_min(w.to(torch.float32), 0.0))
    x2 = torch.sum(X * X, dim=1)

    def d2_to(c):
        return torch.clamp_min(x2 - 2.0 * (X @ c) + torch.sum(c * c), 0.0)

    def row(key_l, logits):
        # the picked row, gathered by a (1,) device index: indexing with a
        # 0-d tensor would read it on the host, which a CUDA graph refuses
        return torch.index_select(X, 0, kops.categorical(key_l, logits, 1))[0]

    k0, key = rng.split(key)
    first = row(k0, rng.log(torch.clamp_min(ww, 1e-30)))
    centers = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    centers[0] = first
    d2 = d2_to(first)
    if k > 1:
        for l, key_l in enumerate(rng.split(key, k - 1), start=1):
            probs = torch.clamp_min(ww * d2, 1e-30)
            c_new = row(key_l, rng.log(probs))
            centers[l] = c_new
            d2 = torch.minimum(d2, d2_to(c_new))
    return centers


def lloyd(X: torch.Tensor, init_centers: torch.Tensor,
          w: Optional[torch.Tensor] = None, iters: int = 25,
          use_kernel: bool = True) -> torch.Tensor:
    """Weighted Lloyd; empty clusters keep their previous center.

    X (..., n, d), init_centers (..., k, d), w (..., n) or None (unit
    weights).  Each iteration is ONE ``kmeans_assign_update`` launch: with
    the (T, n, s) party stack, all T parties at once."""
    centers = init_centers
    for _ in range(iters):
        _, _, csum, wsum, _ = kmeans_update(X, centers, w, use_kernel=use_kernel)
        centers = torch.where(wsum[..., None] > 0,
                              csum / torch.clamp_min(wsum, 1e-30)[..., None],
                              centers)
    return centers


def kmeans(key: rng.Key, X: torch.Tensor, k: int,
           w: Optional[torch.Tensor] = None, iters: int = 25,
           use_kernel: bool = True) -> torch.Tensor:
    """k-means++ seeding + Lloyd — the paper's KMEANS++ central baseline."""
    init = kmeans_plusplus(key, X, k, w)
    return lloyd(X, init, w, iters=iters, use_kernel=use_kernel)


def kmeans_central_comm_cost(n: int, dims, ledger: Optional[CommLedger] = None) -> int:
    """Central baseline ships all raw blocks: sum_j n*d_j units."""
    led = null_ledger(ledger)
    for j, dj in enumerate(dims):
        led.party_to_server("kmeans_central/raw_block", j, n * int(dj))
    return led.total


def distdim(key: rng.Key, ds: VFLDataset, k: int,
            w: Optional[torch.Tensor] = None, local_iters: int = 15,
            global_iters: int = 25, ledger: Optional[CommLedger] = None,
            use_kernel: bool = True) -> torch.Tensor:
    """K-means with distributed dimensions (Ding et al. 2016).

    Party j clusters its block into k local centers and sends its n local
    assignments and its k local centers (n + k d_j units); the server
    replaces each point by the concatenation of its local centers and runs
    weighted k-means on those surrogates.  Returns centers in R^d."""
    led = null_ledger(ledger)
    key = key.to(ds.device)
    n = ds.n
    surrogate_parts: List[torch.Tensor] = []
    for j, Xj in enumerate(ds.parts):
        key, sub = rng.split(key)
        local_c = kmeans(sub, Xj, k, w, iters=local_iters, use_kernel=use_kernel)
        assign, _ = kmeans_assignment(Xj, local_c, use_kernel=use_kernel)
        surrogate_parts.append(local_c[assign.to(torch.int64)])
        led.party_to_server("distdim/assignments", j, n)
        led.party_to_server("distdim/local_centers", j, k * Xj.shape[1])
    surrogate = torch.cat(surrogate_parts, dim=1)
    key, sub = rng.split(key)
    return kmeans(sub, surrogate, k, w, iters=global_iters, use_kernel=use_kernel)
