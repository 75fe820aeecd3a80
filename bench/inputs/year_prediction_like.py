"""The benchmark's inputs: a YearPredictionMSD-profile dataset made on the
device from the run's seed.

The recipe is the latent-block one of the port's ``year_prediction_like``
(12 latent factors through random loadings, noise 0.4, a Pareto-ish row
scale with exponent 0.4; labels 1998 + 8 x.theta + 1.5 tanh(x_0) + 3
noise), written here in plain torch with a ``torch.Generator`` on the
device, so the same seed gives the same inputs and nothing of the program
makes them.  A configuration may center the labels (the paper's sweep
does: ``benchmarks/common.py``'s ``make_vrlr_data``) and standardize the
columns (its k-means sweep does).  A configuration names this file by
its ``data.recipe``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def make(cfg: dict, seed: int, device: torch.device
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(X (n, d) float32, y (n,) float32 or None) for ``cfg``'s ``data``."""
    n, d = int(cfg["n"]), int(cfg["d"])
    g = cfg["data"]
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)

    L = int(g["n_latent"])
    X = normal(n, L) @ (normal(L, d) / math.sqrt(L))
    X += float(g["noise"]) * normal(n, d)
    u = torch.rand(n, 1, generator=gen, device=device) * (1.0 - 1e-3) + 1e-3
    X *= 1.0 + 0.1 * u ** (-float(g["heavy_tail"]))
    theta = normal(d) / math.sqrt(d)
    y = (float(g["label_offset"]) + 8.0 * (X @ theta) + 1.5 * torch.tanh(X[:, 0])
         + 3.0 * normal(n))
    if g.get("standardize"):
        X = (X - X.mean(dim=0)) / torch.clamp_min(X.std(dim=0, correction=0), 1e-8)
    if not g.get("labels"):
        return X.contiguous(), None
    if g.get("center_labels"):
        y = y - y.mean()
    return X.contiguous(), y.contiguous()

