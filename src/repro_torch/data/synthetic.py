"""Synthetic datasets matched to the paper's benchmark profiles (port of
:mod:`repro.data.synthetic`).

The paper's YearPredictionMSD [4] and KC-House [35] are replaced by
generators with the same (n, d, label) shape and qualitatively matched
structure: correlated feature blocks, heavy-tailed leverage-score profiles
(so importance sampling genuinely beats uniform), and labels from a noisy
linear + mild nonlinear response.  ``correlated_vfl_data`` exposes the
cross-party correlation knob of the assumption sweeps.

Every draw goes through :mod:`repro_torch.rng` on the key's device, so the
random words are the reference's bit for bit: ``rng.normal`` is
``jax.random.normal`` exactly, as are the heavy-tail ``uniform`` and the
cluster ``randint``.  What is computed from them (``Z @ W``, ``pow``,
``tanh``, ``exp``) is IEEE float32 but not bitwise across libraries, so
X and y agree with the reference's to a float32 rounding tolerance.
Tensors are made on ``device`` — the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.device import DeviceLike, resolve_device


def _f32(c: float) -> float:
    return float(np.float32(c))


def _latent_block_features(key: rng.Key, n: int, d: int, n_latent: int, noise: float,
                           heavy_tail: float) -> torch.Tensor:
    """Features = latent factors x loadings + noise; a few rows are scaled by
    a Pareto-ish factor so leverage scores are heavy-tailed (the regime the
    paper's YearPrediction experiments live in)."""
    k1, k2, k3, k4 = rng.split(key, 4)
    Z = rng.normal(k1, (n, n_latent))
    W = rng.normal(k2, (n_latent, d)) / _f32(math.sqrt(n_latent))
    X = Z @ W
    X += _f32(noise) * rng.normal(k3, (n, d))
    if heavy_tail > 0:
        u = rng.uniform(k4, (n, 1), minval=1e-3, maxval=1.0)
        scale = u ** _f32(-heavy_tail)          # Pareto tail
        X *= 1.0 + _f32(0.1) * scale
    return X


def year_prediction_like(key: rng.Key, n: int = 51534, d: int = 90, *,
                         device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(X (n, 90), y (n,)) — YearPredictionMSD profile (default n is the
    paper's 515345 scaled 10x down; pass the full size for the paper's)."""
    dev = resolve_device(device)
    kx, kt, kn = rng.split(key.to(dev), 3)
    X = _latent_block_features(kx, n, d, n_latent=12, noise=0.4, heavy_tail=0.4)
    theta = rng.normal(kt, (d,)) / _f32(math.sqrt(d))
    y = (1998.0 + 8.0 * (X @ theta) + 1.5 * torch.tanh(X[:, 0])
         + 3.0 * rng.normal(kn, (n,)))
    return X, y


def kc_house_like(key: rng.Key, n: int = 21613, d: int = 18, *,
                  device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(X (n, 18), y (n,)) — KC-House profile (prices, log-normal-ish)."""
    dev = resolve_device(device)
    kx, kt, kn = rng.split(key.to(dev), 3)
    X = _latent_block_features(kx, n, d, n_latent=5, noise=0.3, heavy_tail=0.6)
    theta = rng.normal(kt, (d,)) / _f32(math.sqrt(d))
    log_price = 13.0 + 0.5 * (X @ theta) + _f32(0.1) * rng.normal(kn, (n,))
    return X, torch.exp(torch.clamp(log_price, 11.0, 16.0)) / 1e5


def correlated_vfl_data(key: rng.Key, n: int, d: int, T: int,
                        cross_correlation: float = 0.7, k_clusters: int = 0, *,
                        device: DeviceLike = "cuda") -> torch.Tensor:
    """X (n, d) whose T near-even column blocks share a fraction
    ``cross_correlation`` of variance through common latents.

    cross_correlation ~ 1: every party sees the same geometry (tau -> small,
    Assumption 5.1 easy; gamma -> small, Assumption 4.1 hard).
    cross_correlation ~ 0: independent blocks (gamma -> 1, tau unbounded).
    Optionally plants ``k_clusters`` Gaussian clusters (VKMC regime); the
    cluster of each row is ``jax.random.randint``'s, exactly.
    """
    dev = resolve_device(device)
    kc, ks, kp, kz = rng.split(key.to(dev), 4)
    rho = np.clip(np.float32(cross_correlation), np.float32(0.0), np.float32(1.0))
    X = float(np.sqrt(rho)) * rng.normal(ks, (n, d))
    X += float(np.sqrt(np.float32(1.0) - rho)) * rng.normal(kp, (n, d))
    if k_clusters > 0:
        centers = 4.0 * rng.normal(kc, (k_clusters, d))
        X += centers[rng.randint(kz, (n,), 0, k_clusters)]
    return X
