"""Coreset batch selection for LLM training (port of
:mod:`repro.core.selector`) — the paper's technique as a framework feature.

Geometry: under tensor (feature) parallelism each rank holds a slice of
every example's features — exactly the VFL layout (shard = party, example
= data row).  Selecting an m-row weighted coreset of the B-row batch
*before* the expensive step divides the step's collective and compute
terms by ~B/m while keeping the loss estimate unbiased (importance weights
in the loss — Theorem 2.5's composition, with the training step as the
downstream scheme `A`).

Scoring is Algorithm 2 verbatim, per shard: each rank computes the ridge
leverage scores of its local (B, d_local) feature slice, i.e.
g_i^(j) = ||u_i^(j)||^2 + 1/B.  Scores are combined with one all-reduce
of B scalars over the process group (the analogue of DIS rounds 1+3, vs.
B*d for gathering features), and sampling uses a SHARED key, so every
rank draws the identical multiset S with no extra communication (round
2's broadcast).  On the card the draw is one ``categorical`` launch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import rng
from repro_torch.core.dis import server_plan, uniform_plan
from repro_torch.core.sensitivity import norm_scores, ridge_leverage_scores
from repro_torch.core.streaming import _all_reduce, _shard_group


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    mode: str = "coreset"        # none | uniform | coreset
    fraction: float = 0.25       # m = round(fraction * B), at least 1
    score: str = "leverage"      # leverage | norm
    ridge: float = 1e-4          # Gram regulariser for the local inverse

    def m_of(self, batch: int) -> int:
        return max(1, int(round(self.fraction * batch)))


def local_scores(feats_local: torch.Tensor, score: str, ridge: float) -> torch.Tensor:
    """Party-local sensitivity scores for a (B, d_local) feature slice.

    ``leverage``: Algorithm 2's g_i^(j) (ridge leverage + 1/B floor).
    ``norm``: plain row-norm^2 — the cheap ablation.
    """
    B = feats_local.shape[0]
    if score == "norm":
        return norm_scores(feats_local) + 1.0 / B
    return ridge_leverage_scores(feats_local, ridge) + 1.0 / B


def sample_coreset(key: rng.Key, g: torch.Tensor, m: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """m categorical draws ~ g/G with importance weights G/(m*g_S) — the
    server side of DIS (:func:`repro_torch.core.dis.server_plan`).  `g`
    must be identical on all ranks (after the all-reduce), and `key`
    shared, so this is replicated compute with no communication."""
    return server_plan(key, g, m)


def select(key: rng.Key, feats: torch.Tensor, cfg: SelectorConfig,
           group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select (indices, weights) from a (B, d) feature batch.

    Under a process group pass ``group``: `feats` is then this rank's
    column slice and the scores are summed over the group.  Outside a group
    (or with the feature dim unsharded) pass ``group=None``.
    """
    B = feats.shape[0]
    m = cfg.m_of(B)
    key = key.to(feats.device)
    if cfg.mode == "uniform":
        return uniform_plan(key, B, m)
    if cfg.mode != "coreset":
        raise ValueError(f"select() called with mode={cfg.mode!r}")
    g = local_scores(feats, cfg.score, cfg.ridge)
    g = _all_reduce(g, group)                # DIS rounds 1+3: B scalars
    return sample_coreset(key, g, m)


def make_mesh_selector(cfg: SelectorConfig):
    """The group selector: features sharded by columns over the ranks.

    Returns fn(key, feats_local) -> (indices (m,), weights (m,)), the same
    on every rank: one all-reduce of the B local scores over the default
    process group when one is initialised (else a world of one with no
    collective), then the shared-key draw.  Refuses a group whose backend
    cannot take tensors on the features' device.
    """

    def select_fn(key: rng.Key, feats_local: torch.Tensor):
        group = _shard_group(feats_local.device)[0]
        return select(key, feats_local, cfg, group=group)

    return select_fn


def weighted_token_loss(per_example_loss: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Unbiased batch-loss estimate: (1/B) sum_{i in S} w_i * loss_i.

    E[sum w_i loss_i] = sum_i loss_i because the DIS marginal of each draw is
    g_i/G and w_i = G/(m g_i).
    """
    B_equiv = torch.sum(weights)                     # E[sum w] = B
    return torch.sum(weights * per_example_loss) / torch.clamp_min(B_equiv, 1e-6)
