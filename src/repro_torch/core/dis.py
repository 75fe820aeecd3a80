"""Algorithm 1 of the paper: Distributed Importance Sampling (DIS), the
flat core of :mod:`repro.core.dis` over torch tensors.

Three communication rounds (star topology, unit accounting per
:mod:`repro_torch.core.comm`):

  round 1:  party j -> server: scalar G^(j) = sum_i g_i^(j)            (T units)
            server samples multiset A ~ Multinomial(m, G^(j)/G)
            server -> party j: a_j = #{j in A}                          (T units)
  round 2:  party j -> server: multiset S^(j) of a_j indices,
            i sampled w.p. g_i^(j)/G^(j)                               (m units)
            server -> all parties: S = union_j S^(j)                 (mT units)
  round 3:  party j -> server: {g_i^(j) : i in S}                     (mT units)
            server: w(i) = G / (|S| * sum_j g_i^(j))

The draws come from :mod:`repro_torch.rng`, bit-exact against
``jax.random`` (non-partitionable threefry), and follow the reference's
key choreography: ``T + 1`` subkeys from the sequential split chain, the
first for round 1, one per party for round 2.  The reference draws a
full-capacity ``(m,)`` candidate stream per party and keeps the first
a_j; the port computes only those a_j rows of each stream, which are the
same draws.  The batched (``m_cap``) and blocked variants wait for their
engines.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import rng


def _key_chain(key: rng.Key, num: int) -> torch.Tensor:
    """``num`` subkeys from the sequential ``key, sub = split(key)`` chain
    (sub_0 for the round-1 counts, sub_1..sub_T for the party draws)."""
    subs = []
    for _ in range(num):
        key, sub = rng.split(key)
        subs.append(sub)
    return torch.stack(subs)


class DisPlan(NamedTuple):
    """The result of one DIS execution, accounting-free."""

    indices: torch.Tensor   # (m,) int64  — the sampled multiset S
    weights: torch.Tensor   # (m,) float32 — w(i) = G / (m * g_i)
    counts: torch.Tensor    # (T,) int64  — realised round-1 a_j (sums to m)
    totals: torch.Tensor    # (T,) float32 — per-party score mass G^(j)


def dis_plan_full(key: rng.Key, scores: torch.Tensor, m: int) -> DisPlan:
    """Run Algorithm 1: scores ``(T, n)`` in, :class:`DisPlan` out.

    ``scores`` are the stacked party-local scores g^(j), entries >= 0 with a
    positive total (checked by the callers).  No ledger is touched; derive
    the bill afterwards with ``CommSchedule.dis(T, m, counts=plan.counts)``.
    """
    T, _ = scores.shape
    m = int(m)
    scores = scores.to(torch.float32)
    subs = _key_chain(key.to(scores.device), T + 1)
    G_j = torch.sum(scores, dim=1)                             # (T,)
    G = G_j.sum()

    # ---- round 1: a ~ Multinomial(m, G_j/G), realised as m iid draws --------
    draws = rng.categorical(subs[0], rng.log(torch.clamp_min(G_j, 1e-30)), m)
    a = torch.bincount(draws, minlength=T)

    # ---- round 2: party j draws a_j iid indices ~ g_i^(j)/G^(j) -------------
    # the head of party j's m-candidate stream, concatenated in party order
    logits = rng.log(torch.clamp_min(scores, 1e-30))          # (T, n)
    take = a.tolist()
    S = torch.cat([rng.categorical(subs[1 + j], logits[j], m, take=take[j])
                   for j in range(T)])

    # ---- round 3: per-sample local scores up, weights at server -------------
    # sequential per-party accumulation, the reference's scan order
    g_sum_S = torch.zeros((m,), dtype=scores.dtype, device=scores.device)
    for j in range(T):
        g_sum_S = g_sum_S + scores[j][S]
    w = G / (m * torch.clamp_min(g_sum_S, 1e-30))
    return DisPlan(S, w, a, G_j)


def split_uploads(indices, counts):
    """Recover the round-2 per-party uploads from a realized plan.

    The realized sample ``S`` is party-major (party j's a_j draws in party
    order), so party j's upload is the j-th contiguous slice of length
    ``counts[j]``.  Host-side numpy; returns a list of (a_j,) arrays whose
    concatenation is ``indices``."""
    idx = np.asarray(torch.as_tensor(indices).cpu())
    c = np.asarray(torch.as_tensor(counts).cpu(), dtype=np.int64)
    if int(c.sum()) != idx.shape[0]:
        raise ValueError(
            f"counts sum to {int(c.sum())} but the plan realized "
            f"{idx.shape[0]} indices; uploads cannot be attributed")
    return np.split(idx, np.cumsum(c)[:-1])


def uniform_plan(key: rng.Key, n: int, m: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure uniform baseline: m server-side uniform indices, weight n/m."""
    key = key if device is None else key.to(device)
    S = rng.randint(key, (int(m),), 0, int(n))
    return S, torch.full((int(m),), n / m, dtype=torch.float32,
                         device=key.device)
