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
same draws.  On the card both rounds are the hand-written categorical
kernel, and the counts a_j stay on the device between them (no host copy,
so a CUDA graph can hold the whole plan).  The batched engine's ``m_cap``
capacity is supported.

:func:`dis_plan_blocked` is Algorithm 1 applied to (party, row-block)
cells, the in-memory oracle of the streamed engine's sampler
(:func:`repro_torch.core.streaming.dis_plan_streamed`);
:func:`dis_blocked_marginals` is its exact marginal in float64.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.vfl import block_geometry
from repro_torch.kernels import ops as kops


def _key_chain(key: rng.Key, num: int) -> torch.Tensor:
    """``num`` subkeys from the sequential ``key, sub = split(key)`` chain
    (sub_0 for the round-1 counts, sub_1..sub_T for the party draws)."""
    subs = []
    for _ in range(num):
        key, sub = rng.split(key)
        subs.append(sub)
    return torch.stack(subs)


class DisPlan(NamedTuple):
    """The result of one DIS execution, accounting-free.

    With ``m_cap`` masking (``m < m_cap``), ``indices``/``weights`` hold the
    m real samples as a prefix; the padded tail has index 0 and weight 0.
    """

    indices: torch.Tensor   # (m_cap,) int64  — the sampled multiset S
    weights: torch.Tensor   # (m_cap,) float32 — w(i) = G / (m * g_i)
    counts: torch.Tensor    # (T,) int64  — realised round-1 a_j (sums to m)
    totals: torch.Tensor    # (T,) float32 — per-party score mass G^(j)


def dis_plan_full(key: rng.Key, scores: torch.Tensor, m: int,
                  m_cap: Optional[int] = None,
                  totals: Optional[torch.Tensor] = None) -> DisPlan:
    """Run Algorithm 1: scores ``(T, n)`` in, :class:`DisPlan` out.

    ``scores`` are the stacked party-local scores g^(j), entries >= 0 with a
    positive total (checked by the callers).  No ledger is touched; derive
    the bill afterwards with ``CommSchedule.dis(T, m, counts=plan.counts)``.

    ``m_cap`` is the draw capacity of the batched engine's budget grid:
    every stream is drawn at ``cap = m_cap`` (the round-1 draw is ``cap``
    long and counts its first m; each party's round-2 stream keeps its
    first a_j), so a cell at ``m < m_cap`` is a prefix of the capacity
    draw.  The capacity changes the draws themselves (threefry pairs
    counter p with p + cap * n / 2), so it must be the grid's, not m.
    ``totals`` replaces the per-party reduction ``sum_i g_i^(j)``: the
    batched engine passes the eager totals of hoisted scores.  With
    neither, the plan is the reference's eager one for the same key.
    """
    T, _ = scores.shape
    m = int(m)
    cap = m if m_cap is None else int(m_cap)
    if not 0 <= m <= cap:
        raise ValueError(f"budget m={m} outside [0, m_cap={cap}]")
    scores = scores.to(torch.float32)
    subs = _key_chain(key.to(scores.device), T + 1)
    G_j = (torch.sum(scores, dim=1) if totals is None
           else totals.to(torch.float32))                      # (T,)
    G = G_j.sum()

    # ---- round 1: a ~ Multinomial(m, G_j/G), realised as m iid draws --------
    draws = kops.categorical(subs[0], rng.log(torch.clamp_min(G_j, 1e-30)),
                            cap, take=m)
    # the reference's .at[draws].add, counted on the device
    a = torch.zeros((T,), dtype=torch.int64, device=scores.device).scatter_add_(
        0, draws, torch.ones_like(draws))

    # ---- round 2: party j draws a_j iid indices ~ g_i^(j)/G^(j) -------------
    # the head of party j's cap-candidate stream, concatenated in party
    # order; a sums to m, which sizes S without reading a on the host
    logits = rng.log(torch.clamp_min(scores, 1e-30))          # (T, n)
    S = kops.categorical_parties(subs[1:], logits, cap, a, total=m)

    # ---- round 3: per-sample local scores up, weights at server -------------
    # sequential per-party accumulation, the reference's scan order
    g_sum_S = torch.zeros((m,), dtype=scores.dtype, device=scores.device)
    for j in range(T):
        g_sum_S = g_sum_S + scores[j][S]
    w = G / (m * torch.clamp_min(g_sum_S, 1e-30))
    if cap > m:
        S = torch.cat([S, S.new_zeros(cap - m)])
        w = torch.cat([w, w.new_zeros(cap - m)])
    return DisPlan(S, w, a, G_j)


def blocked_geometry(n: int, block_size: int) -> Tuple[int, int]:
    """(num_blocks nb, rows-per-block bs) for a ``block_size`` row chunking
    — :func:`repro_torch.core.vfl.block_geometry`, so the sampler's cell
    grid and ``VFLDataset.block``'s chunking cannot drift apart.
    ``block_size >= n`` is ONE unpadded block, the regime where
    :func:`dis_plan_blocked` equals :func:`dis_plan_full` bit for bit."""
    return block_geometry(n, block_size)


def dis_plan_blocked(key: rng.Key, scores: torch.Tensor, m: int,
                     block_size: int, m_cap: Optional[int] = None) -> DisPlan:
    """Hierarchical (two-level) DIS: Algorithm 1 applied to (party,
    row-block) cells.

    Round 1 draws cells (j, b) from the block masses
    G^(j,b) = sum_{i in block b} g_i^(j); round 2 draws a row within each
    chosen cell ~ g_i^(j)/G^(j,b).  The induced marginal telescopes to the
    flat plan's g_i^(j)/G (:func:`dis_blocked_marginals`).  This in-memory
    variant takes the full ``(T, n)`` scores: it is the oracle of the
    streamed sampler.

    :func:`dis_plan_full`'s structure with cells in place of parties: a
    ``T*nb + 1`` key chain (cells party-major, c = j*nb + b); round 1 one
    categorical draw over the log cell masses; the cell counts by
    ``scatter_add_`` on the device; round 2 one
    :func:`~repro_torch.kernels.ops.categorical_parties` over the
    ``(T*nb, bs)`` cell logits (padded rows -inf, so the counter layout is
    the padded block's), giving the cell-major union; round 3 the
    party-ordered scan.  With ``block_size >= n`` it equals
    :func:`dis_plan_full` bit for bit.
    """
    T, n = scores.shape
    m = int(m)
    cap = m if m_cap is None else int(m_cap)
    if not 0 <= m <= cap:
        raise ValueError(f"budget m={m} outside [0, m_cap={cap}]")
    scores = scores.to(torch.float32)
    dev = scores.device
    nb, bs = blocked_geometry(n, block_size)
    npad = nb * bs
    sp = torch.nn.functional.pad(scores, (0, npad - n)).reshape(T, nb, bs)
    row_ok = (torch.arange(npad, device=dev) < n).reshape(nb, bs)
    ncells = T * nb
    subs = _key_chain(key.to(dev), ncells + 1)
    masses = torch.sum(sp, dim=2)                                # (T, nb)
    G = masses.sum()

    # ---- round 1: cells ~ Multinomial(m, G_jb/G) ----------------------------
    draws = kops.categorical(subs[0],
                             rng.log(torch.clamp_min(masses.reshape(-1), 1e-30)),
                             cap, take=m)
    a_cells = torch.zeros((ncells,), dtype=torch.int64, device=dev).scatter_add_(
        0, draws, torch.ones_like(draws))

    # ---- round 2: within-cell rows, the union in cell order -----------------
    cell_logits = torch.where(row_ok[None], rng.log(torch.clamp_min(sp, 1e-30)),
                              -float("inf")).reshape(ncells, bs)
    local = kops.categorical_parties(subs[1:], cell_logits, cap, a_cells, total=m)
    base = (torch.arange(nb, device=dev) * bs).repeat(T)          # cell -> row 0
    S = local + torch.repeat_interleave(base, a_cells, output_size=m)

    # ---- round 3: per-sample combined scores, party-ordered -----------------
    g_sum_S = torch.zeros((m,), dtype=scores.dtype, device=dev)
    for j in range(T):
        g_sum_S = g_sum_S + scores[j][S]
    w = G / (m * torch.clamp_min(g_sum_S, 1e-30))
    if cap > m:
        S = torch.cat([S, S.new_zeros(cap - m)])
        w = torch.cat([w, w.new_zeros(cap - m)])
    return DisPlan(S, w, a_cells.reshape(T, nb).sum(dim=1), masses.sum(dim=1))


def dis_blocked_marginals(local_scores: List, block_size: int) -> np.ndarray:
    """The exact per-index marginal induced by :func:`dis_plan_blocked`,
    computed WITHOUT algebraic simplification (float64): sum over cells of
    P(cell) * P(i | cell)."""
    g = np.stack([np.asarray(torch.as_tensor(x).cpu(), np.float64)
                  for x in local_scores])                           # (T, n)
    T, n = g.shape
    nb, bs = blocked_geometry(n, block_size)
    gp = np.pad(g, ((0, 0), (0, nb * bs - n))).reshape(T, nb, bs)
    masses = gp.sum(axis=2)                                          # (T, nb)
    G = masses.sum()
    within = gp / np.maximum(masses[:, :, None], np.finfo(np.float64).tiny)
    per_cell = (masses[:, :, None] / G) * within                     # (T, nb, bs)
    return per_cell.reshape(T, -1)[:, :n].sum(axis=0)


def dis_plan(key: rng.Key, scores: torch.Tensor, m: int,
             m_cap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DIS core without its counts: ``(key, scores (T, n), m) -> (S, w)``."""
    plan = dis_plan_full(key, scores, m, m_cap=m_cap)
    return plan.indices, plan.weights


def server_plan(key: rng.Key, g: torch.Tensor, m: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-round server-side DIS: m categorical draws ~ g/G with importance
    weights G/(m*g_S).

    The degenerate T=1 view of Algorithm 1, used when the combined scores
    g already live at the sampler — the group selector after its
    all-reduce (rounds 1+3 collapse into the all-reduce, round 2's
    broadcast into the shared key).  The draw is one ``categorical``
    launch on the card, ``jax.random.categorical(key, log g, shape=(m,))``
    bit for bit."""
    m = int(m)
    G = torch.sum(g)
    S = kops.categorical(key, rng.log(torch.clamp_min(g, 1e-30)), m)
    w = G / (m * torch.clamp_min(g[S], 1e-30))
    return S, w


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


def uniform_plan(key: rng.Key, n: int, m: int, m_cap: Optional[int] = None,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure uniform baseline: m server-side uniform indices, weight n/m.
    With ``m_cap``, ``cap`` indices are drawn and the tail past m is masked
    to index 0 and weight 0 (the batched engine's prefix convention)."""
    key = key if device is None else key.to(device)
    m = int(m)
    cap = m if m_cap is None else int(m_cap)
    if not 0 <= m <= cap:
        raise ValueError(f"budget m={m} outside [0, m_cap={cap}]")
    S = rng.randint(key, (cap,), 0, int(n))
    w = torch.full((cap,), n / m, dtype=torch.float32, device=key.device)
    if cap > m:
        valid = torch.arange(cap, device=key.device) < m
        S = torch.where(valid, S, 0)
        w = torch.where(valid, w, 0.0)
    return S, w


# --------------------------------------------------------------------------
# The seed API: list-of-scores in, ledger recorded here
# --------------------------------------------------------------------------

def dis_sample(key: rng.Key, local_scores: List[torch.Tensor], m: int,
               ledger: Optional[CommLedger] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Algorithm 1 on a list of per-party score vectors g^(j) (each
    (n,), entries >= 0 with a positive total) and record the exact bill on
    ``ledger``; returns ``(indices, weights)``, both (m,)."""
    scores = torch.stack([torch.as_tensor(g) for g in local_scores])
    plan = dis_plan_full(key, scores, int(m))
    if not bool(plan.totals.sum() > 0):
        raise ValueError("DIS requires a positive total score")
    CommSchedule.dis(len(local_scores), int(m),
                     counts=plan.counts.tolist()).record(ledger)
    return plan.indices, plan.weights


def dis_marginals(local_scores: List[torch.Tensor]) -> torch.Tensor:
    """The exact per-index sampling marginal g_i/G (used by tests)."""
    g = torch.sum(torch.stack(list(local_scores)), dim=0)
    return g / g.sum()


def uniform_sample(key: rng.Key, n: int, m: int, T: int,
                   ledger: Optional[CommLedger] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paper's U-* baseline: the server draws m indices itself and
    broadcasts them, weight n/m each; the bill is the broadcast, mT."""
    S, w = uniform_plan(key, n, int(m))
    CommSchedule.uniform(T, int(m)).record(ledger)
    return S, w
