"""Block-scan scoring + hierarchical DIS: the streamed engine (port of the
block-at-a-time half of :mod:`repro.core.streaming`).

The materialized engine holds the (T, n, s) stacked design and the (T, n)
score table on the card.  This engine makes n a streaming dimension:

  * **Block-scan scoring.**  Every score path is a set of passes over
    (T, bs, s) row blocks (:meth:`VFLDataset.block`), one block on the
    device at a time.  ``vrlr``: pass 1 accumulates each party's (s, s)
    Gram block by block (the ``weighted_gram`` kernel, the 0/1 row-valid
    mask as the weights), the eigen-pseudo-inverse is taken once, and
    pass 2 emits leverage scores block by block (the ``leverage``
    kernel).  ``vkmc``: party-local k-means on a bounded uniform row
    subsample, then a pass accumulating the global cluster sizes and
    costs (``kmeans_assign_update`` with the mask as weights), then a
    pass emitting sensitivities (``kmeans_assign``).
  * **Hierarchical DIS** (:func:`dis_plan_streamed`): round 1 draws
    (party, block) cells from the (T, nb) block-mass table, round 2
    recomputes only the touched blocks and draws their rows, so the
    (T, n) table never exists.  Its draws are those of the in-memory
    :func:`repro_torch.core.dis.dis_plan_blocked` on the same scores.

A dataset in host memory (CPU tensors) stays there: each block is staged
through a pinned host buffer to the card, scored by the kernels and
dropped, so the build's device memory is O(block_size * d) at any n.

Not here yet: superchunks of ``chunk_blocks > 1`` blocks and prefetch
(the pipelined engine, with its superchunk bodies and
``dis_plan_streamed_batched``: ROADMAP.md queue 1, item 12, the pipelined
half; the planner, :func:`repro_torch.core.plan.compile_plan`, raises for
it); the per-pass checkpoint (``ckpt``, item 14); a block-mass table
supplied from sharded devices (``masses=``, item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.dis import DisPlan, _key_chain
from repro_torch.core.plan import SCORE_BACKENDS
from repro_torch.core.sensitivity import batched_gram_pinv, kmeans_update, norm_scores
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vkmc import kmeans
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

@dataclasses.dataclass(frozen=True)
class StreamScorer:
    """Block-granular view of one task's party-local scores.

    ``masses[j, b]`` is the block mass G^(j,b) = sum_{i in block b} g_i^(j)
    (the round-1 table of the hierarchical sampler); ``score_block(b)``
    recomputes the (T, bs) scores of block ``b`` on demand, with padded rows
    exactly 0.  ``data_passes`` counts the passes over the dataset the
    scorer spent building its state and mass table.  ``gram_conds``
    holds the ``vrlr`` scorer's (T,) retained Gram condition numbers for
    the build's health report.
    """

    T: int
    n: int
    nb: int
    bs: int
    masses: torch.Tensor                    # (T, nb) float32
    dis_key: rng.Key
    score_block: Callable[[int], torch.Tensor]
    data_passes: int
    gram_conds: Optional[torch.Tensor] = None


# (task name) -> factory(key, ds, block_size, backend, probe, ..., device, **params)
STREAM_SCORERS: Dict[str, Callable[..., StreamScorer]] = {}


def register_stream_scorer(name: str):
    """Decorator: register a :class:`StreamScorer` factory for task ``name``."""

    def deco(fn):
        if name in STREAM_SCORERS:
            raise KeyError(f"stream scorer for {name!r} already registered")
        STREAM_SCORERS[name] = fn
        return fn

    return deco


def make_stream_scorer(
    name: str,
    key: rng.Key,
    ds: VFLDataset,
    block_size: int,
    backend: str,
    probe: Optional[Callable[[], None]] = None,
    device: DeviceLike = "cuda",
    **params,
) -> StreamScorer:
    """Build the task's :class:`StreamScorer` on ``device`` (the card
    unless the caller asks for the CPU) from a dataset on the CPU or on
    ``device``.  ``probe`` (if given) runs after every block of every
    pass, and after ``vkmc``'s local centers."""
    factory = STREAM_SCORERS.get(name)
    if factory is None:
        raise ValueError(
            f"no streaming scorer registered for task {name!r}; "
            f"available: {sorted(STREAM_SCORERS)}"
        )
    return factory(key, ds, block_size, backend, probe=probe, device=device,
                   **params)


def with_masses(scorer: StreamScorer, masses) -> StreamScorer:
    """``scorer`` with its block-mass table swapped for a delivered one
    (what crossed the wire drives round 1; the per-row scores the redraw
    recomputes are untouched), cast to the scorer's dtype and device."""
    tbl = torch.as_tensor(masses).to(device=scorer.masses.device,
                                     dtype=scorer.masses.dtype)
    if tbl.shape != scorer.masses.shape:
        raise ValueError(
            f"delivered mass table has shape {tuple(tbl.shape)}; the scorer's "
            f"is {tuple(scorer.masses.shape)}"
        )
    return dataclasses.replace(scorer, masses=tbl)


def _noop() -> None:
    return None


def _setup(backend: str, device: DeviceLike) -> Tuple[bool, torch.device]:
    """(use_kernel, device) for a factory."""
    if backend not in SCORE_BACKENDS:
        raise ValueError(f"unknown score backend {backend!r}; expected one of "
                         f"{SCORE_BACKENDS}")
    return backend == "pallas", resolve_device(device)


def _row_valid(bs: int, nvalid: int, device) -> torch.Tensor:
    return (torch.arange(bs, device=device) < nvalid).to(torch.float32)


def _mass_table(ds: VFLDataset, block_size: int,
                score_block: Callable[[int], torch.Tensor], probe) -> torch.Tensor:
    """One pass over the blocks collecting the (T, nb) block-mass table."""
    nb, _ = ds.block_geometry(block_size)
    masses = []
    for b in range(nb):
        masses.append(torch.sum(score_block(b), dim=1))
        probe()
    return torch.stack(masses, dim=1)                      # (T, nb)


def _norm_score_body(blk: torch.Tensor, nvalid: int, n: int) -> torch.Tensor:
    """Row-norm^2 ablation scores of one block: row-local, so each row's
    value is the materialized ``norm`` backend's; 0 on padded rows."""
    sc = norm_scores(blk) + 1.0 / n
    ok = torch.arange(blk.shape[1], device=blk.device) < nvalid
    return torch.where(ok[None, :], sc, 0.0)


def _norm_scorer(key, ds: VFLDataset, block_size: int, with_labels: bool,
                 probe, dev: torch.device) -> StreamScorer:
    nb, bs = ds.block_geometry(block_size)

    def score_block(b: int) -> torch.Tensor:
        blk, nvalid = ds.block(b, block_size, with_labels, device=dev)
        return _norm_score_body(blk, nvalid, ds.n)

    masses = _mass_table(ds, block_size, score_block, probe)
    return StreamScorer(T=ds.T, n=ds.n, nb=nb, bs=bs, masses=masses,
                        dis_key=key, score_block=score_block, data_passes=1)


# --------------------------------------------------------------------------
# VRLR: Gram block-scan -> one pinv -> blockwise leverage
# --------------------------------------------------------------------------

def _gram_body(G: torch.Tensor, blk: torch.Tensor, nvalid: int,
               use_kernel: bool) -> torch.Tensor:
    """G += blk^T diag(valid) blk, batched over the party axis (the
    ``weighted_gram`` kernel with the row-valid mask as its weights)."""
    T, bs, _ = blk.shape
    f = blk.to(torch.float32)
    wv = _row_valid(bs, nvalid, blk.device).expand(T, bs)
    return G + kops.weighted_gram(f, wv, use_kernel)


def _vrlr_score_body(blk: torch.Tensor, M: torch.Tensor, nvalid: int, n: int,
                     use_kernel: bool) -> torch.Tensor:
    """clip(x_i^T M x_i, 0, 1) + 1/n per party; 0 on padded rows."""
    f = blk.to(torch.float32)
    sc = torch.clamp(kops.leverage(f, M, use_kernel), 0.0, 1.0) + 1.0 / n
    ok = torch.arange(f.shape[1], device=f.device) < nvalid
    return torch.where(ok[None, :], sc, 0.0)


@register_stream_scorer("vrlr")
def vrlr_stream_scorer(
    key, ds: VFLDataset, block_size: int, backend: str,
    probe: Optional[Callable[[], None]] = None, rcond: float = 1e-6,
    device: DeviceLike = "cuda",
) -> StreamScorer:
    """Algorithm 2's scores without ever holding (n, d): one block-scan
    pass accumulates each party's (s, s) Gram, the eigen-pseudo-inverse is
    taken once, and scores are re-emitted per block from (block, M) alone.
    The key passes through untouched, as in the materialized ``vrlr``
    task."""
    use_kernel, dev = _setup(backend, device)
    probe = probe or _noop
    key = key.to(dev)
    if backend == "norm":
        return _norm_scorer(key, ds, block_size, True, probe, dev)
    nb, bs = ds.block_geometry(block_size)
    widths, s = ds.stacked_widths(with_labels=True)
    n = ds.n
    G = torch.zeros((ds.T, s, s), dtype=torch.float32, device=dev)
    for _, blk, nvalid in ds.blocks(block_size, with_labels=True, device=dev):
        G = _gram_body(G, blk, nvalid, use_kernel)
        del blk            # drop the block before the next one is staged
        probe()
    M, gram_conds = batched_gram_pinv(G, rcond, return_cond=True,
                                      expected_rank=widths)

    def score_block(b: int) -> torch.Tensor:
        blk, nvalid = ds.block(b, block_size, with_labels=True, device=dev)
        return _vrlr_score_body(blk, M, nvalid, n, use_kernel)

    masses = _mass_table(ds, block_size, score_block, probe)
    return StreamScorer(T=ds.T, n=n, nb=nb, bs=bs, masses=masses, dis_key=key,
                        score_block=score_block, data_passes=2,
                        gram_conds=gram_conds)


# --------------------------------------------------------------------------
# VKMC: subsampled local k-means -> stats block-scan -> blockwise scores
# --------------------------------------------------------------------------

def _vkmc_key_chain(key: rng.Key, T: int) -> Tuple[List[rng.Key], rng.Key]:
    """One split per party + one for DIS: the materialized ``vkmc`` task's
    key consumption."""
    subs = []
    for _ in range(T):
        key, sub = rng.split(key)
        subs.append(sub)
    key, dis_key = rng.split(key)
    return subs, dis_key


def vkmc_local_centers(
    key: rng.Key, ds: VFLDataset, k: int = 10, local_iters: int = 15,
    center_sample: int = 16384, use_kernel: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, rng.Key]:
    """Party-local alpha-approximate k-means centers from a bounded uniform
    row subsample, padded to the common stacked width: (T, k, s) centers on
    ``device`` + the downstream DIS key.

    Party j's key splits into the subsample key and the k-means key.  The
    subsample's rows are drawn and gathered where the dataset lives (on the
    host for a host-resident one), and only the (center_sample, d_j)
    subsample goes to ``device`` for k-means++ and Lloyd."""
    dev = resolve_device(device)
    widths, s = ds.stacked_widths(with_labels=False)
    subs, dis_key = _vkmc_key_chain(key.to(dev), ds.T)
    centers = []
    for j, sub in enumerate(subs):
        k_smp, k_km = rng.split(sub)
        part = ds.parts[j]
        if ds.n > center_sample:
            idx = rng.randint(k_smp.to(part.device), (center_sample,), 0, ds.n)
            Xj = part[idx].to(dev)
        else:
            Xj = part.to(dev)
        c = kmeans(k_km, Xj, k, iters=local_iters, use_kernel=use_kernel)
        centers.append(torch.nn.functional.pad(c, (0, s - widths[j])))
    return torch.stack(centers), dis_key                   # (T, k, s)


def _vkmc_stats_body(blk: torch.Tensor, centers: torch.Tensor, nvalid: int,
                     use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cluster sizes (T, k), cluster costs (T, k)) of one block: the fused
    assign-update pass with the row-valid mask as weights, batched over
    parties."""
    T, bs, _ = blk.shape
    wv = _row_valid(bs, nvalid, blk.device).expand(T, bs)
    _, _, _, wsum, ccost = kmeans_update(blk, centers, wv, use_kernel=use_kernel)
    return wsum, ccost


def _vkmc_score_body(blk: torch.Tensor, centers: torch.Tensor,
                     csize: torch.Tensor, ccost: torch.Tensor, nvalid: int,
                     alpha: float, use_kernel: bool) -> torch.Tensor:
    """Algorithm 3 lines 3-11 for one block, given the GLOBAL per-party
    cluster sizes and costs of the stats pass; 0 on padded rows."""
    assign, d2 = kops.kmeans_assign(blk, centers, use_kernel)
    cost = torch.clamp_min(ccost.sum(dim=1), 1e-30)[:, None]      # (T, 1)
    cs = torch.clamp_min(csize, 1.0)                               # (T, k)
    idx = assign.to(torch.int64)
    cc_a = torch.gather(ccost, 1, idx)                             # (T, bs)
    cs_a = torch.gather(cs, 1, idx)
    sc = alpha * d2 / cost + alpha * cc_a / (cs_a * cost) + 2.0 * alpha / cs_a
    ok = torch.arange(blk.shape[1], device=blk.device) < nvalid
    return torch.where(ok[None, :], sc, 0.0)


@register_stream_scorer("vkmc")
def vkmc_stream_scorer(
    key, ds: VFLDataset, block_size: int, backend: str,
    probe: Optional[Callable[[], None]] = None,
    k: int = 10, alpha: float = 2.0, local_iters: int = 15,
    center_sample: int = 16384, device: DeviceLike = "cuda",
) -> StreamScorer:
    """Algorithm 3's sensitivities with one block resident: party j's local
    k-means on a uniform row subsample (:func:`vkmc_local_centers`), ONE
    block-scan pass accumulating the global cluster sizes and costs, and
    scores re-emitted per block from (block, centers, stats).  The key
    chain matches the materialized ``vkmc`` task."""
    use_kernel, dev = _setup(backend, device)
    probe = probe or _noop
    nb, bs = ds.block_geometry(block_size)
    n, T = ds.n, ds.T
    if backend == "norm":
        _, dis_key = _vkmc_key_chain(key.to(dev), T)   # the task's key budget
        return _norm_scorer(dis_key, ds, block_size, False, probe, dev)

    centers, dis_key = vkmc_local_centers(
        key, ds, k=k, local_iters=local_iters, center_sample=center_sample,
        use_kernel=use_kernel, device=dev)
    probe()
    csize = torch.zeros((T, k), dtype=torch.float32, device=dev)
    ccost = torch.zeros((T, k), dtype=torch.float32, device=dev)
    for _, blk, nvalid in ds.blocks(block_size, with_labels=False, device=dev):
        ws, cc = _vkmc_stats_body(blk, centers, nvalid, use_kernel)
        del blk            # drop the block before the next one is staged
        csize = csize + ws
        ccost = ccost + cc
        probe()

    def score_block(b: int) -> torch.Tensor:
        blk, nvalid = ds.block(b, block_size, with_labels=False, device=dev)
        return _vkmc_score_body(blk, centers, csize, ccost, nvalid,
                                float(alpha), use_kernel)

    masses = _mass_table(ds, block_size, score_block, probe)
    return StreamScorer(T=T, n=n, nb=nb, bs=bs, masses=masses, dis_key=dis_key,
                        score_block=score_block, data_passes=3)


# --------------------------------------------------------------------------
# Streamed hierarchical DIS: masses + on-demand block recomputation
# --------------------------------------------------------------------------

def dis_plan_streamed(scorer: StreamScorer, m: int,
                      probe: Optional[Callable[[], None]] = None) -> DisPlan:
    """Run the hierarchical sampler against a :class:`StreamScorer`: the
    draws of :func:`repro_torch.core.dis.dis_plan_blocked` on the same
    scores, with only the *touched* blocks' scores ever computed.

    Round 1 draws m (party, block) cells from ``scorer.masses`` (cells
    party-major, c = j*nb + b, key ``subs[0]`` of a ``T*nb + 1`` chain);
    the cell counts are read on the host, as the reference does.  Round 2
    recomputes each touched block once and draws the rows of all its
    occupied cells in one categorical launch: cell c's first a_c rows of its
    full-capacity ``(m, bs)`` candidate stream under ``subs[1 + c]``, the
    block's padded rows at -inf (the counter layout is the padded
    block's).  Round 3 gathers the sampled rows' combined scores from the
    same recomputed block, summed in party order.  S is the union in cell
    order.  One block's scores are live at a time.
    """
    probe = probe or _noop
    T, nb, bs, n = scorer.T, scorer.nb, scorer.bs, scorer.n
    m = int(m)
    masses = scorer.masses.to(torch.float32)
    dev = masses.device
    ncells = T * nb
    subs = _key_chain(scorer.dis_key.to(dev), ncells + 1)
    G = masses.sum()

    # ---- round 1: cells ~ Multinomial(m, G_jb/G) ----------------------------
    draws = kops.categorical(subs[0],
                             rng.log(torch.clamp_min(masses.reshape(-1), 1e-30)), m)
    a_cells = np.bincount(draws.cpu().numpy(), minlength=ncells)

    # ---- rounds 2+3: each touched block once, then dropped -------------------
    rows: Dict[int, torch.Tensor] = {}
    gathered: Dict[int, torch.Tensor] = {}
    cols = torch.arange(bs, device=dev)
    for b in sorted({int(c) % nb for c in np.flatnonzero(a_cells)}):
        sc_b = scorer.score_block(b).to(torch.float32)             # (T, bs)
        g_b = torch.zeros((bs,), dtype=sc_b.dtype, device=dev)
        for j in range(T):                 # party order, the flat plan's scan
            g_b = g_b + sc_b[j]
        js = [j for j in range(T) if a_cells[j * nb + b]]
        cells = [j * nb + b for j in js]
        takes = [int(a_cells[c]) for c in cells]
        lg = torch.where(b * bs + cols < n,
                         rng.log(torch.clamp_min(sc_b[js], 1e-30)), -float("inf"))
        cand = kops.categorical_parties(
            subs[1 + torch.tensor(cells, device=dev)], lg, m,
            torch.tensor(takes, device=dev), total=sum(takes))
        for c, piece in zip(cells, torch.split(cand, takes)):
            rows[c] = b * bs + piece
            gathered[c] = g_b[piece]
        del sc_b, g_b
        probe()
    order = sorted(rows)
    S = (torch.cat([rows[c] for c in order]) if order
         else torch.zeros((0,), dtype=torch.int64, device=dev))
    g_sum = (torch.cat([gathered[c] for c in order]) if order
             else torch.zeros((0,), dtype=masses.dtype, device=dev))
    w = G / (m * torch.clamp_min(g_sum, 1e-30))
    a = torch.as_tensor(a_cells.reshape(T, nb).sum(axis=1), dtype=torch.int64,
                        device=dev)
    return DisPlan(S, w, a, masses.sum(dim=1))
