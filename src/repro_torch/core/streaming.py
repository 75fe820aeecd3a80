"""Block-scan scoring + hierarchical DIS: the streamed and pipelined
engines (port of :mod:`repro.core.streaming`).

The materialized engine holds the (T, n, s) stacked design and the (T, n)
score table on the card.  These engines make n a streaming dimension:

  * **Block-scan scoring.**  Every score path is a set of passes over row
    blocks, one superchunk of C (T, bs, s) blocks on the device at a time
    (:meth:`VFLDataset.blocks_prefetched`).  ``vrlr``: pass 1 accumulates
    each party's (s, s) Gram (the ``weighted_gram`` kernel, the 0/1
    row-valid mask as the weights), the eigen-pseudo-inverse is taken
    once, and pass 2 emits leverage scores (the ``leverage`` kernel).
    ``vkmc``: party-local k-means on a bounded uniform row subsample, then
    a pass accumulating the global cluster sizes and costs
    (``kmeans_assign_update`` with the mask as weights), then a pass
    emitting sensitivities (``kmeans_assign``).  Each kernel is launched
    once a superchunk over its (C, T) batch, so a pass costs nb / C
    launches of each.  The streamed engine is C = 1 without prefetch; the
    pipelined engine is C > 1 or prefetch: two pinned host slots, the copy
    of superchunk c + 1 on a side stream while c is scored.
  * **Hierarchical DIS** (:func:`dis_plan_streamed`,
    :func:`dis_plan_streamed_batched`): round 1 draws (party, block) cells
    from the (T, nb) block-mass table, round 2 recomputes only the
    touched blocks, C at a time (one gather, one launch of each scoring
    kernel and one categorical launch over all of the group's cells), and
    draws their rows, so the (T, n) table never exists.  Its draws are
    those of the in-memory :func:`repro_torch.core.dis.dis_plan_blocked`
    on the same scores.

The Gram, cluster statistics, block masses and draws are bit for bit the
same at every C and with or without prefetch (the reference's contract
between its streamed and pipelined engines): K3 and K2 split the rows of
each batch entry by n alone, so one launch over C blocks gives each block
the partial sums C launches would; the per-block results are folded into
the accumulator in block order, one add per block, and each block's mass
is the sum of its own (T, bs) slice.  K1, K4 and the draw are row-local.

A dataset in host memory (CPU tensors) stays there: each superchunk is
staged through pinned host memory to the card, scored by the kernels and
dropped, so the build's device memory is O(chunk_blocks * block_size * d)
at any n.

  * **Sharded block masses** (:func:`vrlr_block_masses_sharded`,
    :func:`vkmc_block_masses_sharded`): the (T, nb) table computed over the
    ranks of a ``torch.distributed`` process group, rank r scoring rows
    [r n/D, (r+1) n/D) as one (T, n/D, s) shard, with two ``all_reduce``
    calls (the reference's two psums over its ``data`` mesh axis).  A
    scorer given such a table (``masses=``) skips its own mass pass.
  * **Checkpointed resume** (``ckpt=``, a bound
    :class:`~repro_torch.core.faults.StreamCheckpoint`): every pass saves
    its accumulator and the number of superchunks done after each
    superchunk, and a rerun with the same checkpoint restores it and
    starts the scan at the first superchunk not done, so its draws are the
    uninterrupted build's bit for bit.  Without one the passes take no
    host copy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.dis import DisPlan, _key_chain
from repro_torch.core.faults import StreamCheckpoint
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
    exactly 0; ``score_blocks(ids)`` recomputes a group of blocks as one
    (len(ids), T, bs) batch, one launch of each scoring kernel, entry i bit
    for bit ``score_block(ids[i])``.  ``chunk_blocks`` is the superchunk
    width the scorer was built with (the redraw groups touched blocks by
    it).  ``data_passes`` counts the passes over the dataset the scorer
    spent building its state and mass table.  ``gram_conds`` holds the
    ``vrlr`` scorer's (T,) retained Gram condition numbers for the build's
    health report.
    """

    T: int
    n: int
    nb: int
    bs: int
    masses: torch.Tensor                    # (T, nb) float32
    dis_key: rng.Key
    score_block: Callable[[int], torch.Tensor]
    data_passes: int
    score_blocks: Optional[Callable[[Sequence[int]], torch.Tensor]] = None
    chunk_blocks: int = 1
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
    chunk_blocks: int = 1,
    prefetch: bool = False,
    masses: Optional[torch.Tensor] = None,
    ckpt: Optional[StreamCheckpoint] = None,
    **params,
) -> StreamScorer:
    """Build the task's :class:`StreamScorer` on ``device`` (the card
    unless the caller asks for the CPU) from a dataset on the CPU or on
    ``device``.  ``chunk_blocks = C > 1`` or ``prefetch`` selects the
    pipelined engine: every pass over (C, T, bs, s) superchunks, C clamped
    to the block count.  ``probe`` (if given) runs after every block (or
    superchunk) of every pass, and after ``vkmc``'s local centers.

    ``masses`` supplies the (T, nb) block-mass table (the sharded one,
    :func:`vrlr_block_masses_sharded` / :func:`vkmc_block_masses_sharded`):
    the factory skips its own mass pass, while the per-row scores the
    redraw recomputes still come from the scorer's own state.  ``ckpt``
    (a bound :class:`~repro_torch.core.faults.StreamCheckpoint`) makes
    every pass resumable per superchunk."""
    factory = STREAM_SCORERS.get(name)
    if factory is None:
        raise ValueError(
            f"no streaming scorer registered for task {name!r}; "
            f"available: {sorted(STREAM_SCORERS)}"
        )
    return factory(key, ds, block_size, backend, probe=probe, device=device,
                   chunk_blocks=chunk_blocks, prefetch=prefetch, masses=masses,
                   ckpt=ckpt, **params)


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


def _ckpt_load(ckpt: Optional[StreamCheckpoint], phase: str, dev: torch.device):
    """(superchunks done, restored carry or None) of one pass.  A pass that
    completed resumes past its last superchunk: its loop body never runs
    again and the carry is its final accumulator."""
    if ckpt is None:
        return 0, None
    saved = ckpt.load(phase, dev)
    return (0, None) if saved is None else saved


def _ckpt_save(ckpt: Optional[StreamCheckpoint], phase: str, done: int,
               carry) -> None:
    if ckpt is not None:
        ckpt.save(phase, done, carry)


def _supplied(masses, ds: VFLDataset, block_size: int,
              dev: torch.device) -> torch.Tensor:
    """A supplied (T, nb) block-mass table as float32 on ``dev``."""
    tbl = torch.as_tensor(masses).to(device=dev, dtype=torch.float32)
    want = (ds.T, ds.block_geometry(block_size)[0])
    if tuple(tbl.shape) != want:
        raise ValueError(f"supplied mass table has shape {tuple(tbl.shape)}; "
                         f"the dataset's is {want}")
    return tbl


def _setup(backend: str, device: DeviceLike) -> Tuple[bool, torch.device]:
    """(use_kernel, device) for a factory."""
    if backend not in SCORE_BACKENDS:
        raise ValueError(f"unknown score backend {backend!r}; expected one of "
                         f"{SCORE_BACKENDS}")
    return backend == "pallas", resolve_device(device)


def _rows_ok(b0: int, count: int, bs: int, n: int,
             device) -> Optional[torch.Tensor]:
    """(count, 1, bs) bool row-valid masks of blocks b0 .. b0 + count - 1,
    from the geometry alone (no copy from the host); None when every row
    of them is valid."""
    if (b0 + count) * bs <= n:
        return None
    rows = torch.arange(b0 * bs, (b0 + count) * bs, device=device)
    return (rows < n).view(count, 1, bs)


def _group_ok(ids: Sequence[int], bs: int, n: int,
              device) -> Optional[torch.Tensor]:
    """(len(ids), 1, bs) row-valid masks of the blocks ``ids``, or None
    when every row of them is valid."""
    if all((b + 1) * bs <= n for b in ids):
        return None
    return torch.stack([torch.arange(b * bs, (b + 1) * bs, device=device) < n
                        for b in ids])[:, None]


def _masked(sc: torch.Tensor, ok: Optional[torch.Tensor]) -> torch.Tensor:
    """``sc`` with 0 where ``ok`` (broadcast over the party axis) is false."""
    return sc if ok is None else torch.where(ok, sc, 0.0)


def _row_weights(ok: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """The row-valid mask as kernel weights for X of ``shape`` (..., bs, s):
    one (bs,) vector of ones the whole batch shares when every row is
    valid, else the masks expanded to ``shape[:-1]``."""
    if ok is None:
        return torch.ones(shape[-2:-1], dtype=torch.float32, device=device)
    return ok.to(torch.float32).expand(shape[:-1])


def _scan(ds: VFLDataset, block_size: int, with_labels: bool, C: int,
          prefetch: bool, dev: torch.device, probe, start_chunk: int = 0):
    """One pass over the dataset from superchunk ``start_chunk`` on:
    ``(chunk (count, T, bs, s), row-valid masks or None)`` for each
    superchunk of C blocks (one block at a time when C is 1), ``probe``
    after each.  The pass drops its references to a chunk before the next
    one is staged; so must the consumer (``del chunk``)."""
    _, bs = ds.block_geometry(block_size)
    for b0, chunk, _ in ds.blocks_prefetched(block_size, with_labels, C,
                                             prefetch, device=dev,
                                             start_chunk=start_chunk):
        ok = _rows_ok(b0, chunk.shape[0], bs, ds.n, dev)
        yield chunk, ok
        del chunk, ok
        probe()


def _block_masses(sc: torch.Tensor) -> torch.Tensor:
    """(T, C) masses of a (C, T, bs) score batch, each block's the sum of
    its own (T, bs) slice, as a lone block is summed.  A slice not 16-byte
    aligned is summed from a copy: CUDA's reduction starts at the first
    aligned element, so its order follows the address (and one sum over
    the whole batch gives other bits on the card)."""
    cols = []
    for blk in sc:
        if blk.data_ptr() % 16:
            blk = blk.clone()
        cols.append(torch.sum(blk, dim=1))
    return torch.stack(cols, dim=1)


def _mass_table(ds: VFLDataset, block_size: int, with_labels: bool, C: int,
                prefetch: bool, dev: torch.device, probe, scores,
                ckpt: Optional[StreamCheckpoint] = None) -> torch.Tensor:
    """The (T, nb) block-mass table from one pass: ``scores(chunk, ok)``
    scores a superchunk, one launch of each kernel.  Checkpointed as the
    ``mass`` phase: the columns so far after every superchunk."""
    start, saved = _ckpt_load(ckpt, "mass", dev)
    cols = [] if saved is None else list(saved)
    # a counter, not enumerate: its reused result tuple would keep the last
    # chunk alive while the next one is staged (so in every pass below)
    done = start
    for chunk, ok in _scan(ds, block_size, with_labels, C, prefetch, dev, probe,
                           start):
        sc = scores(chunk, ok)
        del chunk          # drop the slot before the next one is staged
        cols.append(_block_masses(sc))
        done += 1
        _ckpt_save(ckpt, "mass", done, tuple(cols))
    return torch.cat(cols, dim=1)


def _scorer(ds: VFLDataset, block_size: int, with_labels: bool, dev, scores,
            **fields) -> StreamScorer:
    """The :class:`StreamScorer` whose blocks ``scores(X, ok)`` recomputes:
    ``score_blocks`` gathers a group (one launch of each kernel),
    ``score_block`` is a group of one."""
    nb, bs = ds.block_geometry(block_size)

    def score_blocks(ids) -> torch.Tensor:
        batch, _ = ds.gather_blocks(ids, block_size, with_labels, device=dev)
        return scores(batch, _group_ok(ids, bs, ds.n, dev))

    return StreamScorer(T=ds.T, n=ds.n, nb=nb, bs=bs,
                        score_block=lambda b: score_blocks([b])[0],
                        score_blocks=score_blocks, **fields)


def _norm_scores(X: torch.Tensor, ok: Optional[torch.Tensor],
                 n: int) -> torch.Tensor:
    """Row-norm^2 ablation scores of X (..., T, bs, s): row-local, so each
    row's value is the materialized ``norm`` backend's; 0 where ``ok``
    (broadcast over the party axis) is false."""
    return _masked(norm_scores(X) + 1.0 / n, ok)


def _norm_scorer(key, ds: VFLDataset, block_size: int, with_labels: bool,
                 probe, dev: torch.device, C: int, prefetch: bool,
                 masses: Optional[torch.Tensor],
                 ckpt: Optional[StreamCheckpoint]) -> StreamScorer:
    def scores(X, ok):
        return _norm_scores(X, ok, ds.n)

    if masses is None:
        masses = _mass_table(ds, block_size, with_labels, C, prefetch, dev,
                             probe, scores, ckpt)
        passes = 1
    else:
        masses, passes = _supplied(masses, ds, block_size, dev), 0
    return _scorer(ds, block_size, with_labels, dev, scores, masses=masses,
                   dis_key=key, data_passes=passes, chunk_blocks=C)


def _superchunk(chunk_blocks: int, ds: VFLDataset, block_size: int) -> int:
    """The superchunk width: ``chunk_blocks`` clamped to [1, nb]."""
    return max(1, min(int(chunk_blocks), ds.block_geometry(block_size)[0]))


# --------------------------------------------------------------------------
# VRLR: Gram block-scan -> one pinv -> blockwise leverage
# --------------------------------------------------------------------------

def _gram_chunk(G: torch.Tensor, chunk: torch.Tensor,
                ok: Optional[torch.Tensor], use_kernel: bool) -> torch.Tensor:
    """G += each block's blk^T diag(valid) blk over one (C, T, bs, s)
    superchunk: one ``weighted_gram`` launch over the (C, T) batch (the
    row-valid mask as its weights), then each block's Gram added to G in
    block order."""
    f = chunk.to(torch.float32)
    Gb = kops.weighted_gram(f, _row_weights(ok, f.shape, f.device), use_kernel)
    for Gi in Gb:
        G = G + Gi
    return G


def _vrlr_scores(X: torch.Tensor, M: torch.Tensor, ok: Optional[torch.Tensor],
                 n: int, use_kernel: bool) -> torch.Tensor:
    """clip(x_i^T M x_i, 0, 1) + 1/n per party for X (..., T, bs, s); 0 where
    ``ok`` (broadcast over the party axis) is false.  The (T, s, s) M is
    expanded over X's leading dims, which the kernel takes as its batch."""
    f = X.to(torch.float32)
    lev = kops.leverage(f, M.expand(f.shape[:-2] + M.shape[-2:]), use_kernel)
    return _masked(torch.clamp(lev, 0.0, 1.0) + 1.0 / n, ok)


@register_stream_scorer("vrlr")
def vrlr_stream_scorer(
    key, ds: VFLDataset, block_size: int, backend: str,
    probe: Optional[Callable[[], None]] = None, rcond: float = 1e-6,
    device: DeviceLike = "cuda", chunk_blocks: int = 1, prefetch: bool = False,
    masses: Optional[torch.Tensor] = None,
    ckpt: Optional[StreamCheckpoint] = None,
) -> StreamScorer:
    """Algorithm 2's scores without ever holding (n, d): one block-scan
    pass accumulates each party's (s, s) Gram, the eigen-pseudo-inverse is
    taken once, and scores are re-emitted per block from (block, M) alone.
    The key passes through untouched, as in the materialized ``vrlr``
    task.  Each pass runs over superchunks of ``chunk_blocks`` blocks
    (``prefetch``: double-buffered): the same Gram and mass table at any
    width, nb / C launches of each kernel a pass.  A supplied ``masses``
    table skips the mass pass (the Gram pass still runs: one data pass).
    ``ckpt`` checkpoints the ``gram`` and ``mass`` passes."""
    use_kernel, dev = _setup(backend, device)
    probe = probe or _noop
    key = key.to(dev)
    C = _superchunk(chunk_blocks, ds, block_size)
    if backend == "norm":
        return _norm_scorer(key, ds, block_size, True, probe, dev, C, prefetch,
                            masses, ckpt)
    widths, s = ds.stacked_widths(with_labels=True)
    start, G = _ckpt_load(ckpt, "gram", dev)
    if G is None:
        G = torch.zeros((ds.T, s, s), dtype=torch.float32, device=dev)
    done = start
    for chunk, ok in _scan(ds, block_size, True, C, prefetch, dev, probe, start):
        G = _gram_chunk(G, chunk, ok, use_kernel)
        del chunk          # drop the slot before the next one is staged
        done += 1
        _ckpt_save(ckpt, "gram", done, G)
    M, gram_conds = batched_gram_pinv(G, rcond, return_cond=True,
                                      expected_rank=widths)

    def scores(X, ok):
        return _vrlr_scores(X, M, ok, ds.n, use_kernel)

    if masses is None:
        masses = _mass_table(ds, block_size, True, C, prefetch, dev, probe,
                             scores, ckpt)
        passes = 2
    else:
        masses, passes = _supplied(masses, ds, block_size, dev), 1
    return _scorer(ds, block_size, True, dev, scores, masses=masses,
                   dis_key=key, data_passes=passes, chunk_blocks=C,
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


def _vkmc_stats_chunk(csize: torch.Tensor, ccost: torch.Tensor,
                      chunk: torch.Tensor, centers: torch.Tensor,
                      ok: Optional[torch.Tensor], use_kernel: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cluster sizes (T, k), cluster costs (T, k)) accumulated over one
    (C, T, bs, s) superchunk: one fused assign-update launch over the
    (C, T) batch (centers expanded to it, the row-valid mask as weights),
    then each block's sizes and costs added in block order."""
    lead = chunk.shape[:-3]
    wv = _row_weights(ok, chunk.shape, chunk.device)
    _, _, _, wsum, cc = kmeans_update(chunk, centers.expand(lead + centers.shape),
                                      wv, use_kernel=use_kernel)
    for ws_i, cc_i in zip(wsum, cc):
        csize = csize + ws_i
        ccost = ccost + cc_i
    return csize, ccost


def _vkmc_scores(X: torch.Tensor, centers: torch.Tensor, csize: torch.Tensor,
                 ccost: torch.Tensor, ok: Optional[torch.Tensor], alpha: float,
                 use_kernel: bool) -> torch.Tensor:
    """Algorithm 3 lines 3-11 for X (..., T, bs, s), given the GLOBAL
    per-party cluster sizes and costs (T, k) of the stats pass (the
    centers expanded over X's leading dims); 0 where ``ok`` (broadcast
    over the party axis) is false."""
    lead = X.shape[:-3]
    assign, d2 = kops.kmeans_assign(X, centers.expand(lead + centers.shape),
                                    use_kernel)
    cost = torch.clamp_min(ccost.sum(dim=1), 1e-30)[:, None]      # (T, 1)
    cs = torch.clamp_min(csize, 1.0)                               # (T, k)
    idx = assign.to(torch.int64)
    cc_a = torch.gather(ccost.expand(lead + ccost.shape), -1, idx)  # (..., T, bs)
    cs_a = torch.gather(cs.expand(lead + cs.shape), -1, idx)
    sc = alpha * d2 / cost + alpha * cc_a / (cs_a * cost) + 2.0 * alpha / cs_a
    return _masked(sc, ok)


@register_stream_scorer("vkmc")
def vkmc_stream_scorer(
    key, ds: VFLDataset, block_size: int, backend: str,
    probe: Optional[Callable[[], None]] = None,
    k: int = 10, alpha: float = 2.0, local_iters: int = 15,
    center_sample: int = 16384, device: DeviceLike = "cuda",
    chunk_blocks: int = 1, prefetch: bool = False,
    masses: Optional[torch.Tensor] = None,
    ckpt: Optional[StreamCheckpoint] = None,
    centers: Optional[torch.Tensor] = None,
) -> StreamScorer:
    """Algorithm 3's sensitivities with one block (or superchunk) resident:
    party j's local k-means on a uniform row subsample
    (:func:`vkmc_local_centers`), ONE block-scan pass accumulating the
    global cluster sizes and costs, and scores re-emitted per block from
    (block, centers, stats).  The key chain matches the materialized
    ``vkmc`` task.  ``chunk_blocks``/``prefetch`` set the passes'
    superchunks as in :func:`vrlr_stream_scorer`; a supplied ``masses``
    table skips the mass pass (centers and stats still run: two data
    passes).  ``centers`` supplies :func:`vkmc_local_centers`' (T, k, s)
    centers for this key (the sharded build solves them once for its table
    and the scorer).  ``ckpt`` checkpoints the ``stats`` and ``mass``
    passes; the centers are not checkpointed: a rerun solves them again on
    the same key, to the same bits."""
    use_kernel, dev = _setup(backend, device)
    probe = probe or _noop
    T = ds.T
    C = _superchunk(chunk_blocks, ds, block_size)
    if backend == "norm":
        _, dis_key = _vkmc_key_chain(key.to(dev), T)   # the task's key budget
        return _norm_scorer(dis_key, ds, block_size, False, probe, dev, C,
                            prefetch, masses, ckpt)

    if centers is None:
        centers, dis_key = vkmc_local_centers(
            key, ds, k=k, local_iters=local_iters, center_sample=center_sample,
            use_kernel=use_kernel, device=dev)
    else:
        centers = centers.to(dev)
        _, dis_key = _vkmc_key_chain(key.to(dev), T)
    probe()
    start, saved = _ckpt_load(ckpt, "stats", dev)
    if saved is None:
        csize = torch.zeros((T, k), dtype=torch.float32, device=dev)
        ccost = torch.zeros((T, k), dtype=torch.float32, device=dev)
    else:
        csize, ccost = saved
    done = start
    for chunk, ok in _scan(ds, block_size, False, C, prefetch, dev, probe, start):
        csize, ccost = _vkmc_stats_chunk(csize, ccost, chunk, centers, ok,
                                         use_kernel)
        del chunk          # drop the slot before the next one is staged
        done += 1
        _ckpt_save(ckpt, "stats", done, (csize, ccost))
    alpha = float(alpha)

    def scores(X, ok):
        return _vkmc_scores(X, centers, csize, ccost, ok, alpha, use_kernel)

    if masses is None:
        masses = _mass_table(ds, block_size, False, C, prefetch, dev, probe,
                             scores, ckpt)
        passes = 3
    else:
        masses, passes = _supplied(masses, ds, block_size, dev), 2
    return _scorer(ds, block_size, False, dev, scores, masses=masses,
                   dis_key=dis_key, data_passes=passes, chunk_blocks=C)


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
    order.  One block's scores are live at a time; ``probe`` runs after
    every block.
    """
    return _dis_plan_grouped(scorer, m, probe, 1,
                             lambda ids: scorer.score_block(ids[0])[None])


def dis_plan_streamed_batched(scorer: StreamScorer, m: int,
                              probe: Optional[Callable[[], None]] = None
                              ) -> DisPlan:
    """:func:`dis_plan_streamed` with the grouped redraw: the touched blocks
    go in groups of ``scorer.chunk_blocks`` (the last group may be
    shorter), each group gathered and scored by one ``score_blocks`` call,
    and all of its occupied cells drawn by one categorical launch.
    Indices, weights, counts and totals are bit for bit
    :func:`dis_plan_streamed`'s for the same scorer and m: every cell's
    key, logits, stream and gather are the ones it computes block by
    block.  ``probe`` runs after every group.  A scorer without
    ``score_blocks`` falls back to :func:`dis_plan_streamed`."""
    if scorer.score_blocks is None:
        return dis_plan_streamed(scorer, m, probe=probe)
    return _dis_plan_grouped(scorer, m, probe, max(1, int(scorer.chunk_blocks)),
                             scorer.score_blocks)


def _dis_plan_grouped(scorer: StreamScorer, m: int,
                      probe: Optional[Callable[[], None]], C: int,
                      score_group: Callable[[Sequence[int]], torch.Tensor]
                      ) -> DisPlan:
    """The hierarchical sampler with the touched blocks redrawn in groups
    of C: ``score_group(ids)`` gives their (len(ids), T, bs) scores, and one
    categorical launch draws every occupied cell of the group (cells
    block-major, then party)."""
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

    # ---- rounds 2+3: each touched block once, C a group, then dropped --------
    rows: Dict[int, torch.Tensor] = {}
    gathered: Dict[int, torch.Tensor] = {}
    cols = torch.arange(bs, device=dev)
    touched = sorted({int(c) % nb for c in np.flatnonzero(a_cells)})
    for g0 in range(0, len(touched), C):
        group = touched[g0:g0 + C]
        sc = score_group(group).to(torch.float32)                  # (ng, T, bs)
        g = torch.zeros((len(group), bs), dtype=sc.dtype, device=dev)
        for j in range(T):                 # party order, the flat plan's scan
            g = g + sc[:, j]
        occ = [(j * nb + b, gi, j) for gi, b in enumerate(group)
               for j in range(T) if a_cells[j * nb + b]]
        cells, gidx, jidx = (list(v) for v in zip(*occ))
        takes = [int(a_cells[c]) for c in cells]
        first = torch.tensor([group[gi] * bs for gi in gidx], device=dev)
        sel = sc[torch.tensor(gidx, device=dev), torch.tensor(jidx, device=dev)]
        lg = torch.where(first[:, None] + cols < n,
                         rng.log(torch.clamp_min(sel, 1e-30)), -float("inf"))
        cand = kops.categorical_parties(
            subs[1 + torch.tensor(cells, device=dev)], lg, m,
            torch.tensor(takes, device=dev), total=sum(takes))
        for c, gi, piece in zip(cells, gidx, torch.split(cand, takes)):
            rows[c] = group[gi] * bs + piece
            gathered[c] = g[gi][piece]
        del sc, g
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


# --------------------------------------------------------------------------
# Block masses over the ranks of a process group (rows split by rank)
# --------------------------------------------------------------------------

def _stacked_rows(ds: VFLDataset, lo: int, hi: int, widths, s: int,
                  with_labels: bool, dev: torch.device) -> torch.Tensor:
    """The (T, hi-lo, s) float32 slice ``ds.stacked(with_labels).blocks[:,
    lo:hi]`` on ``dev``, built from the parts' rows [lo, hi) alone, so only
    this slice is allocated: a host dataset assembles it in (pinned, when
    ``dev`` is the card) host memory and copies it over once; a dataset on
    ``dev`` is sliced there."""
    pin = ds.device.type == "cpu" and dev.type == "cuda"
    out = torch.zeros((ds.T, hi - lo, s), dtype=torch.float32,
                      device=ds.device, pin_memory=pin)
    for j, p in enumerate(ds.parts):
        out[j, :, :p.shape[1]] = p[lo:hi]
    if with_labels:
        out[ds.T - 1, :, ds.dims[-1]] = ds.y[lo:hi]
    if pin:
        ds.staged_bytes += out.numel() * out.element_size()
    return out.to(dev)


def _check_shard_grid(n: int, D: int, bs: int, axis: str) -> None:
    if n % D != 0 or (n // D) % bs != 0:
        raise ValueError(
            f"n={n} must shard evenly over {axis}={D} into bs={bs} blocks"
        )


def _shard_group(dev: torch.device):
    """(group, D, rank) of the sharded table: the default process group
    when one is initialised — the D the planner checks — else a world of
    one (group None, no collective).  Raises when the group's backend
    cannot take tensors on ``dev`` (NCCL takes CUDA tensors only): nothing
    is copied across."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    if ":" in backend:                     # "cpu:gloo,cuda:nccl"
        ok = dev.type in dict(b.split(":") for b in backend.split(","))
    else:
        ok = not (backend == "nccl" and dev.type != "cuda")
    if not ok:
        raise ValueError(
            f"the process group's backend {backend!r} cannot reduce tensors "
            f"on {dev}; build the table on a device the backend takes"
        )
    return group, dist.get_world_size(group), dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """SUM ``t`` over the group in place (a world of one: nothing to do)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _union(masses_loc: torch.Tensor, nb: int, r: int, group) -> torch.Tensor:
    """The (T, nb) table from every rank's (T, nb_local) slice: written at
    its rank's offset into zeros, then one all-reduce (the slices are
    disjoint, so the sum adds zeros to each entry)."""
    T, nb_local = masses_loc.shape
    full = torch.zeros((T, nb), dtype=masses_loc.dtype, device=masses_loc.device)
    full[:, r * nb_local:(r + 1) * nb_local] = masses_loc
    return _all_reduce(full, group)


def vrlr_block_masses_sharded(
    ds: VFLDataset, block_size: int, *, rcond: float = 1e-6,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """VRLR's (T, nb) block-mass table with rows split over the ranks of a
    default process group (a world of one when none is initialised).

    Rank r computes its (T, n/D, s) shard's partial Gram (the
    ``weighted_gram`` kernel with unit weights, one launch) — combined by
    ONE all-reduce, the analogue of DIS round 1: O(T s^2) scalars, no row
    moves — then scores its own rows (the ``leverage`` kernel, one
    launch), clipped to [0, 1] plus 1/n, and writes its slice of the table;
    a second all-reduce unions the disjoint slices.  Every reduction is a
    fixed-order one, so a world of one without a group and with one give
    the same bits.  Device memory is O(n/D * d).

    Requires n divisible by D and the shard divisible by the block rows
    (the block grid aligned to the shards).  The table equals
    ``vrlr_stream_scorer(...).masses`` up to fp reduction order."""
    dev = resolve_device(device)
    nb, bs = ds.block_geometry(block_size)
    T, n = ds.T, ds.n
    if ds.y is None:
        raise ValueError("vrlr requires labels at party T")
    group, D, r = _shard_group(dev)
    _check_shard_grid(n, D, bs, "world")
    rows = n // D
    widths, s = ds.stacked_widths(with_labels=True)
    f = _stacked_rows(ds, r * rows, (r + 1) * rows, widths, s, True, dev)
    G = _all_reduce(kops.weighted_gram(
        f, torch.ones((rows,), dtype=torch.float32, device=dev)), group)
    M = batched_gram_pinv(G, rcond)
    sc = torch.clamp(kops.leverage(f, M), 0.0, 1.0) + 1.0 / n
    del f
    return _union(sc.reshape(T, rows // bs, bs).sum(dim=2), nb, r, group)


def vkmc_block_masses_sharded(
    ds: VFLDataset, block_size: int, *, key: rng.Key, k: int = 10,
    alpha: float = 2.0, local_iters: int = 15, center_sample: int = 16384,
    backend: str = "pallas", device: DeviceLike = "cuda",
    centers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """VKMC's (T, nb) block-mass table with rows split over the ranks of a
    default process group — the mirror of :func:`vrlr_block_masses_sharded` for
    Algorithm 3.

    The party-local centers come from :func:`vkmc_local_centers` on the
    scorer's key chain, or are supplied (``centers``, the same solve: the
    sharded build solves them once for the table and the scorer).  Each rank assigns its (T, n/D, s) shard (the
    ``kmeans_assign`` kernel, one launch), and the GLOBAL per-party
    cluster sizes and costs — the (T, 2k) one-hot sums, VKMC's sufficient
    statistic — are combined by ONE all-reduce; scores follow locally and a
    second all-reduce unions the disjoint slices.  ``backend`` must match
    the consuming scorer's: the centers come from an iterated Lloyd solve
    whose fp order differs between the kernels and the plain versions.
    With it matched, the table equals ``vkmc_stream_scorer(key,
    ...).masses`` up to fp reduction order."""
    use_kernel, dev = _setup(backend, device)
    nb, bs = ds.block_geometry(block_size)
    T, n = ds.T, ds.n
    group, D, r = _shard_group(dev)
    _check_shard_grid(n, D, bs, "world")
    rows = n // D
    widths, s = ds.stacked_widths(with_labels=False)
    if centers is None:
        centers, _ = vkmc_local_centers(
            key, ds, k=k, local_iters=local_iters, center_sample=center_sample,
            use_kernel=use_kernel, device=dev)
    centers = centers.to(dev)
    f = _stacked_rows(ds, r * rows, (r + 1) * rows, widths, s, False, dev)
    assign, d2 = kops.kmeans_assign(f, centers, use_kernel)        # (T, n/D)
    del f
    idx = assign.to(torch.int64)
    onehot = (idx[..., None] == torch.arange(k, device=dev)).to(torch.float32)
    stats = _all_reduce(torch.cat([onehot.sum(dim=1),
                                   (onehot * d2[..., None]).sum(dim=1)], dim=1),
                        group)                                     # (T, 2k)
    del onehot
    csize, ccost = stats[:, :k], stats[:, k:]
    cost = torch.clamp_min(ccost.sum(dim=1), 1e-30)[:, None]
    cs = torch.clamp_min(csize, 1.0)
    cc_a = torch.gather(ccost, 1, idx)
    cs_a = torch.gather(cs, 1, idx)
    alpha = float(alpha)
    sc = alpha * d2 / cost + alpha * cc_a / (cs_a * cost) + 2.0 * alpha / cs_a
    return _union(sc.reshape(T, rows // bs, bs).sum(dim=2), nb, r, group)
