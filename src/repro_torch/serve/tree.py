"""Merge-and-reduce coreset tree: online maintenance under arriving rows
(port of :mod:`repro.serve.tree`).

Every engine in :mod:`repro_torch.core` is a batch job over a fixed
:class:`~repro_torch.core.vfl.VFLDataset`; the paper's setting — parties
continuously accumulating feature slices of a shared user population —
means rows arrive over time.  This module maintains a coreset of the
ever-growing stream with the classic merge-and-reduce scheme, built
entirely out of the existing machinery:

  * **Leaves** — each arriving superchunk (one (rows, d_j)-per-party batch
    of host numpy) becomes a host-resident dataset and is summarized on
    the tree's device by a PIPELINED-engine build
    (:class:`~repro_torch.core.api.CoresetPipeline` with a forced
    ``engine="pipelined"`` spec): draw-identical to calling
    ``build_coreset_streaming`` on the chunk directly with
    :meth:`CoresetTree.leaf_key`.
  * **Merges** — a binary counter over levels: level l summarizes 2^l
    chunks, and two occupied level-l nodes combine into one level-(l+1)
    node by RE-RUNNING DIS over the union of the two materialized coresets
    with the children's weights folded into the sensitivities
    (:func:`merge_reduce`): the sampling mass of union row i is
    ``w_i * g_i^(j)``, and the drawn row keeps
    ``w_i * G~/(m * w_i g_i) = G~/(m g_i)`` — the weighted
    Feldman-Langberg draw, so reduction never re-touches raw stream rows.
    The union's rows go to the tree's device for the re-score and the
    draw; the node's rows stay in host memory.
  * **Cost** — inserting a superchunk builds ONE leaf plus at most
    ``ceil(log2(chunks))`` merge nodes, each over a 2m-row union: O(m log n)
    work, never a full-data rescore (:class:`InsertStats` is the census the
    tests assert against).
  * **Accounting** — every leaf pays Algorithm 1's DIS bill; every merge
    pays :meth:`CommSchedule.merge` (Theorem 2.5's ``+2mT`` composition for
    BOTH consumed children) plus the union re-sample's DIS bill, all
    recorded on one ledger per tree.  The composed total depends only on
    the number of chunks and the budget — insert ORDER never changes it.

Key chain (all draws deterministic given the root ``key``, folded on the
key's device): leaf i consumes ``fold_in(fold_in(key, 1), i)``; merge op t
consumes ``fold_in(fold_in(key, 2), t)``; a query after i inserts defaults
to ``fold_in(fold_in(key, 3), i)`` — so repeated queries between inserts
are draw-identical, and the whole tree replays exactly from (key, insert
sequence).
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Any, Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.api import CoresetPipeline, CoresetTask, get_task, resolve_backend
from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.coreset import MaterializedCoreset
from repro_torch.core.dis import dis_plan_full, uniform_plan
from repro_torch.core.faults import StreamCheckpoint, Transport, deliver_or_record
from repro_torch.core.integrity import HealthReport, check_merge_children
from repro_torch.core.plan import CoresetSpec, PlanCache
from repro_torch.core.vfl import VFLDataset, _as_tensor
from repro_torch.core.wire import WirePayload, fmt_bits
from repro_torch.device import DeviceLike, resolve_device

_HOST = torch.device("cpu")


def merge_reduce(
    task: Union[str, CoresetTask],
    mats: Sequence[MaterializedCoreset],
    m: int,
    *,
    key: rng.Key,
    backend: str = "auto",
    params: Optional[Mapping[str, Any]] = None,
    ledger: Optional[CommLedger] = None,
    bill_consume: bool = True,
    transport: Optional[Transport] = None,
    fault_policy: str = "fail",
    device: DeviceLike = "cuda",
) -> MaterializedCoreset:
    """One merge-and-reduce step: re-run DIS over the weighted union of
    ``mats``, weights folded into the sensitivities, on ``device``.

    Sampling mass of union row i at party j is ``w_i * g_i^(j)`` (the
    task's score on the union rows times the row's carried weight), so the
    induced marginal is ``w_i g_i / sum w g`` and the drawn row's new
    weight ``w_i * G~/(m * w_i g_i)`` telescopes to ``G~/(m g_i)`` — an
    unbiased estimator over the weighted point set, which is exactly what
    merge-and-reduce needs at every level.  The uniform baseline
    degenerates to m uniform union draws with weights scaled by
    ``m_union/m``.  Both weight products are float32, the fold on the
    device and the new weights on the host, as the reference takes them.

    Billing: ``bill_consume`` records :meth:`CommSchedule.merge` — Theorem
    2.5's composition term for consuming every child coreset (each party
    receives the union's indices and returns its per-row shares) — then the
    union re-sample's own DIS (or uniform) schedule.  The returned node's
    ``comm_units`` composes: children's totals + this op's bill.

    ``transport`` delivers the schedule through the party fault seam
    (retries billed under ``retry/`` tags, composed into ``comm_units``).
    A merge NEVER degrades — every child row already carries all T
    parties' feature slices, so dropping a party here would orphan the
    materialized columns; under ``fault_policy="degrade"`` a merge behaves
    like ``"retry"`` and raises on exhaustion.
    """
    task = get_task(task)
    params = dict(params or {})
    mats = list(mats)
    # integrity pre-checks: child weights positive/finite, and no global id
    # in two different children (children summarize disjoint stream
    # segments; a collision means a corrupted upload or broken offsets)
    check_merge_children([mt.indices for mt in mats],
                         [mt.weights for mt in mats])
    union = MaterializedCoreset.concat(mats)
    dev = resolve_device(device)
    ds_u = union.dataset(dev)
    key = key.to(dev)
    T = ds_u.T
    m = int(m)
    if m < 1:
        raise ValueError(f"reduce budget must be >= 1, got {m}")

    if task.score_fn is None:
        S, w0 = uniform_plan(key, ds_u.n, m)
        S = S.cpu().numpy()
        weights = w0.cpu().numpy() * union.weights[S]
        schedule = CommSchedule.uniform(T, m)
    else:
        if task.needs_labels and ds_u.y is None:
            raise ValueError(f"{task.name} requires labels at party T")
        # The tree's params may carry stream-scorer-only knobs (rcond,
        # center_sample, ...); the union re-score runs the full score_fn,
        # so keep only what its signature accepts.
        sig = inspect.signature(task.score_fn).parameters
        if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in sig.values()):
            params = {k: v for k, v in params.items() if k in sig}
        scores, dis_key = task.score_fn(key, ds_u,
                                        backend=resolve_backend(backend, dev),
                                        **params)
        w_u = torch.from_numpy(np.asarray(union.weights, np.float32)).to(dev)
        folded = scores * w_u[None, :]                        # (T, m_union)
        plan = dis_plan_full(dis_key, folded, m)
        if not bool(plan.totals.sum() > 0):                   # one host read
            raise ValueError("DIS requires a positive total score")
        S = plan.indices.cpu().numpy()
        weights = plan.weights.cpu().numpy() * union.weights[S]
        # the merge re-score's round-1 G_j physically carries one float32
        # mass per union row — bill those bits, not just the paper scalar
        schedule = CommSchedule.dis(
            T, m, counts=plan.counts.tolist(),
            round1_payload=WirePayload.of((ds_u.n,), "float32", "raw_fp32"))

    if bill_consume:
        sizes = [mt.m for mt in mats]
        # merge(T, a, b) bills per consumed row, so folding k children into
        # (sum of first k-1, last) charges exactly sum_i 2*m_i*T
        schedule = CommSchedule.merge(T, sum(sizes[:-1]), sizes[-1]) + schedule
    rep = deliver_or_record(
        schedule, ledger, transport,
        max_retries=0 if fault_policy == "fail" else None,
        drop_on_exhaust=False,
    )
    return MaterializedCoreset(
        indices=union.indices[S],
        weights=weights.astype(union.weights.dtype),
        parts=[p[S] for p in union.parts],
        y=None if union.y is None else union.y[S],
        comm_units=union.comm_units + rep.units,
        comm_bits=union.comm_bits + rep.bits,
    )


@dataclasses.dataclass(frozen=True)
class InsertStats:
    """The census of ONE insert — what the no-full-rescore tests assert.

    ``rescored_rows`` counts every row any score function touched during
    the insert: the chunk itself (the leaf build) plus each merge's 2m-row
    union — NEVER the n_total rows already absorbed.  ``merges`` is bounded
    by the binary-counter carry chain: at most ``log2(chunks)+1``.
    """

    chunk_rows: int
    leaf_builds: int
    merges: int
    rescored_rows: int
    comm_delta: int
    height_after: int
    latency_s: float
    #: ``"<failed-engine>-><winner>"`` when the leaf build's failover
    #: ladder fired (tree constructed with ``failover=True``), else None.
    fallback: Optional[str] = None


@dataclasses.dataclass
class TreeNode:
    """One merge-and-reduce node: a materialized coreset summarizing
    ``chunks`` superchunks (``rows`` raw rows) at binary-counter ``level``."""

    level: int
    chunks: int
    rows: int
    cs: MaterializedCoreset


class CoresetTree:
    """Merge-and-reduce maintenance of one task's coreset over a row stream.

    ``insert(parts, y)`` absorbs one superchunk (per-party feature slices of
    the same new rows, labels at party T when the task needs them) in
    O(m log n); ``query()`` returns the current summary — the weighted
    union of the O(log n) occupied levels, or, with ``reduce_to=m``, one
    more :func:`merge_reduce` down to exactly m rows.  All indices are
    GLOBAL row ids (offset by the stream position at insert time), so query
    results evaluate directly against the full stream.

    Leaves and merges compute on ``device`` — the card unless the caller
    asks for the CPU; the chunks arrive in host memory and every node's
    rows stay there.

    ``headroom`` (default 2) is the classic merge-and-reduce variance
    control: every NODE stores ``headroom * budget`` rows
    (``node_budget``), and only the final query reduce comes down to the
    requested m — each level's re-sample then draws from a richer union,
    and the measured rel_error of a height-h tree lands within ~2x of the
    flat equal-budget build instead of compounding per level.
    ``headroom=1`` gives the textbook equal-size scheme.  Insert cost stays
    O(m log n); the ledger bills the node_budget-sized schedules exactly.

    The tree owns a :class:`CommLedger` (or records on a supplied one) —
    after any sequence of inserts its total is exactly the composed
    merge-and-reduce bill, invariant to insert order.
    """

    def __init__(
        self,
        task: Union[str, CoresetTask],
        budget: int,
        *,
        key: rng.Key,
        backend: str = "auto",
        block_size: int = 65536,
        chunk_blocks: Optional[int] = None,
        prefetch: Optional[bool] = None,
        params: Optional[Mapping[str, Any]] = None,
        plan_cache: Optional[PlanCache] = None,
        ledger: Optional[CommLedger] = None,
        headroom: int = 2,
        fault_policy: str = "fail",
        transport: Optional[Transport] = None,
        checkpoint: Optional[StreamCheckpoint] = None,
        memory_budget_bytes: Optional[int] = None,
        failover: bool = False,
        device: DeviceLike = "cuda",
    ) -> None:
        self.task = get_task(task)
        self.budget = int(budget)
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.headroom = int(headroom)
        if self.headroom < 1:
            raise ValueError(f"headroom must be >= 1, got {headroom}")
        self.node_budget = self.headroom * self.budget
        self.device = resolve_device(device)
        self.key = key
        self.backend = backend
        self.block_size = int(block_size)
        self.chunk_blocks = chunk_blocks
        self.prefetch = prefetch
        self.params = dict(params or {})
        self.plan_cache = plan_cache
        self.fault_policy = str(fault_policy)
        self.transport = transport
        self.checkpoint = checkpoint
        # engine failover for LEAF builds: a leaf that crashes or breaches
        # memory_budget_bytes (the build's own device bytes, as the planner
        # counts them) retries down the plan's fallback chain (pipelined ->
        # streamed, draw-identical).  Merges never failover — they run
        # dis_plan_full over small materialized unions, not an engine.
        self.memory_budget_bytes = memory_budget_bytes
        self.failover = bool(failover)
        self.fallbacks = 0
        self.last_fallback: Optional[str] = None
        self.ledger = ledger if ledger is not None else CommLedger()
        self.levels: List[Optional[TreeNode]] = []
        self.num_chunks = 0
        self.n_total = 0
        self._merge_ops = 0
        self.last_insert: Optional[InsertStats] = None
        # numerical-health census over leaf builds (merge unions re-score
        # already-validated rows, so leaves are where health is measured)
        self.health_checks = 0
        self.health_warnings = 0
        self.last_health: Optional[HealthReport] = None

    # -- the deterministic key chain ----------------------------------------

    def leaf_key(self, i: int) -> rng.Key:
        """The PRNG key leaf ``i`` consumes — the SAME key a direct
        ``build_coreset_streaming`` of that chunk (at ``node_budget``)
        would need to reproduce the leaf draw bit for bit."""
        return rng.fold_in(rng.fold_in(self.key, 1), i)

    def merge_key(self, t: int) -> rng.Key:
        return rng.fold_in(rng.fold_in(self.key, 2), t)

    def query_key(self) -> rng.Key:
        """Stable between inserts (keyed by the insert count), so repeated
        queries of an unchanged tree are draw-identical."""
        return rng.fold_in(rng.fold_in(self.key, 3), self.num_chunks)

    # -- geometry ------------------------------------------------------------

    @property
    def height(self) -> int:
        occ = [i for i, nd in enumerate(self.levels) if nd is not None]
        return (max(occ) + 1) if occ else 0

    @property
    def num_nodes(self) -> int:
        return sum(1 for nd in self.levels if nd is not None)

    @property
    def m_active(self) -> int:
        """Rows held across all occupied levels (the un-reduced query size)."""
        return sum(nd.cs.m for nd in self.levels if nd is not None)

    # -- crash-safe snapshots ------------------------------------------------

    def _snapshot(self):
        """Everything one insert mutates: a shallow copy of the level slots
        (nodes themselves are immutable once placed), the key-chain
        counters, and a ledger rollback mark."""
        return (list(self.levels), self.num_chunks, self.n_total,
                self._merge_ops, self.health_checks, self.health_warnings,
                self.last_health, self.fallbacks, self.last_fallback,
                self.ledger.mark())

    def _restore(self, snap) -> None:
        (levels, num_chunks, n_total, merge_ops,
         health_checks, health_warnings, last_health,
         fallbacks, last_fallback, mark) = snap
        self.levels = levels
        self.num_chunks = num_chunks
        self.n_total = n_total
        self._merge_ops = merge_ops
        self.health_checks = health_checks
        self.health_warnings = health_warnings
        self.last_health = last_health
        self.fallbacks = fallbacks
        self.last_fallback = last_fallback
        self.ledger.rollback(mark)

    # -- the operations ------------------------------------------------------

    def insert(self, parts: Sequence[Any], y: Optional[Any] = None, *,
               probe: Optional[Callable[[], None]] = None) -> InsertStats:
        """Absorb one superchunk: ONE pipelined leaf build over the chunk +
        the binary-counter carry chain of merges.  Returns the census.

        ``probe`` (a no-arg callable) fires at every superchunk boundary of
        the leaf build — the serving layer's deadline-check injection point;
        a probe that raises aborts the insert and the rollback below makes
        the abort free.

        Crash-safe: any failure mid-insert (a party exhausting its retries,
        a killed process probe, OOM, a deadline breach) rolls the tree back
        to its pre-insert state — levels, key-chain counters, AND the
        ledger — so retrying the same chunk replays the SAME leaf/merge
        keys and lands draw-identically to a never-failed insert.  With a
        ``checkpoint`` bound, the retried leaf build additionally resumes
        its scan passes at the last completed superchunk instead of
        restarting from row 0.
        """
        snap = self._snapshot()
        try:
            return self._insert(parts, y, probe)
        except BaseException:
            self._restore(snap)
            raise

    def _insert(self, parts: Sequence[Any], y: Optional[Any],
                probe: Optional[Callable[[], None]] = None) -> InsertStats:
        t0 = time.perf_counter()
        led0 = self.ledger.total
        parts = [np.asarray(p) for p in parts]
        chunk_rows = int(parts[0].shape[0])
        if chunk_rows < 1:
            raise ValueError("superchunk must contain at least one row")
        # the chunk stays in host memory: the pipelined engine stages it to
        # the tree's device a superchunk at a time
        ds = VFLDataset([_as_tensor(p, _HOST) for p in parts],
                        None if y is None else _as_tensor(np.asarray(y), _HOST))

        spec = CoresetSpec(
            task=self.task, budgets=self.node_budget, engine="pipelined",
            backend=self.backend, block_size=self.block_size,
            chunk_blocks=self.chunk_blocks, prefetch=self.prefetch,
            fault_policy=self.fault_policy, params=self.params,
        )
        pipe = CoresetPipeline(ds, plan_cache=self.plan_cache)
        fallback = None
        if self.failover:
            out = pipe.build_failover(
                spec, key=self.leaf_key(self.num_chunks),
                ledger=self.ledger, probe=probe, transport=self.transport,
                checkpoint=self.checkpoint,
                memory_budget_bytes=self.memory_budget_bytes,
                device=self.device,
            )
            cs, fallback = out.coreset, out.fallback
            if fallback is not None:
                self.fallbacks += 1
                self.last_fallback = fallback
        else:
            cs = pipe.build(spec, key=self.leaf_key(self.num_chunks),
                            ledger=self.ledger, probe=probe,
                            transport=self.transport,
                            checkpoint=self.checkpoint, device=self.device)
        if cs.health is not None:
            self.health_checks += 1
            if not cs.health.healthy:
                self.health_warnings += 1
            self.last_health = cs.health
        node = TreeNode(
            level=0, chunks=1, rows=chunk_rows,
            cs=MaterializedCoreset.from_coreset(cs, ds, offset=self.n_total),
        )
        self.num_chunks += 1
        self.n_total += chunk_rows

        merges = 0
        rescored = chunk_rows
        lvl = 0
        while lvl < len(self.levels) and self.levels[lvl] is not None:
            other = self.levels[lvl]
            self.levels[lvl] = None
            rescored += other.cs.m + node.cs.m     # the 2m-row merge union
            node = self._merge(other, node)
            merges += 1
            lvl += 1
        if lvl == len(self.levels):
            self.levels.append(None)
        self.levels[lvl] = node

        self.last_insert = InsertStats(
            chunk_rows=chunk_rows, leaf_builds=1, merges=merges,
            rescored_rows=rescored, comm_delta=self.ledger.total - led0,
            height_after=self.height,
            latency_s=time.perf_counter() - t0,
            fallback=fallback,
        )
        return self.last_insert

    def _merge(self, left: TreeNode, right: TreeNode) -> TreeNode:
        """Combine two equal-level nodes (older child LEFT, so the union's
        row order is stream order) into one level-(l+1) node."""
        mat = merge_reduce(
            self.task, [left.cs, right.cs], self.node_budget,
            key=self.merge_key(self._merge_ops), backend=self.backend,
            params=self.params, ledger=self.ledger,
            transport=self.transport, fault_policy=self.fault_policy,
            device=self.device,
        )
        self._merge_ops += 1
        return TreeNode(level=left.level + 1, chunks=left.chunks + right.chunks,
                        rows=left.rows + right.rows, cs=mat)

    def query(
        self,
        *,
        reduce_to: Optional[int] = None,
        key: Optional[rng.Key] = None,
    ) -> MaterializedCoreset:
        """The current stream summary.

        Default: the weighted UNION of the occupied levels (size
        ``m_active`` <= budget * height; union is server-side bookkeeping —
        no protocol cost, ``comm_units`` composes the children's).  With
        ``reduce_to=m``: one more :func:`merge_reduce` down to exactly m
        rows on the tree's device, billed on the tree's ledger like any
        merge.  Deterministic: the default key is stable until the next
        insert.
        """
        nodes = [nd for nd in reversed(self.levels) if nd is not None]
        if not nodes:
            raise ValueError("query on an empty tree — insert a chunk first")
        if reduce_to is None:
            return MaterializedCoreset.concat([nd.cs for nd in nodes])
        return merge_reduce(
            self.task, [nd.cs for nd in nodes], int(reduce_to),
            key=self.query_key() if key is None else key,
            backend=self.backend, params=self.params, ledger=self.ledger,
            transport=self.transport, fault_policy=self.fault_policy,
            device=self.device,
        )

    def describe(self) -> str:
        occ = [(nd.level, nd.chunks, nd.cs.m)
               for nd in self.levels if nd is not None]
        lines = [
            f"CoresetTree: task={self.task.name} budget={self.budget} "
            f"(nodes keep {self.node_budget}) "
            f"chunks={self.num_chunks} rows={self.n_total} "
            f"device={self.device}",
            f"  height={self.height} nodes={self.num_nodes} "
            f"m_active={self.m_active} comm={self.ledger.total} "
            f"({fmt_bits(self.ledger.total_bits)} on the wire)",
        ]
        if self.health_checks:
            status = ("ok" if self.last_health is None
                      or self.last_health.healthy else "WARN")
            lines.append(
                f"  health: {self.health_checks} checked, "
                f"{self.health_warnings} warning(s), last={status}"
            )
        for level, chunks, m in sorted(occ, reverse=True):
            lines.append(f"  level {level}: {chunks} chunk(s), m={m}")
        return "\n".join(lines)
