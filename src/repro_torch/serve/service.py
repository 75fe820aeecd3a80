"""Multi-tenant coreset service: long-lived trees, a shared plan cache, and
cross-tenant request batching (port of :mod:`repro.serve.service`).

One :class:`CoresetService` process serves many tenants (one VFL federation
each) on one device — the card unless the caller asks for the CPU.  Three
things make it a SERVICE rather than a loop over
:class:`~repro_torch.serve.tree.CoresetTree`:

  * **Plan cache** — every tenant's leaf builds plan through one shared
    :class:`~repro_torch.core.plan.PlanCache` keyed on
    ``(task, shapes, devices, resolved knobs)``: the first tenant at a
    given (chunk shape, task, knobs) compiles the plan, every later tenant
    reuses it.  The port compiles no programs, so a hit saves the planning
    only (the reference's hit also meant warm XLA programs).
  * **Per-tenant state** — each tenant owns a tree, a ledger, and a
    deterministic key chain seeded at registration; the same registration +
    insert sequence replays the same draws regardless of what other
    tenants do.
  * **Cross-tenant batching** — one-shot build requests against shared
    reference datasets (``attach_dataset`` / ``submit`` / ``flush``) are
    grouped by ``(dataset, task, params)`` and executed as ONE
    ``build_coresets_batched`` grid per group — R tenants' requests cost
    one batched build instead of R.

All receipts carry wall latency (host ``perf_counter``; an insert ends in
host copies of its nodes, so its time covers the card's work) and the
tenant's ledger total so a harness can report p50/p99 and verify composed
accounting externally.

The service is additionally OVERLOAD-SAFE: every operation passes an
admission gate (deadline, global in-flight cap, per-tenant token bucket,
per-tenant circuit breaker — see :mod:`repro_torch.serve.resilience`) and
refusals return :class:`~repro_torch.serve.resilience.ShedReceipt` instead
of raising or silently dropping.  Deadline-pressed queries degrade to the
un-reduced tree union; leaf builds can arm the engine failover ladder
(``failover=True`` + ``memory_budget_bytes``).  The invariant: no request
is ever lost without a receipt.  The service reads its clock at the same
points, as many times and in the same order as the reference's, so a
``SimClock`` drives both through the same deadlines.

Deliberate differences from the reference:

  * ``flush`` builds with the service's ``backend`` (the reference
    hard-codes ``"ref"``), so on the card a flushed grid runs the
    hand-written kernels, as the port's ``build_coresets_batched``
    defaults to.
  * ``attach_dataset`` refuses a dataset that lives off the service's
    device when it is attached (the batched engine would refuse it at
    flush time, after tenants' submits were queued).
  * Keys are :mod:`repro_torch.rng` key tensors; ``register(seed=s)``
    takes ``rng.PRNGKey(s)``, whose words are ``jax.random.PRNGKey(s)``'s,
    and a flushed group's keys are stacked onto the service's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.api import CoresetTask, build_coresets_batched, get_task
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import Coreset, MaterializedCoreset
from repro_torch.core.faults import (
    Clock,
    Deadline,
    DeadlineExceeded,
    PartyUnavailable,
    StreamCheckpoint,
    Transport,
    WallClock,
)
from repro_torch.core.integrity import IntegrityError
from repro_torch.core.plan import PlanCache
from repro_torch.core.wire import fmt_bits
from repro_torch.core.vfl import VFLDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.resilience import CircuitBreaker, ShedReceipt, TokenBucket
from repro_torch.serve.tree import CoresetTree, InsertStats


@dataclasses.dataclass(frozen=True)
class InsertReceipt:
    tenant: str
    chunk_idx: int              # 0-based index of this chunk in the stream
    stats: InsertStats
    ledger_total: int           # tenant's composed comm bill after the insert
    plan_hit: bool              # leaf build reused a cached ExecutionPlan
    latency_s: float
    #: engine failover trail of the leaf build ("pipelined->streamed"), or
    #: None when the planned engine succeeded
    fallback: Optional[str] = None
    #: tenant's composed wire bill in bits after the insert (the bytes the
    #: codecs actually moved behind ``ledger_total``'s paper units)
    ledger_bits: int = 0


@dataclasses.dataclass(frozen=True)
class QueryReceipt:
    tenant: str
    result: MaterializedCoreset
    m: int
    ledger_total: int
    latency_s: float
    #: True when a deadline-pressed query returned the current tree union
    #: WITHOUT the requested final reduce_to pass (still a valid coreset —
    #: just larger than asked)
    degraded: bool = False
    #: comm units this query added to the tenant's ledger (the reduce's
    #: bill; 0 for union/degraded queries)
    comm_delta: int = 0
    #: tenant's composed wire bill in bits, and this query's bit delta
    ledger_bits: int = 0
    comm_delta_bits: int = 0


@dataclasses.dataclass(frozen=True)
class EvictReceipt:
    tenant: str
    chunks: int
    rows: int
    ledger_total: int           # final composed bill at eviction
    #: the tenant's not-yet-flushed submit requests dropped at evict time
    dropped_pending: int = 0
    ledger_bits: int = 0        # final composed wire bill at eviction


@dataclasses.dataclass
class TenantState:
    """Everything the service holds for one federation."""

    name: str
    tree: CoresetTree
    inserts: int = 0
    queries: int = 0
    bucket: Optional[TokenBucket] = None
    breaker: Optional[CircuitBreaker] = None
    max_pending: Optional[int] = None
    sheds: int = 0

    @property
    def ledger(self) -> CommLedger:
        return self.tree.ledger


@dataclasses.dataclass(frozen=True)
class _BuildRequest:
    ticket: int
    tenant: str
    dataset: str
    task: str
    m: int
    key: rng.Key
    params: Tuple[Tuple[str, Any], ...]


class CoresetService:
    """The long-lived serving layer.

    Streaming path: ``register`` a tenant (task, budget, seed), ``insert``
    superchunks as they arrive, ``query`` the current summary, ``evict``
    when the federation leaves.  Batch path: ``attach_dataset`` shared
    reference data, ``submit`` one-shot build requests from any tenants,
    ``flush`` to execute each compatible group as a single batched-engine
    dispatch.  Trees, flushes and their kernels run on ``device``.
    """

    def __init__(self, *, backend: str = "auto",
                 plan_cache: Optional[PlanCache] = None,
                 clock: Optional[Clock] = None,
                 max_inflight: Optional[int] = None,
                 device: DeviceLike = "cuda") -> None:
        self.backend = backend
        self.device = resolve_device(device)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        # the service's time seam: deadlines, token buckets, and breaker
        # cooldowns all read THIS clock — hand it a SimClock (ideally the
        # same one the tenants' Transports advance) and the whole resilience
        # layer becomes deterministic
        self.clock = clock if clock is not None else WallClock()
        if max_inflight is not None and (not isinstance(max_inflight, int)
                                         or max_inflight < 1):
            raise ValueError(
                f"max_inflight must be a positive int, got {max_inflight!r}"
            )
        self.max_inflight = max_inflight
        self._inflight = 0
        self._tenants: Dict[str, TenantState] = {}
        self._datasets: Dict[str, VFLDataset] = {}
        self._pending: List[_BuildRequest] = []
        self._next_ticket = 0
        self.batched_flushes = 0
        self.batched_cells = 0

    # -- tenant lifecycle ----------------------------------------------------

    def register(
        self,
        tenant: str,
        *,
        task: Union[str, CoresetTask] = "vrlr",
        budget: int = 512,
        seed: int = 0,
        key: Optional[rng.Key] = None,
        block_size: int = 65536,
        chunk_blocks: Optional[int] = None,
        prefetch: Optional[bool] = None,
        headroom: int = 2,
        fault_policy: str = "fail",
        transport: Optional[Transport] = None,
        checkpoint: bool = False,
        rate_limit: Optional[Tuple[float, float]] = None,
        max_pending: Optional[int] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        memory_budget_bytes: Optional[int] = None,
        failover: bool = False,
        **params: Any,
    ) -> TenantState:
        """Create a tenant: its tree, ledger, and key chain.  Deterministic —
        the same (seed/key, insert sequence) replays the same coresets.

        ``fault_policy``/``transport`` route the tenant's leaf builds and
        merges through the party fault seam (see :mod:`repro_torch.core.faults`);
        ``checkpoint=True`` gives the tenant a persistent
        :class:`~repro_torch.core.faults.StreamCheckpoint`, so an insert that
        crashes mid-build (and is rolled back by the tree) RESUMES its scan
        passes at the last completed superchunk when the chunk is retried —
        draw-identical to a never-failed insert.

        Resilience knobs (all default permissive, so a tenant without them
        behaves exactly as before): ``rate_limit=(rate_per_s, burst)`` arms
        a token bucket on the service clock; ``max_pending`` bounds the
        tenant's un-flushed ``submit`` queue; ``breaker_threshold`` /
        ``breaker_cooldown_s`` tune the circuit breaker (consecutive
        party-side failures open it); ``memory_budget_bytes`` +
        ``failover=True`` arm the leaf builds' engine failover ladder with
        the live-bytes watchdog.
        """
        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        if key is None:
            key = rng.PRNGKey(seed)
        tree = CoresetTree(
            task, budget, key=key, backend=self.backend,
            block_size=block_size, chunk_blocks=chunk_blocks,
            prefetch=prefetch, params=params, plan_cache=self.plan_cache,
            headroom=headroom, fault_policy=fault_policy,
            transport=transport,
            checkpoint=StreamCheckpoint() if checkpoint else None,
            memory_budget_bytes=memory_budget_bytes, failover=failover,
            device=self.device,
        )
        state = TenantState(
            name=tenant, tree=tree,
            bucket=None if rate_limit is None else TokenBucket(*rate_limit),
            breaker=CircuitBreaker(threshold=breaker_threshold,
                                   cooldown_s=breaker_cooldown_s),
            max_pending=max_pending,
        )
        self._tenants[tenant] = state
        return state

    # -- admission control ---------------------------------------------------

    def _admit(self, st: TenantState, op: str,
               deadline: Optional[Deadline]) -> Optional[ShedReceipt]:
        """The admission gate, cheapest check first: an already-expired
        deadline sheds before ANY state is touched (not even a token is
        spent); then the global in-flight cap, the tenant's token bucket,
        and LAST the circuit breaker — last because an open->half-open
        transition admits a probe, so nothing may shed the request after
        the breaker says yes."""
        if deadline is not None and deadline.expired(self.clock):
            st.sheds += 1
            return ShedReceipt(tenant=st.name, op=op, reason="deadline")
        if (self.max_inflight is not None
                and self._inflight >= self.max_inflight):
            st.sheds += 1
            return ShedReceipt(tenant=st.name, op=op, reason="overloaded")
        if st.bucket is not None:
            ok, retry = st.bucket.try_take(self.clock.now())
            if not ok:
                st.sheds += 1
                return ShedReceipt(tenant=st.name, op=op,
                                   reason="rate_limit", retry_after_s=retry)
        ok, retry = st.breaker.allow(self.clock.now())
        if not ok:
            st.sheds += 1
            return ShedReceipt(tenant=st.name, op=op,
                               reason="breaker_open", retry_after_s=retry)
        return None

    def tenants(self) -> List[str]:
        return sorted(self._tenants)

    def state(self, tenant: str) -> TenantState:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r}; "
                           f"registered: {self.tenants()}") from None

    def evict(self, tenant: str) -> EvictReceipt:
        st = self.state(tenant)
        del self._tenants[tenant]
        # drop the tenant's not-yet-flushed submits: flushing work for an
        # evicted tenant would burn a batched-grid slot nobody redeems
        dropped = sum(1 for r in self._pending if r.tenant == tenant)
        if dropped:
            self._pending = [r for r in self._pending if r.tenant != tenant]
        return EvictReceipt(tenant=tenant, chunks=st.tree.num_chunks,
                            rows=st.tree.n_total,
                            ledger_total=st.ledger.total,
                            dropped_pending=dropped,
                            ledger_bits=st.ledger.total_bits)

    # -- streaming path ------------------------------------------------------

    def insert(self, tenant: str, parts: Sequence[Any],
               y: Optional[Any] = None, *,
               deadline: Optional[Deadline] = None,
               ) -> Union[InsertReceipt, ShedReceipt]:
        """Absorb one superchunk into the tenant's tree.

        Validates the chunk at the service edge — a malformed request fails
        with a clear error BEFORE any tree state is touched (the tree's own
        insert is additionally crash-safe: a failure mid-build rolls back).

        ``deadline`` (a :class:`~repro_torch.core.faults.Deadline` on the service
        clock) is checked at admission — already expired sheds with zero
        work — and at every superchunk boundary of the leaf build; a
        mid-build breach rolls the tree back and returns a
        :class:`ShedReceipt` (reason ``"deadline"``), never a half-applied
        insert.  Party-side failures feed the tenant's circuit breaker and
        re-raise.
        """
        st = self.state(tenant)
        t0 = time.perf_counter()
        # pure request validation first — a malformed request costs the
        # tenant nothing (no token, no breaker probe)
        parts = list(parts)
        if not parts:
            raise ValueError(
                f"insert for tenant {tenant!r} got an empty parts list; "
                f"a superchunk needs one feature slice per party"
            )
        rows = [int(np.shape(p)[0]) for p in parts]
        if rows[0] == 0:
            raise ValueError(
                f"insert for tenant {tenant!r} got a zero-row superchunk; "
                f"send at least one row per chunk"
            )
        if len(set(rows)) != 1:
            raise ValueError(
                f"insert for tenant {tenant!r}: parties disagree on the "
                f"chunk's row count ({rows}); every party must slice the "
                f"same rows"
            )
        shed = self._admit(st, "insert", deadline)
        if shed is not None:
            return shed
        probe = (None if deadline is None
                 else lambda: deadline.check(self.clock, f"insert/{tenant}"))
        hits0 = self.plan_cache.hits
        self._inflight += 1
        try:
            stats = st.tree.insert(parts, y, probe=probe)
        except DeadlineExceeded:
            # the tree rolled itself back; the breaker learns nothing about
            # party health from a time-budget abort
            st.breaker.record_neutral(self.clock.now())
            st.sheds += 1
            return ShedReceipt(tenant=tenant, op="insert", reason="deadline",
                               latency_s=time.perf_counter() - t0)
        except (PartyUnavailable, IntegrityError) as e:
            st.breaker.record_failure(self.clock.now(),
                                      f"{type(e).__name__}: {e}")
            raise
        except BaseException:
            # not a party-side failure: a half-open probe must not stay
            # dangling, but this says nothing about party health either
            st.breaker.record_neutral(self.clock.now())
            raise
        finally:
            self._inflight -= 1
        st.breaker.record_success()
        st.inserts += 1
        return InsertReceipt(
            tenant=tenant, chunk_idx=st.tree.num_chunks - 1, stats=stats,
            ledger_total=st.ledger.total,
            plan_hit=self.plan_cache.hits > hits0,
            latency_s=time.perf_counter() - t0,
            fallback=stats.fallback,
            ledger_bits=st.ledger.total_bits,
        )

    def query(self, tenant: str, *, reduce_to: Optional[int] = None,
              key: Optional[rng.Key] = None,
              deadline: Optional[Deadline] = None,
              ) -> Union[QueryReceipt, ShedReceipt]:
        """The tenant's current stream summary.

        With a ``deadline``: already expired at admission sheds; expired by
        the time the final ``reduce_to`` pass would run DEGRADES instead —
        the receipt carries the current tree union (a valid coreset, just
        larger than requested) with ``degraded=True`` and no reduce bill.
        """
        st = self.state(tenant)
        t0 = time.perf_counter()
        shed = self._admit(st, "query", deadline)
        if shed is not None:
            return shed
        led0 = st.ledger.total
        bits0 = st.ledger.total_bits
        mark = st.ledger.mark()
        degraded = False
        self._inflight += 1
        try:
            if (reduce_to is not None and deadline is not None
                    and deadline.expired(self.clock)):
                # no time left for the reduce pass: serve what we have
                result = st.tree.query(reduce_to=None)
                degraded = True
            else:
                result = st.tree.query(reduce_to=reduce_to, key=key)
        except (PartyUnavailable, IntegrityError) as e:
            st.ledger.rollback(mark)
            st.breaker.record_failure(self.clock.now(),
                                      f"{type(e).__name__}: {e}")
            raise
        except BaseException:
            st.ledger.rollback(mark)
            st.breaker.record_neutral(self.clock.now())
            raise
        finally:
            self._inflight -= 1
        st.breaker.record_success()
        st.queries += 1
        return QueryReceipt(tenant=tenant, result=result, m=result.m,
                            ledger_total=st.ledger.total,
                            latency_s=time.perf_counter() - t0,
                            degraded=degraded,
                            comm_delta=st.ledger.total - led0,
                            ledger_bits=st.ledger.total_bits,
                            comm_delta_bits=st.ledger.total_bits - bits0)

    # -- cross-tenant batched builds -----------------------------------------

    def attach_dataset(self, name: str, ds: VFLDataset) -> None:
        """Register shared reference data one-shot builds can target.  The
        batched engine reads a dataset on the build's device only, so one
        that lives elsewhere is refused here, before any submit against it
        is queued."""
        if name in self._datasets:
            raise ValueError(f"dataset {name!r} already attached")
        if ds.device != self.device:
            raise ValueError(
                f"dataset {name!r} lives on {ds.device}, the service builds "
                f"on {self.device}; attach a copy made with "
                f"device={str(self.device)!r}"
            )
        self._datasets[name] = ds

    def submit(
        self,
        tenant: str,
        dataset: str,
        m: int,
        *,
        key: rng.Key,
        task: Union[str, CoresetTask] = "vrlr",
        **params: Any,
    ) -> Union[int, ShedReceipt]:
        """Queue a one-shot build; returns a ticket redeemed by ``flush``.

        The draw is a pure function of (dataset, task, params, m, key) —
        batching with other tenants' requests cannot change it (the batched
        engine draws every seed from its own key).

        A registered tenant with ``max_pending`` set is bounded: submits
        past the cap return a :class:`ShedReceipt` (reason
        ``"queue_full"``) instead of a ticket, so one tenant cannot grow
        the flush queue without limit.
        """
        if dataset not in self._datasets:
            raise KeyError(f"dataset {dataset!r} not attached; "
                           f"have: {sorted(self._datasets)}")
        st = self._tenants.get(tenant)
        if st is not None and st.max_pending is not None:
            depth = sum(1 for r in self._pending if r.tenant == tenant)
            if depth >= st.max_pending:
                st.sheds += 1
                return ShedReceipt(tenant=tenant, op="submit",
                                   reason="queue_full")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._pending.append(_BuildRequest(
            ticket=ticket, tenant=tenant, dataset=dataset,
            task=get_task(task).name, m=int(m), key=key,
            params=tuple(sorted(params.items())),
        ))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._pending)

    def flush(self, *, deadline: Optional[Deadline] = None) -> Dict[int, Coreset]:
        """Execute all pending requests; ONE batched-engine dispatch per
        compatible ``(dataset, task, params)`` group.

        Each group stacks its requests' keys as the seed axis and takes the
        union of requested budgets as the grid; request r's result is cell
        ``(r, ms.index(m_r))``.  Every cell still pays its own exact comm
        schedule on the submitting tenant's ledger (if that tenant has one).

        ``deadline`` is checked between group dispatches: groups there was
        no time to start go BACK to the pending queue (tickets intact, no
        partial groups) and are executed by the next flush.
        """
        pending, self._pending = self._pending, []
        groups: Dict[Tuple[str, str, Tuple], List[_BuildRequest]] = {}
        for req in pending:
            groups.setdefault((req.dataset, req.task, req.params),
                              []).append(req)

        out: Dict[int, Coreset] = {}
        for gi, ((ds_name, task, params), reqs) in enumerate(groups.items()):
            if deadline is not None and deadline.expired(self.clock):
                # out of budget: requeue every unstarted group atomically
                deferred = [r for (_, rs) in list(groups.items())[gi:]
                            for r in rs]
                self._pending = deferred + self._pending
                break
            ds = self._datasets[ds_name]
            ms = tuple(sorted({r.m for r in reqs}))
            keys = torch.stack([r.key.to(self.device) for r in reqs])
            # the service's backend, not the reference's hard-coded "ref":
            # on the card the grid runs the hand-written kernels
            grid = build_coresets_batched(
                task, ds, ms, keys=keys, backend=self.backend,
                device=self.device, **dict(params))
            self.batched_flushes += 1
            self.batched_cells += len(reqs)
            for i, req in enumerate(reqs):
                ledger = (self._tenants[req.tenant].ledger
                          if req.tenant in self._tenants else None)
                out[req.ticket] = grid.coreset(i, ms.index(req.m),
                                               ledger=ledger)
        return out

    # -- plan-cache maintenance ----------------------------------------------

    def prune_plans(self, max_idle_s: float) -> int:
        """Evict plans unused for ``max_idle_s`` seconds (see
        :meth:`PlanCache.prune`); returns the count evicted."""
        return self.plan_cache.prune(max_idle_s)

    def clear_plans(self) -> None:
        self.plan_cache.clear()

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        pc = self.plan_cache.stats()
        return {
            "tenants": len(self._tenants),
            "plan_cache_size": pc["size"],
            "plan_cache_max": pc["max_entries"],
            "plan_hits": pc["hits"],
            "plan_misses": pc["misses"],
            "plan_evictions": pc["evictions"],
            "plan_oldest_idle_s": pc["oldest_idle_s"],
            "batched_flushes": self.batched_flushes,
            "batched_cells": self.batched_cells,
            "pending": len(self._pending),
            "inflight": self._inflight,
            "health_checks": sum(st.tree.health_checks
                                 for st in self._tenants.values()),
            "health_warnings": sum(st.tree.health_warnings
                                   for st in self._tenants.values()),
            "sheds": sum(st.sheds for st in self._tenants.values()),
            "wire_bits": sum(st.ledger.total_bits
                             for st in self._tenants.values()),
            "wire_bits_by_tenant": {name: st.ledger.total_bits
                                    for name, st
                                    in sorted(self._tenants.items())},
            "fallbacks": sum(st.tree.fallbacks
                             for st in self._tenants.values()),
            "breakers": {name: st.breaker.stats()
                         for name, st in sorted(self._tenants.items())},
        }

    def describe(self) -> str:
        s = self.stats()
        lines = [
            f"CoresetService: {s['tenants']} tenant(s), plan cache "
            f"{s['plan_cache_size']} plan(s) ({s['plan_hits']} hit(s) / "
            f"{s['plan_misses']} miss(es)), "
            f"{s['batched_cells']} batched cell(s) in "
            f"{s['batched_flushes']} flush(es)",
        ]
        for name in self.tenants():
            st = self._tenants[name]
            t = st.tree
            extra = ""
            if st.breaker.state != "closed" or st.breaker.trips:
                extra += (f" breaker={st.breaker.state}"
                          f"({st.breaker.trips} trip(s))")
            if st.sheds:
                extra += f" sheds={st.sheds}"
            if t.fallbacks:
                extra += f" fallbacks={t.fallbacks}({t.last_fallback})"
            lines.append(
                f"  {name}: task={t.task.name} budget={t.budget} "
                f"chunks={t.num_chunks} rows={t.n_total} height={t.height} "
                f"comm={st.ledger.total} "
                f"({fmt_bits(st.ledger.total_bits)} on the wire){extra}"
            )
        return "\n".join(lines)
