"""Party fault model and the transport seam: fault-tolerant VFL rounds
(port of :mod:`repro.core.faults`).

Every protocol assumed the paper's idealized network: all T parties
answer every round instantly and correctly.  This module is the seam
faults are injected through:

  * :class:`FaultPlan` — a deterministic, seeded chaos specification.  Each
    logical message's fate is a pure function of ``(fault_seed, round_tag,
    party, attempt)`` through threefry (``rng.fold_in`` on a stable CRC of
    the tag, then ``rng.uniform``), so a chaos run replays exactly: the
    same plan gives the same drops, retries and ledger on every run, and
    the same as the reference package's plan in the non-partitionable
    threefry layout.  Per-party rate overrides model asymmetric links.
  * :class:`Transport` — delivers a :class:`~repro_torch.core.comm.CommSchedule`
    op by op.  A failed attempt (drop, detected corruption, or a simulated
    delay past the per-attempt timeout) is retransmitted up to
    ``max_retries`` times with capped exponential backoff; every failed
    transmission bills the message's full units under ``retry/<tag>``, so
    base tags bill exactly the fault-free schedule and
    ``ledger.by_prefix("retry/")`` is exactly the retransmission overhead.
    With a null plan delivery is bit-identical to ``schedule.record``.
    :meth:`Transport.ship` carries value payloads under checksummed
    :class:`~repro_torch.core.integrity.WireEnvelope`\\ s, optionally
    through a :mod:`repro_torch.core.wire` codec.
  * :exc:`PartyUnavailable` / :class:`DegradedBuild` — a party exhausting
    its retries raises under ``fault_policy="fail"`` or ``"retry"``; under
    ``"degrade"`` the scoring round drops it, the build continues over the
    surviving feature slices, and the coreset carries a receipt.
  * :class:`StreamCheckpoint` — the streaming engines' per-superchunk
    resume state: a crashed build rerun with the same checkpoint continues
    each pass where it died and draws what an uninterrupted build draws.

Everything here is host code on numpy payloads.  Simulated time: the
transport never sleeps — delays, timeouts and backoff accumulate in
``TransportStats.sim_time_s`` (and advance a bound :class:`Clock`).
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.integrity import WireEnvelope
from repro_torch.core.wire import UNIT_BITS, get_codec
from repro_torch.device import DeviceLike, resolve_device

FAULT_POLICIES = ("fail", "retry", "degrade", "quarantine")


# --------------------------------------------------------------------------
# The time seam: one Clock shared by deadlines and the fault plan's
# simulated delays, so "a slow party eats the request's time budget" is a
# single consistent statement in both real and simulated time.
# --------------------------------------------------------------------------

class Clock:
    """Abstract monotonic time source.

    :class:`WallClock` reads the process monotonic clock (``advance`` is a
    no-op: real time passes on its own; simulated fault delays are *never*
    slept, only accounted).  :class:`SimClock` is fully simulated — a
    :class:`Transport` bound to it pushes its fault delays and backoffs
    into the same timeline deadline checks read, so chaos tests exercise
    deadline pressure deterministically at full speed.
    """

    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real monotonic time.  ``advance`` is deliberately a no-op — wall
    time cannot be pushed forward, and simulated transport delays must not
    turn into real sleeps."""

    def now(self) -> float:
        import time

        return time.monotonic()

    def advance(self, dt: float) -> None:
        return None


class SimClock(Clock):
    """Deterministic simulated time.

    ``tick`` (default 0) is the auto-advance per :meth:`now` read — each
    observation of the clock models one unit of elapsed work, which is what
    makes deadline-at-a-superchunk-boundary tests exact: the k-th boundary
    check happens at precisely ``start + k * tick``.  ``advance`` adds
    simulated delay explicitly (the :class:`Transport` seam calls it for
    fault delays and retry backoffs when bound to this clock).
    """

    def __init__(self, start: float = 0.0, tick: float = 0.0) -> None:
        if not tick >= 0:
            raise ValueError(f"tick must be >= 0, got {tick!r}")
        self._t = float(start)
        self.tick = float(tick)

    def now(self) -> float:
        t = self._t
        self._t += self.tick
        return t

    def advance(self, dt: float) -> None:
        if not dt >= 0:
            raise ValueError(f"cannot advance time backwards (dt={dt!r})")
        self._t += float(dt)

    def peek(self) -> float:
        """The current time WITHOUT consuming an auto-tick."""
        return self._t


class DeadlineExceeded(RuntimeError):
    """An operation ran past its deadline.  Raised at a checkpoint
    boundary (superchunk probes, service admission) — never mid-kernel —
    so the state it interrupts is always rollback-safe."""

    def __init__(self, op: str, at: float, now: float) -> None:
        super().__init__(
            f"{op}: deadline {at:.6g} exceeded at t={now:.6g} "
            f"(over by {now - at:.6g}s)"
        )
        self.op = op
        self.at = float(at)
        self.now = float(now)


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute point on a :class:`Clock` by which an operation must
    finish.  ``expired`` uses >= — a deadline landing EXACTLY on a check
    boundary counts as missed (pinned by the edge-case tests), so budget 0
    always sheds at admission.
    """

    at: float
    budget_s: float = 0.0        # the original relative budget, for receipts

    @staticmethod
    def after(clock: Clock, budget_s: float) -> "Deadline":
        if not budget_s >= 0:
            raise ValueError(f"deadline budget must be >= 0, got {budget_s!r}")
        return Deadline(at=clock.now() + float(budget_s),
                        budget_s=float(budget_s))

    def expired(self, clock: Clock) -> bool:
        return clock.now() >= self.at

    def remaining(self, clock: Clock) -> float:
        return self.at - clock.now()

    def check(self, clock: Clock, op: str) -> None:
        """Raise :exc:`DeadlineExceeded` if the deadline has passed."""
        now = clock.now()
        if now >= self.at:
            raise DeadlineExceeded(op, self.at, now)

#: Silent-corruption flavors: whole-payload sign flip, whole-payload scale
#: inflation, and a single seeded NaN injection.
SILENT_KINDS = ("sign", "scale", "nan")

_Rate = Union[float, Mapping[int, float], Tuple[Tuple[int, float], ...]]


class PartyUnavailable(RuntimeError):
    """A party exhausted its delivery attempts for one protocol message."""

    def __init__(self, party: int, tag: str, attempts: int) -> None:
        super().__init__(
            f"party {party} unavailable: {attempts} attempt(s) at "
            f"{tag!r} all failed"
        )
        self.party = int(party)
        self.tag = tag
        self.attempts = int(attempts)


@dataclasses.dataclass(frozen=True)
class DroppedParty:
    """One party lost during a build: which round's message exhausted its
    retries, and after how many attempts."""

    party: int
    tag: str
    attempts: int


@dataclasses.dataclass(frozen=True)
class DegradedBuild:
    """Receipt of a build that continued without every party.

    ``bound_factor`` is the widened sensitivity bound: the paper's total
    sensitivity sums per-party contributions, so a coreset built from
    ``len(surviving)`` of ``total_parties`` slices guarantees the epsilon
    bound only for the SURVIVING projection — the factor
    ``total_parties / len(surviving)`` is the honest multiplier on the
    guarantee a consumer should assume for the full feature space."""

    dropped: Tuple[DroppedParty, ...]
    surviving: Tuple[int, ...]
    total_parties: int
    reason: str = ""

    @property
    def bound_factor(self) -> float:
        return self.total_parties / max(len(self.surviving), 1)

    def describe(self) -> str:
        drops = ", ".join(
            f"party {d.party} at {d.tag} ({d.attempts} attempts)"
            for d in self.dropped
        )
        base = (
            f"DegradedBuild: {len(self.surviving)}/{self.total_parties} "
            f"parties survived (dropped: {drops}); sensitivity bound "
            f"widened x{self.bound_factor:.2f}"
        )
        return f"{base}; {self.reason}" if self.reason else base


@functools.lru_cache(maxsize=4096)
def _tag_code(tag: str) -> int:
    """Stable 31-bit code of a round tag (CRC32 — Python's ``hash`` is
    salted per process and would break cross-run replay)."""
    return zlib.crc32(tag.encode()) & 0x7FFFFFFF


@functools.lru_cache(maxsize=256)
def _seed_key(seed: int) -> rng.Key:
    return rng.PRNGKey(seed)


@functools.lru_cache(maxsize=65536)
def _fault_draw(seed: int, tag: str, party: int, attempt: int) -> Tuple[float, float, float]:
    """The threefry uniforms deciding one attempt's fate — a pure function
    of ``(seed, tag, party, attempt)``: ``uniform(fold_in(fold_in(fold_in(
    key(seed), crc(tag)), party), attempt), (3,))`` on the CPU, the
    reference's chain in the non-partitionable threefry layout, cached so
    repeated replays never rehash."""
    sub = rng.fold_in(rng.fold_in(rng.fold_in(_seed_key(seed), _tag_code(tag)),
                                  party), attempt)
    u = rng.uniform(sub, (3,)).numpy().astype(np.float64)
    return float(u[0]), float(u[1]), float(u[2])


def _normalize_rate(rate: _Rate, what: str) -> Tuple[float, Tuple[Tuple[int, float], ...]]:
    """(default rate, sorted per-party overrides) with [0, 1] validation."""
    if isinstance(rate, Mapping):
        overrides = tuple(sorted((int(j), float(p)) for j, p in rate.items()))
        default = 0.0
    elif isinstance(rate, tuple):
        overrides = tuple(sorted((int(j), float(p)) for j, p in rate))
        default = 0.0
    else:
        overrides = ()
        default = float(rate)
    for p in (default,) + tuple(p for _, p in overrides):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"{what} probability must be in [0, 1], got {p}")
    return default, overrides


def perturb_payload(payload: Any, kind: str, u: float) -> np.ndarray:
    """Apply one silent corruption to a payload copy (the original is never
    touched — the honest sender can retransmit it).

    ``sign`` negates every entry; ``scale`` inflates every entry by a
    seeded factor in [10, 1000]; ``nan`` plants a single NaN at the seeded
    position ``int(u * size)``.  Integer payloads (round-2 index uploads)
    cannot hold NaN, so ``nan`` degrades to ``sign`` and ``scale`` uses an
    integer factor.  Every kind changes the payload bytes for any nonzero
    payload, so the envelope digest catches all of them."""
    arr = np.asarray(payload)
    out = arr.copy()
    flat = out.reshape(-1)
    if flat.size == 0:
        return out
    is_float = np.issubdtype(arr.dtype, np.floating)
    if kind == "nan" and not is_float:
        kind = "sign"
    if kind == "sign":
        np.negative(flat, out=flat)
    elif kind == "scale":
        if is_float:
            flat *= np.asarray(10.0 ** (1.0 + 2.0 * u), arr.dtype)
        else:
            flat *= 2 + int(u * 8)
    elif kind == "nan":
        flat[min(int(u * flat.size), flat.size - 1)] = np.nan
    else:
        raise ValueError(f"unknown corruption kind {kind!r}; "
                         f"expected one of {SILENT_KINDS}")
    return out


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic, seeded per-party fault specification.

    ``drop`` / ``corrupt`` / ``delay`` are probabilities — a scalar applies
    to every party; a ``{party: p}`` mapping overrides per party (parties
    not named get 0).  A delayed message whose simulated delay (uniform in
    ``(0, delay_s]``) exceeds ``timeout_s`` counts as a failed attempt
    exactly like a drop; a shorter delay just accrues simulated latency.
    Corrupt messages are assumed checksum-detected at the receiver, so they
    cost a retransmission like a drop (billed under the same ``retry/``
    tag, counted separately in :class:`TransportStats`).

    ``silent_corrupt`` is the adversarial rate: a silently corrupted
    transmission actually PERTURBS the payload (seeded sign-flip / scale /
    NaN injection via :func:`perturb_payload`) instead of being
    pre-detected.  Whether it is caught depends on the receiver: a
    verifying :class:`Transport` checks the :class:`WireEnvelope` digest
    and retransmits (billed like any retry); an unverifying one delivers
    the damaged bytes — the scenario the value-level validators exist to
    catch.  ``silent_kind`` pins the corruption flavor (one of
    :data:`SILENT_KINDS`); by default the fate draw picks one.  Silent
    fates live in their own ``silent!<tag>`` namespace of the threefry
    chain, so enabling them never perturbs drop/corrupt/delay replay.

    ``max_retries`` bounds retransmissions per message; backoff between
    attempts is capped exponential: ``min(backoff_cap_s, backoff_base_s *
    2**k)`` after the k-th failure (simulated — accrued, never slept).
    """

    seed: int = 0
    drop: _Rate = 0.0
    corrupt: _Rate = 0.0
    delay: _Rate = 0.0
    delay_s: float = 0.05
    timeout_s: float = 0.02
    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.16
    silent_corrupt: _Rate = 0.0
    silent_kind: Optional[str] = None

    def __post_init__(self) -> None:
        d, do = _normalize_rate(self.drop, "drop")
        c, co = _normalize_rate(self.corrupt, "corrupt")
        l, lo = _normalize_rate(self.delay, "delay")
        s, so = _normalize_rate(self.silent_corrupt, "silent_corrupt")
        object.__setattr__(self, "drop", do if do else d)
        object.__setattr__(self, "corrupt", co if co else c)
        object.__setattr__(self, "delay", lo if lo else l)
        object.__setattr__(self, "silent_corrupt", so if so else s)
        if self.silent_kind is not None and self.silent_kind not in SILENT_KINDS:
            raise ValueError(
                f"silent_kind must be one of {SILENT_KINDS} or None, "
                f"got {self.silent_kind!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        if not isinstance(self.max_retries, int) or self.max_retries < 0:
            raise ValueError(
                f"max_retries must be an int >= 0, got {self.max_retries!r}"
            )
        for name in ("delay_s", "timeout_s", "backoff_base_s", "backoff_cap_s"):
            v = getattr(self, name)
            if not v >= 0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")

    @staticmethod
    def none() -> "FaultPlan":
        """The null plan: every message delivered first try — transport
        delivery through it is bit-identical to ``schedule.record``."""
        return FaultPlan()

    def rate(self, kind: str, party: int) -> float:
        r = getattr(self, kind)
        if isinstance(r, tuple):
            for j, p in r:
                if j == party:
                    return p
            return 0.0
        return float(r)

    @property
    def is_null(self) -> bool:
        def _any(r) -> bool:
            if isinstance(r, tuple):
                return any(p > 0 for _, p in r)
            return r > 0
        return not (_any(self.drop) or _any(self.corrupt) or _any(self.delay)
                    or _any(self.silent_corrupt))

    def silent_fate(self, tag: str, party: int, attempt: int
                    ) -> Optional[Tuple[str, float]]:
        """None, or ``(kind, u)`` for a silently corrupted transmission.

        Drawn from a SEPARATE fate namespace (``silent!<tag>``) so enabling
        silent corruption never shifts the drop/corrupt/delay chain (the
        chaos replay pins), and a zero rate consumes no draws at all."""
        p = self.rate("silent_corrupt", party)
        if p == 0.0:
            return None
        u_hit, u_kind, u_mag = _fault_draw(self.seed, "silent!" + tag,
                                           party, attempt)
        if u_hit >= p:
            return None
        kind = self.silent_kind
        if kind is None:
            kind = SILENT_KINDS[min(int(u_kind * len(SILENT_KINDS)),
                                    len(SILENT_KINDS) - 1)]
        return kind, float(u_mag)

    def decide(self, tag: str, party: int, attempt: int) -> "FaultEvent":
        """The fate of delivery attempt ``attempt`` of message ``tag`` to/from
        ``party`` — deterministic (threefry on the plan's seed), replayable."""
        p_drop = self.rate("drop", party)
        p_corrupt = self.rate("corrupt", party)
        p_delay = self.rate("delay", party)
        if p_drop == p_corrupt == p_delay == 0.0:
            return FaultEvent("ok", 0.0)
        u_drop, u_corrupt, u_delay = _fault_draw(self.seed, tag, party, attempt)
        if u_drop < p_drop:
            return FaultEvent("drop", 0.0)
        if u_corrupt < p_corrupt:
            return FaultEvent("corrupt", 0.0)
        if p_delay > 0.0 and u_delay < p_delay:
            # deterministic magnitude: the sub-uniform position within the
            # delay event, scaled to (0, delay_s]
            d = (u_delay / p_delay) * self.delay_s
            if d > self.timeout_s:
                return FaultEvent("timeout", self.timeout_s)
            return FaultEvent("ok", d)
        return FaultEvent("ok", 0.0)

    def backoff_s(self, failures: int) -> float:
        """Capped exponential backoff after the ``failures``-th failed
        attempt (1-indexed)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** max(failures - 1, 0)))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One attempt's outcome: ``status`` in ok|drop|corrupt|timeout plus the
    simulated latency the attempt accrued."""

    status: str
    delay_s: float

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class TransportStats:
    """Cumulative census of everything a :class:`Transport` delivered."""

    attempts: int = 0
    delivered: int = 0
    retries: int = 0
    drops: int = 0
    corrupts: int = 0
    timeouts: int = 0
    exhausted: int = 0
    units_base: int = 0
    units_retried: int = 0
    bits_base: int = 0
    bits_retried: int = 0
    sim_time_s: float = 0.0
    silent_corrupts: int = 0
    silent_detected: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DeliveryReport:
    """The outcome of delivering one :class:`~repro_torch.core.comm.CommSchedule`.

    ``failed`` maps party -> :class:`DroppedParty` for parties that
    exhausted their retries (only possible with ``drop_on_exhaust=True``;
    otherwise delivery raises).  ``units`` is the total billed — base
    schedule plus every retransmission."""

    units_base: int
    units_retried: int
    retries: int
    failed: Mapping[int, DroppedParty]
    sim_time_s: float
    bits_base: int = 0
    bits_retried: int = 0

    @property
    def units(self) -> int:
        return self.units_base + self.units_retried

    @property
    def bits(self) -> int:
        """Packed wire bits billed — base schedule plus retransmissions."""
        return self.bits_base + self.bits_retried


class Transport:
    """The delivery seam between a :class:`CommSchedule` and its ledger.

    ``deliver`` walks the schedule's ops in order.  Each op is attempted up
    to ``1 + max_retries`` times (``max_retries=0`` under
    ``fault_policy="fail"``): the successful transmission bills the op
    under its own tag (so base-tag totals are EXACTLY the fault-free
    bill), and every failed transmission bills the op's full units under
    ``retry/<tag>`` — retransmissions are real traffic and the composed
    bill stays exact.  Ledger entry order is chronological (failures
    before the success), which degenerates to exactly
    ``schedule.record(ledger)`` when no fault fires.

    One transport instance accumulates :class:`TransportStats` across every
    schedule it delivers (a build, a tree's lifetime, a whole service), so
    the chaos benchmark reads retry counts and simulated latency off the
    same object it injected.
    """

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 verify: bool = True, clock: Optional[Clock] = None) -> None:
        self.plan = plan if plan is not None else FaultPlan.none()
        self.stats = TransportStats()
        # verify=False models an undefended receiver: silently corrupted
        # payloads shipped through this transport are DELIVERED as-is
        self.verify = bool(verify)
        # clock binding: simulated delays/backoffs ADVANCE this clock in
        # addition to accruing in stats.sim_time_s, so deadline checks and
        # fault latency share one timeline (a no-op on WallClock)
        self.clock = clock

    def _accrue(self, dt: float) -> None:
        self.stats.sim_time_s += dt
        if self.clock is not None and dt:
            self.clock.advance(dt)

    def deliver(
        self,
        schedule: CommSchedule,
        ledger: Optional[CommLedger] = None,
        *,
        max_retries: Optional[int] = None,
        drop_on_exhaust: bool = False,
    ) -> DeliveryReport:
        """Deliver every op; returns the report.  ``max_retries`` overrides
        the plan's (``0`` = fail-fast, the ``fault_policy="fail"`` mode).
        ``drop_on_exhaust=True`` (the ``degrade`` scoring round) records an
        exhausted party in ``report.failed`` and SKIPS its remaining ops in
        this schedule instead of raising :exc:`PartyUnavailable`."""
        plan = self.plan
        retries_cap = plan.max_retries if max_retries is None else int(max_retries)
        stats = self.stats
        failed: Dict[int, DroppedParty] = {}
        units_base = 0
        units_retried = 0
        bits_base = 0
        bits_retried = 0
        retries = 0
        sim0 = stats.sim_time_s
        for op in schedule.ops:
            if op.party in failed:
                continue                     # the party is gone for this round
            attempts = 0
            while True:
                ev = plan.decide(op.tag, op.party, attempts)
                attempts += 1
                stats.attempts += 1
                self._accrue(ev.delay_s)
                if ev.ok:
                    if ledger is not None:
                        if op.down:
                            ledger.server_to_party(op.tag, op.party, op.units,
                                                   op.bits)
                        else:
                            ledger.party_to_server(op.tag, op.party, op.units,
                                                   op.bits)
                    stats.delivered += 1
                    stats.units_base += op.units
                    stats.bits_base += op.bits
                    units_base += op.units
                    bits_base += op.bits
                    break
                # failed transmission: the bytes still crossed the link
                if ledger is not None:
                    rtag = f"retry/{op.tag}"
                    if op.down:
                        ledger.server_to_party(rtag, op.party, op.units,
                                               op.bits)
                    else:
                        ledger.party_to_server(rtag, op.party, op.units,
                                               op.bits)
                stats.units_retried += op.units
                stats.bits_retried += op.bits
                units_retried += op.units
                bits_retried += op.bits
                setattr(stats, {"drop": "drops", "corrupt": "corrupts",
                                "timeout": "timeouts"}[ev.status],
                        getattr(stats, {"drop": "drops", "corrupt": "corrupts",
                                        "timeout": "timeouts"}[ev.status]) + 1)
                if attempts > retries_cap:
                    stats.exhausted += 1
                    if drop_on_exhaust:
                        failed[op.party] = DroppedParty(op.party, op.tag,
                                                       attempts)
                        break
                    raise PartyUnavailable(op.party, op.tag, attempts)
                retries += 1
                stats.retries += 1
                self._accrue(plan.backoff_s(attempts))
        return DeliveryReport(
            units_base=units_base, units_retried=units_retried,
            retries=retries, failed=failed,
            sim_time_s=stats.sim_time_s - sim0,
            bits_base=bits_base, bits_retried=bits_retried,
        )

    def ship(
        self,
        tag: str,
        payloads: Mapping[int, Any],
        ledger: Optional[CommLedger] = None,
        *,
        units: Union[int, Mapping[int, int], None] = None,
        down: bool = False,
        max_retries: Optional[int] = None,
        drop_on_exhaust: bool = False,
        codec: Optional[str] = None,
        encoded: Optional[Mapping[int, bytes]] = None,
    ) -> Tuple[Dict[int, Any], Dict[int, DroppedParty]]:
        """Deliver VALUE payloads under checksummed :class:`WireEnvelope`\\ s.

        The schedule already billed the base message — ``ship`` never bills
        base tags.  What it adds is the integrity seam: each party's payload
        is sealed, silently corrupted per the plan's ``silent_corrupt`` fate
        chain, and — when the transport verifies — every detected mismatch
        is retransmitted and billed under ``retry/<tag>`` with the message's
        full units AND packed bits, the exact :meth:`deliver` convention.
        With verification off the corrupted payload is DELIVERED, the
        attack the value-level validators exist to catch.

        ``codec`` names a :mod:`repro_torch.core.wire` format: the payload is
        packed through it and the envelope seals the ENCODED bytes (the
        CRC covers the compressed payload — corrupting either the scales
        or the quantized words trips it), retries bill the measured packed
        size, and a lossy codec delivers ``decode(encode(payload))`` so
        downstream draws consume exactly what crossed the wire.  ``encoded``
        supplies pre-packed blobs (the round-2 uploads, encoded once when
        the schedule was built) so bits billed == bytes sealed by
        construction.  With ``codec=None`` the envelope seals the raw
        array, the pre-compression behavior.

        ``units`` is the per-party message size (scalar for all, or a
        mapping; default 1 — the round-1 scalar convention).  Returns
        ``(delivered, failed)``: ``delivered`` maps party -> payload, and is
        the ORIGINAL object whenever no corruption fired and the codec is
        value-exact for the payload's dtype (so the clean raw path stays
        bit-identical and free of host/device round-trips); ``failed``
        maps party -> :class:`DroppedParty` for parties whose every
        transmission was corrupted (only with ``drop_on_exhaust=True``;
        otherwise :exc:`PartyUnavailable` raises)."""
        plan = self.plan
        retries_cap = (plan.max_retries if max_retries is None
                       else int(max_retries))
        stats = self.stats
        delivered: Dict[int, Any] = {}
        failed: Dict[int, DroppedParty] = {}
        c = None if codec is None else get_codec(codec)

        def _units(j: int) -> int:
            if units is None:
                return 1
            if isinstance(units, Mapping):
                return int(units.get(j, 1))
            return int(units)

        for j, payload in payloads.items():
            if c is None:
                env = WireEnvelope.seal(tag, j, payload)
                blob = None
                bits_j = UNIT_BITS * _units(j)
            else:
                arr = np.asarray(payload)
                blob = (encoded[j] if encoded is not None and j in encoded
                        else c.encode(arr))
                env = WireEnvelope.seal_bytes(tag, j, blob)
                bits_j = 8 * len(blob)
            attempts = 0
            while True:
                fate = plan.silent_fate(tag, j, attempts)
                attempts += 1
                if fate is not None:
                    stats.silent_corrupts += 1
                if c is None:
                    out = (payload if fate is None
                           else perturb_payload(payload, *fate))
                    ok = not self.verify or env.verify(out)
                else:
                    if fate is None:
                        wire_blob = blob
                        out = (payload if c.exact_for(arr.dtype)
                               else c.decode(blob, arr.shape, arr.dtype))
                    else:
                        p = perturb_payload(arr, *fate)
                        wire_blob = c.encode(p)
                        out = c.decode(wire_blob, p.shape, p.dtype)
                    ok = (not self.verify
                          or env.verify(np.frombuffer(wire_blob, np.uint8)))
                if ok:
                    delivered[j] = out
                    break
                stats.silent_detected += 1
                # detected corruption: the bytes still crossed the link
                u = _units(j)
                if ledger is not None:
                    rtag = f"retry/{tag}"
                    if down:
                        ledger.server_to_party(rtag, j, u, bits_j)
                    else:
                        ledger.party_to_server(rtag, j, u, bits_j)
                stats.units_retried += u
                stats.bits_retried += bits_j
                if attempts > retries_cap:
                    stats.exhausted += 1
                    if drop_on_exhaust:
                        failed[j] = DroppedParty(j, tag, attempts)
                        break
                    raise PartyUnavailable(j, tag, attempts)
                stats.retries += 1
                self._accrue(plan.backoff_s(attempts))
        return delivered, failed


def deliver_or_record(
    schedule: CommSchedule,
    ledger: Optional[CommLedger],
    transport: Optional[Transport],
    *,
    max_retries: Optional[int] = None,
    drop_on_exhaust: bool = False,
) -> DeliveryReport:
    """The one helper every executor bills through: with no transport this
    IS ``schedule.record(ledger)`` (bit-identical entries, zero overhead);
    with one, delivery goes through the fault plan."""
    if transport is None:
        schedule.record(ledger)
        return DeliveryReport(units_base=schedule.total, units_retried=0,
                              retries=0, failed={}, sim_time_s=0.0,
                              bits_base=schedule.total_bits)
    return transport.deliver(schedule, ledger, max_retries=max_retries,
                             drop_on_exhaust=drop_on_exhaust)


# --------------------------------------------------------------------------
# StreamCheckpoint: per-superchunk resume state for the streaming engines
# --------------------------------------------------------------------------

def _to_host(carry):
    """``carry`` (a tensor or a tuple of them) as host numpy copies."""
    if isinstance(carry, tuple):
        return tuple(_to_host(c) for c in carry)
    return np.array(carry.detach().cpu())


def _to_device(carry, dev: torch.device):
    """A saved carry as float32 tensors on ``dev``, bit for bit."""
    if isinstance(carry, tuple):
        return tuple(_to_device(c, dev) for c in carry)
    return torch.from_numpy(carry).to(device=dev, dtype=torch.float32, copy=True)


class StreamCheckpoint:
    """Per-superchunk checkpoint of one streamed or pipelined build.

    The streaming scorers' scan passes are folds over superchunks: saving
    ``(chunks_done, accumulator)`` after every superchunk makes the build
    resumable.  A rerun restores the accumulator bit for bit, continues the
    fold at ``chunks_done``, and every later value (mass table, scores, DIS
    draws) is the uninterrupted build's, because the scan consumes no key:
    the threefry chain is a function of the input key alone.

    ``bind(signature)`` ties the checkpoint to one build's identity (task,
    geometry, knobs, the key's words); a new signature discards stale
    state, so one long-lived store per tenant is safe.  Carries are copied
    to host numpy on :meth:`save`, so they outlive the device, and come
    back as float32 tensors on the build's device on :meth:`load`.  The
    phases are the scorers' passes (``gram`` / ``stats`` / ``mass``).
    """

    def __init__(self) -> None:
        self.signature: Optional[tuple] = None
        self._phases: Dict[str, Tuple[int, Any]] = {}
        self.saves = 0
        self.resumes = 0

    def bind(self, signature: tuple) -> None:
        if self.signature != signature:
            self.signature = signature
            self._phases.clear()

    def save(self, phase: str, chunks_done: int, carry: Any) -> None:
        self._phases[phase] = (int(chunks_done), _to_host(carry))
        self.saves += 1

    def load(self, phase: str, device: DeviceLike = "cuda"
             ) -> Optional[Tuple[int, Any]]:
        """``(chunks_done, carry on device)`` of ``phase``, or None."""
        saved = self._phases.get(phase)
        if saved is None:
            return None
        self.resumes += 1
        return saved[0], _to_device(saved[1], resolve_device(device))

    def clear(self) -> None:
        self.signature = None
        self._phases.clear()

    def __contains__(self, phase: str) -> bool:
        return phase in self._phases
