"""The CoresetPipeline API for the ported engines (port of
:mod:`repro.core.api`).

Party-local scores -> DIS sampling -> importance weights, on three
engines: the materialized engine, with its fused fast path (``jit=True``:
one CUDA graph per shape on the card); the batched engine over a (seeds x
budgets) grid, billed lazily per cell; and the streamed and pipelined
engines (block-scan scoring + hierarchical DIS from a dataset that may stay
in host memory, one block or one superchunk of C blocks at a time,
:mod:`repro_torch.core.streaming`; with ``sharded_masses`` the block-mass
table comes from the ranks of a ``torch.distributed`` process group).  The
single-cell engines record the DIS rounds on a ledger, or deliver them
through a :class:`~repro_torch.core.faults.Transport` (the party fault and
integrity seam: retries, degraded and quarantined builds, wire envelopes
and codecs) under the spec's ``fault_policy``:

  * :class:`CoresetTask` + :func:`register_task` — the task registry
    (``CORESET_TASKS``); shipped here: ``vrlr`` (Algorithm 2), ``vkmc``
    (Algorithm 3) and ``uniform`` (the U-* baseline).
  * :class:`CoresetPipeline` — ``build(spec)`` compiles a
    :class:`~repro_torch.core.plan.CoresetSpec` (through a
    :class:`~repro_torch.core.plan.PlanCache` when it has one) and runs it;
    ``build(checkpoint=)`` makes the streaming engines' passes resumable
    per superchunk; ``build_failover`` walks the plan's engine ladder when
    an engine crashes or breaches its memory budget.
  * :func:`build_coreset` — the shim over a forced materialized spec;
    :func:`build_coreset_jit` — the same with ``jit=True``;
    :func:`build_coresets_batched` — the shim over a batched one, which
    returns a :class:`BatchedCoresets` grid;
    :func:`build_coreset_streaming` — the shim over a pipelined one,
    which the planner lowers to the streamed engine at
    ``chunk_blocks=1, prefetch=False``.

Key choreography matches the reference: the ``vrlr`` score function
passes its key through untouched; ``vkmc`` splits it once per party (the
local k-means++ seeds) and once more for DIS; DIS consumes its key as
:func:`repro_torch.core.dis.dis_plan_full` describes.  Builds run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.comm import CommLedger, CommSchedule
from repro_torch.core.coreset import Coreset
from repro_torch.core.dis import DisPlan, dis_plan_full, split_uploads, uniform_plan
from repro_torch.core.faults import (
    DeadlineExceeded,
    DegradedBuild,
    DroppedParty,
    PartyUnavailable,
    StreamCheckpoint,
    Transport,
)
from repro_torch.core.integrity import (
    IntegrityError,
    check_weights,
    health_from_masses,
    require_valid_masses,
)
from repro_torch.core.plan import (
    SCORE_BACKENDS,
    CoresetSpec,
    ExecutionPlan,
    MemoryWatchdog,
    PlanCache,
    compile_plan,
    live_bytes,
)
from repro_torch.core.streaming import (
    dis_plan_streamed_batched,
    make_stream_scorer,
    vkmc_block_masses_sharded,
    vkmc_local_centers,
    vrlr_block_masses_sharded,
    with_masses,
)
from repro_torch.core.sensitivity import (
    norm_scores,
    total_sensitivity_bound_vkmc,
    total_sensitivity_bound_vrlr,
    vkmc_local_scores,
    vrlr_leverage_stacked,
    vrlr_pinv_stacked,
)
from repro_torch.core.vfl import VFLDataset
from repro_torch.core.vkmc import kmeans_plusplus, lloyd
from repro_torch.core.wire import WirePayload, get_codec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import COUNTED
from repro_torch.utils.registry import Registry

CORESET_TASKS = Registry("coreset_task")


def resolve_backend(backend: str, device: DeviceLike) -> str:
    """Resolve ``"auto"`` from the device the data lives on: ``pallas``
    (the hand-written kernels) for CUDA, ``ref`` for the CPU.  Explicit
    names pass through (and are validated)."""
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "ref"
    if backend not in SCORE_BACKENDS:
        raise ValueError(
            f"unknown score backend {backend!r}; expected 'auto' or one of "
            f"{SCORE_BACKENDS}"
        )
    return backend


def _use_kernel(backend: str) -> bool:
    if backend not in SCORE_BACKENDS:
        raise ValueError(
            f"unknown score backend {backend!r}; expected one of {SCORE_BACKENDS}"
        )
    return backend == "pallas"


# ScoreFn(key, ds, backend=..., **params) -> (scores (T, n), dis_key).
ScoreFn = Callable[..., Tuple[torch.Tensor, rng.Key]]


@dataclasses.dataclass(frozen=True)
class CoresetTask:
    """Declarative spec of one coreset-construction task.

    ``score_fn is None`` marks the uniform baseline: no scores travel, the
    schedule is broadcast-only.  ``deterministic_scores`` says the scores
    do not depend on the key (``vrlr``); ``vkmc`` draws its local seeds.
    The batched engine scores once for all seeds only when it is true.

    ``capture_split`` serves the fused engine on the card, for a score
    function with a step that a CUDA graph cannot hold: a pair
    ``(prologue, body)`` with ``prologue(ds, backend=..., **params)`` ->
    a tuple of tensors, run eagerly on every call, and ``body(key,
    tensors, backend=..., **params)`` -> ``(scores, dis_key)``, captured;
    ``score_fn(key, ds, ...)`` is ``body(key, prologue(ds, ...), ...)``.
    Without it the whole score function is captured.
    """

    name: str
    score_fn: Optional[ScoreFn]
    needs_labels: bool = False
    deterministic_scores: bool = True
    description: str = ""
    capture_split: Optional[Tuple[Callable, Callable]] = None


def register_task(name: str, **spec_kwargs):
    """Decorator: register a score function as task ``name``."""

    def deco(score_fn: ScoreFn) -> ScoreFn:
        CORESET_TASKS.register(name)(
            CoresetTask(name=name, score_fn=score_fn, **spec_kwargs)
        )
        return score_fn

    return deco


def get_task(task: Union[str, CoresetTask]) -> CoresetTask:
    if isinstance(task, CoresetTask):
        return task
    return CORESET_TASKS.get(task)


def _vrlr_prologue(ds: VFLDataset, backend: str = "pallas"):
    """``vrlr``'s steps before the leverage sweep: the stacked view and,
    but for ``norm``, its Gram pseudo-inverses (``eigh``, which reads its
    error flag on the host and so stays out of a CUDA graph)."""
    st = ds.stacked(with_labels=True)
    if backend == "norm":
        return (st.blocks,)
    return vrlr_pinv_stacked(st.blocks)


def _vrlr_body(key, tensors, backend: str = "pallas"):
    """``vrlr``'s capturable rest: the leverage sweep (or the norms)."""
    if backend == "norm":
        (blocks,) = tensors
        return norm_scores(blocks) + 1.0 / blocks.shape[1], key
    f, M = tensors
    return vrlr_leverage_stacked(f, M, use_kernel=_use_kernel(backend)), key


@register_task("vrlr", needs_labels=True,
               capture_split=(_vrlr_prologue, _vrlr_body),
               description="Algorithm 2: per-party ridge-leverage scores + DIS")
def vrlr_scores(key, ds: VFLDataset, backend: str = "pallas"):
    """Algorithm 2 lines 2-3: g_i^(j) = ||u_i^(j)||^2 + 1/n per party, with
    party T scoring [X^(T), y].  Deterministic — the key passes through to
    DIS untouched.  All T parties are scored at once over the padded
    stacked view: batched Gram + eigh, then ONE party-batched ``leverage``
    kernel launch.
    """
    return _vrlr_body(key, _vrlr_prologue(ds, backend), backend)


@register_task("vkmc", deterministic_scores=False,
               description="Algorithm 3: local alpha-approx k-means sensitivities + DIS")
def vkmc_scores(key, ds: VFLDataset, backend: str = "pallas",
                k: int = 10, alpha: float = 2.0, local_iters: int = 15):
    """Algorithm 3: party j runs local k-means (alpha-approximate) and
    scores its block; the key is split once per party and once more for
    DIS — the reference's chain.

    k-means++ runs party by party (each pick draws from 1-D logits); then
    every Lloyd iteration, and the scoring pass, is ONE
    ``kmeans_assign_update`` launch over the (T, n, s) stacked view.  Zero
    column padding is distance-transparent, so the padded blocks give the
    per-party values.
    """
    subs = []
    for _ in range(ds.T):                     # the reference's per-party chain
        key, sub = rng.split(key)
        subs.append(sub)
    key, dis_key = rng.split(key)
    st = ds.stacked()
    if backend == "norm":
        return norm_scores(st.blocks) + 1.0 / ds.n, dis_key
    use_kernel = _use_kernel(backend)
    init = torch.stack([kmeans_plusplus(sub, Xb, k)
                        for sub, Xb in zip(subs, st.blocks)])
    local_c = lloyd(st.blocks, init, iters=local_iters, use_kernel=use_kernel)
    return vkmc_local_scores(st.blocks, local_c, alpha, use_kernel), dis_key


CORESET_TASKS.register("uniform")(
    CoresetTask(name="uniform", score_fn=None,
                description="U-* baseline: uniform indices, weight n/m")
)


# --------------------------------------------------------------------------
# The party fault and integrity seam (the executors' transport hooks)
# --------------------------------------------------------------------------

def _policy_retries(fault_policy: str) -> Optional[int]:
    """``fail`` is fail-fast (one attempt per message); ``retry``/``degrade``
    use the transport plan's own ``max_retries``."""
    return 0 if fault_policy == "fail" else None


def _dropped(failed) -> Tuple[DroppedParty, ...]:
    return tuple(sorted(failed.values(), key=lambda d: d.party))


def _faulted_round1(
    spec: CoresetTask, ds: VFLDataset, transport: Transport,
    ledger: Optional[CommLedger], fault_policy: str,
    payload: Optional[WirePayload] = None,
) -> Tuple[VFLDataset, Optional[list], Optional[DegradedBuild], int, int]:
    """Deliver DIS round 1 through the transport; under ``degrade`` a party
    exhausting its retries here — BEFORE any score travels — is dropped and
    the build continues over the survivors.

    ``payload`` is the wire descriptor of the mass-table row each party's
    G_j upload carries (the bits column only).  Returns ``(effective
    dataset, surviving original party ids or None, DegradedBuild receipt
    or None, round-1 units billed, round-1 bits billed)``.  The label party
    (T-1) is irreplaceable for a labels-bearing task, and losing every
    party is unrecoverable — both re-raise :exc:`PartyUnavailable`."""
    rep = transport.deliver(
        CommSchedule.dis_round1(ds.T, payload=payload), ledger,
        max_retries=_policy_retries(fault_policy),
        drop_on_exhaust=(fault_policy == "degrade"),
    )
    if not rep.failed:
        return ds, None, None, rep.units, rep.bits
    alive = sorted(set(range(ds.T)) - set(rep.failed))
    dropped = _dropped(rep.failed)
    if not alive:
        d = dropped[0]
        raise PartyUnavailable(d.party, d.tag, d.attempts)
    if spec.needs_labels and (ds.T - 1) in rep.failed:
        # labels live ONLY at party T-1; no surviving subset can score vrlr
        d = rep.failed[ds.T - 1]
        raise PartyUnavailable(d.party, d.tag, d.attempts)
    degraded = DegradedBuild(dropped=dropped, surviving=tuple(alive),
                             total_parties=ds.T)
    return ds.select_parties(alive), alive, degraded, rep.units, rep.bits


def _validators_on(fault_policy: str) -> bool:
    """``fail`` and ``quarantine`` run the value-level validators on
    delivered payloads; ``retry``/``degrade`` trust party values (they
    defend availability, not honesty)."""
    return fault_policy in ("fail", "quarantine")


def _task_bound(spec: CoresetTask, eff_ds: VFLDataset, backend: str,
                params: dict) -> Optional[float]:
    """The task's total-sensitivity bound for the validators — Thm 4.2 for
    VRLR (sum of effective widths + T, labels widening party T's block),
    Lemma F.2 for VKMC (2(k+1) alpha T); None for the ``norm`` ablation,
    whose row norms respect no such bound."""
    if backend == "norm":
        return None
    if spec.name == "vrlr":
        dims = list(eff_ds.dims)
        if eff_ds.y is not None:
            dims[-1] += 1
        return total_sensitivity_bound_vrlr(dims, eff_ds.T)
    if spec.name == "vkmc":
        return total_sensitivity_bound_vkmc(
            int(params.get("k", 10)), eff_ds.T,
            float(params.get("alpha", 2.0)))
    return None


def _integrity_round1(
    spec: CoresetTask, eff_ds: VFLDataset, transport: Transport,
    ledger: Optional[CommLedger], fault_policy: str, masses: np.ndarray,
    backend: str, params: dict, codec: str = "raw_fp32",
):
    """The round-1 integrity seam: ship each party's mass row (of the host
    (T_eff, cells) table ``masses``: per-row scores on the materialized
    engine, the (T, nb) block table on the streaming ones) under a
    checksummed :class:`~repro_torch.core.integrity.WireEnvelope`, then run
    the value-level validators on what was DELIVERED, cross-checked against
    the honest per-party totals (the billed G_j scalars).

    Returns ``(delivered table or None, offenders, retry units, retry
    bits)``: the table is None when nothing changed; ``offenders`` (local
    party indices) is nonempty only under ``quarantine`` (validator hits
    under ``fail`` raise a party-attributed :exc:`IntegrityError`).  A lossy
    ``codec`` delivers the quantized table and skips the row-sum cross-check
    (the quantized row cannot match the fp32 scalar); the finiteness,
    sign and bound checks still run."""
    c = get_codec(codec)
    tbl = np.asarray(masses)
    totals = tbl.sum(axis=1)
    rows = {j: tbl[j] for j in range(tbl.shape[0])}
    r0 = transport.stats.units_retried
    b0 = transport.stats.bits_retried
    delivered, failed = transport.ship(
        "dis/round1/G_j", rows, ledger, units=1,
        max_retries=_policy_retries(fault_policy),
        drop_on_exhaust=(fault_policy == "quarantine"), codec=codec)
    retry_units = transport.stats.units_retried - r0
    retry_bits = transport.stats.bits_retried - b0
    changed = any(delivered.get(j) is not rows[j] for j in rows)
    out = (np.stack([np.asarray(delivered.get(j, rows[j]))
                     for j in range(len(rows))])
           if changed else None)
    offenders = set(failed)
    if _validators_on(fault_policy):
        offenders |= set(require_valid_masses(
            tbl if out is None else out,
            totals if c.lossless else None,
            bound=_task_bound(spec, eff_ds, backend, params),
            policy=fault_policy))
    return out, tuple(sorted(offenders)), retry_units, retry_bits


def _quarantine(
    spec: CoresetTask, ds: VFLDataset, alive: Optional[list],
    degraded: Optional[DegradedBuild], offenders: Tuple[int, ...],
    tag: str = "dis/round1/G_j",
) -> Tuple[VFLDataset, list, DegradedBuild]:
    """Fold integrity offenders into the degrade machinery: map local
    offender indices back to original party ids, drop them, and extend the
    :class:`DegradedBuild` receipt with the quarantine reason.  The label
    party is irreplaceable and losing every party is unrecoverable — both
    raise, as in :func:`_faulted_round1`."""
    orig = list(alive) if alive is not None else list(range(ds.T))
    bad = sorted(orig[j] for j in offenders)
    survivors = [p for p in orig if p not in set(bad)]
    if not survivors:
        raise IntegrityError(bad[0], "every party quarantined; no feature "
                                     "slices left to build from", tag=tag)
    if spec.needs_labels and (ds.T - 1) in bad:
        raise IntegrityError(
            ds.T - 1, "label party failed integrity validation; labels "
                      "live only at party T-1, the build cannot continue",
            tag=tag)
    dropped = tuple(degraded.dropped if degraded is not None else ()) + tuple(
        DroppedParty(p, f"quarantine/{tag}", 1) for p in bad)
    reason = (f"part{'y' if len(bad) == 1 else 'ies'} {bad} quarantined "
              f"for integrity violations at {tag!r}")
    receipt = DegradedBuild(
        dropped=tuple(sorted(dropped, key=lambda d: d.party)),
        surviving=tuple(survivors), total_parties=ds.T, reason=reason)
    return ds.select_parties(survivors), survivors, receipt


def _round2_wire(plan: DisPlan, alive: Optional[list], T: int, codec: str):
    """Pre-encode the round-2 index uploads ONCE: the payload descriptors
    (aligned with ``plan.counts``) carry the measured packed bits for
    :meth:`CommSchedule.dis_rounds23`, and the blobs are handed to
    :meth:`Transport.ship` via ``encoded=``, so bits billed equal bytes
    sealed by construction.  Returns (payloads, blobs, counts, ups): the
    counts and the per-party uploads, copied to the host once as int32
    (the reference's index dtype, so envelopes seal the same bytes), go on
    to :func:`_ship_round2`."""
    counts = plan.counts.cpu().numpy()
    ups = split_uploads(plan.indices.cpu().numpy().astype(np.int32), counts)
    orig = list(alive) if alive is not None else list(range(T))
    c = get_codec(codec)
    payloads: list = [None] * len(ups)
    blobs: dict = {}
    for j in range(len(ups)):
        if counts[j] <= 0:
            continue
        blob = c.encode(ups[j])
        blobs[orig[j]] = blob
        payloads[j] = WirePayload.measured(
            ups[j].shape, str(ups[j].dtype), codec, 8 * len(blob))
    return payloads, blobs, counts, ups


def _ship_round2(
    transport: Transport, ledger: Optional[CommLedger], fault_policy: str,
    plan: DisPlan, alive: Optional[list], T: int, counts: np.ndarray,
    ups: list, codec: str = "raw_fp32", blobs: Optional[dict] = None,
):
    """Ship the round-2 index uploads under envelopes, each party's units
    its realized a_j (the sizes ``dis_rounds23`` billed), so detected
    retransmissions land under ``retry/dis/round2/S_up`` at the message's
    true cost.  Returns the realized index vector (corrupted, if the
    transport does not verify) plus the retry units and bits, and raises
    through the weight validator when the policy defends.  ``counts`` and
    ``ups`` are :func:`_round2_wire`'s host copies."""
    orig = list(alive) if alive is not None else list(range(T))
    payloads = {orig[j]: ups[j] for j in range(len(ups)) if counts[j] > 0}
    units = {orig[j]: int(counts[j]) for j in range(len(ups)) if counts[j] > 0}
    r0 = transport.stats.units_retried
    b0 = transport.stats.bits_retried
    delivered, _ = transport.ship(
        "dis/round2/S_up", payloads, ledger, units=units,
        max_retries=_policy_retries(fault_policy), drop_on_exhaust=False,
        codec=codec, encoded=blobs)
    retry_units = transport.stats.units_retried - r0
    retry_bits = transport.stats.bits_retried - b0
    if _validators_on(fault_policy):
        why = check_weights(plan.weights.cpu().numpy())
        if why is not None:
            raise IntegrityError(None, f"realized coreset weights: {why}",
                                 tag="dis/round3/g_scores")
    if not any(delivered[p] is not payloads[p] for p in payloads):
        return plan.indices, retry_units, retry_bits
    parts = [np.asarray(delivered.get(orig[j], ups[j])) for j in range(len(ups))]
    out = torch.as_tensor(np.concatenate(parts).astype(np.int64),
                          device=plan.indices.device)
    return out, retry_units, retry_bits


def _uniform_coreset(S: torch.Tensor, w: torch.Tensor, T: int, m: int,
                     ledger: Optional[CommLedger],
                     transport: Optional[Transport],
                     fault_policy: str) -> Coreset:
    """The uniform baseline's broadcast, recorded, or delivered (under
    ``degrade`` a party that never receives it is named on the receipt)."""
    schedule = CommSchedule.uniform(T, m)
    if transport is None:
        schedule.record(ledger)
        return Coreset(S, w, schedule.total, comm_bits=schedule.total_bits)
    rep = transport.deliver(schedule, ledger,
                            max_retries=_policy_retries(fault_policy),
                            drop_on_exhaust=(fault_policy == "degrade"))
    degraded = None
    if rep.failed:
        alive = sorted(set(range(T)) - set(rep.failed))
        degraded = DegradedBuild(dropped=_dropped(rep.failed),
                                 surviving=tuple(alive), total_parties=T)
    return Coreset(S, w, rep.units, comm_bits=rep.bits, degraded=degraded)


def _require_raw_without_transport(codec: str) -> None:
    if codec != "raw_fp32":
        raise ValueError(
            f"codec={codec!r} quantizes what crosses the wire; without "
            f"a transport nothing crosses it — the recorded path "
            f"supports codec='raw_fp32' only"
        )


def _delivered_coreset(
    plan: DisPlan, m: int, T: int, transport: Transport,
    ledger: Optional[CommLedger], fault_policy: str, codec: str,
    alive: Optional[list], degraded: Optional[DegradedBuild], health,
    units: int, bits: int,
) -> Coreset:
    """Rounds 2-3 through the transport after the draw, then the coreset
    with the composed bill (``units``/``bits``: what round 1 and its
    envelopes already billed).  Rounds 2-3 exhaust hard even under
    ``degrade``: the scores exist by now, and dropping a party would
    orphan its drawn rows."""
    up_payloads, up_blobs, counts, ups = _round2_wire(plan, alive, T, codec)
    rep23 = transport.deliver(
        CommSchedule.dis_rounds23(T, m, counts=counts.tolist(),
                                  parties=alive, upload_payloads=up_payloads),
        ledger, max_retries=_policy_retries(fault_policy),
        drop_on_exhaust=False,
    )
    indices, r2_units, r2_bits = _ship_round2(
        transport, ledger, fault_policy, plan, alive, T, counts, ups,
        codec=codec, blobs=up_blobs)
    return Coreset(indices, plan.weights, units + rep23.units + r2_units,
                   comm_bits=bits + rep23.bits + r2_bits,
                   degraded=degraded, health=health)


# --------------------------------------------------------------------------
# Engine executors — one per ExecutionPlan.engine
# --------------------------------------------------------------------------

def _exec_materialized(
    spec: CoresetTask, ds: VFLDataset, m: int, key, backend: str,
    ledger: Optional[CommLedger], params: dict, fused: bool = False,
    transport: Optional[Transport] = None, fault_policy: str = "fail",
    codec: str = "raw_fp32",
) -> Coreset:
    """The eager engine: scores computed at once, DIS on the full (T, n)
    matrix, the exact per-round bill derived from the realised plan and
    recorded on ``ledger``.

    ``fused`` (``jit=True``) is its fast path: the draw (scoring +
    :func:`dis_plan_full`, or the uniform plan) goes through the builder
    cached for its shapes (:func:`_fused_plan`), one CUDA graph on the
    card, and there is no health report, as in the reference's
    ``_exec_fused``.  The bill is the same.

    With a ``transport`` the DIS rounds are DELIVERED instead of recorded:
    round 1 before scoring (where ``degrade`` can still drop a party, the
    scores then recomputed over the surviving feature slices), the per-row
    score table shipped under envelopes and validated (``quarantine``
    drops an offender and rescores the survivors), rounds 2-3 after the
    draw.  With a null fault plan the draws and ledger entries are bit for
    bit the transportless build's."""
    if spec.needs_labels and ds.y is None:
        raise ValueError(f"{spec.name} requires labels at party T")
    if spec.score_fn is None:
        if fused:
            n = ds.n
            S, w = _fused_builder((spec, n, m, ds.device),
                                  lambda k, _: uniform_plan(k, n, m), key, ())(key, ())
        else:
            S, w = uniform_plan(key, ds.n, m, device=ds.device)
        return _uniform_coreset(S, w, ds.T, m, ledger, transport, fault_policy)

    # the round-1 G_j upload physically carries the per-row mass table —
    # one float32 entry per row on this engine
    r1_payload = WirePayload.of((ds.n,), "float32", codec)
    if transport is None:
        _require_raw_without_transport(codec)
        health = None
        if fused:
            plan = _fused_plan(spec, ds, m, key, backend, params)
        else:
            scores, dis_key = spec.score_fn(key, ds, backend=backend, **params)
            plan = dis_plan_full(dis_key, scores, m)
            health = health_from_masses(scores.cpu().numpy())
        if not bool(plan.totals.sum() > 0):
            raise ValueError("DIS requires a positive total score")
        schedule = CommSchedule.dis(ds.T, m, counts=plan.counts.tolist(),
                                    round1_payload=r1_payload)
        schedule.record(ledger)
        return Coreset(plan.indices, plan.weights, schedule.total,
                       comm_bits=schedule.total_bits, health=health)

    eff_ds, alive, degraded, units1, bits1 = _faulted_round1(
        spec, ds, transport, ledger, fault_policy, payload=r1_payload)
    scores, dis_key = spec.score_fn(key, eff_ds, backend=backend, **params)
    # the per-row score table IS this engine's round-1 mass payload
    delivered, offenders, ship_units, ship_bits = _integrity_round1(
        spec, eff_ds, transport, ledger, fault_policy, scores.cpu().numpy(),
        backend, params, codec=codec)
    if offenders:
        eff_ds, alive, degraded = _quarantine(spec, ds, alive, degraded,
                                              offenders)
        # rescore the survivors; their tables already validated clean
        scores, dis_key = spec.score_fn(key, eff_ds, backend=backend,
                                        **params)
    elif delivered is not None:
        # what crossed the wire drives the draw: a lossy codec's quantized
        # table, or — with verification off — corrupted masses
        scores = torch.as_tensor(delivered, device=scores.device)
    health = health_from_masses(scores.cpu().numpy())
    plan = dis_plan_full(dis_key, scores, m)
    if not bool(plan.totals.sum() > 0):
        raise ValueError("DIS requires a positive total score")
    return _delivered_coreset(plan, m, ds.T, transport, ledger, fault_policy,
                              codec, alive, degraded, health,
                              units1 + ship_units, bits1 + ship_bits)


# (task, dims, labeled?, n, m, backend, params, device, input dtypes) ->
# the cached builder; the uniform task's key is (task, n, m, device)
_JIT_BUILDERS: dict = {}


def _launch_counts() -> Tuple[int, ...]:
    return tuple(fn.launches for fn in COUNTED)


class _CapturedBuild:
    """One build's capturable steps as a CUDA graph, with static buffers
    for its key and input tensors and the launches it holds.

    Made on the first call for a cache key: the body runs once eagerly on
    a side stream (it loads the kernel library and warms cuBLAS and the
    caching allocator), then once under capture into the graph's private
    pool.  Every call copies its key and inputs into the static buffers,
    replays, and returns copies of the outputs (the next replay overwrites
    the static ones).  The kernel wrappers count Python calls, which a
    replay does not make: the launches the capture recorded are taken off
    the counters after the capture (it launched nothing) and added back on
    every replay.  A body that cannot be captured raises."""

    def __init__(self, body: Callable, key: torch.Tensor,
                 inputs: Tuple[torch.Tensor, ...]):
        self.key = key.clone()
        self.inputs = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(self.key, self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = tuple(body(self.key, self.inputs))
        except RuntimeError as e:
            raise RuntimeError(
                "the fused build could not be captured in a CUDA graph (a "
                "step of it synchronises with the host or is not "
                "capturable); build_coreset runs it eagerly") from e
        finally:
            captured = _launch_counts()
            for fn, c in zip(COUNTED, before):
                fn.launches = c
        self.launches = tuple(a - b for a, b in zip(captured, before))

    def __call__(self, key: torch.Tensor, inputs: Tuple[torch.Tensor, ...]):
        self.key.copy_(key)
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.graph.replay()
        for fn, c in zip(COUNTED, self.launches):
            fn.launches += c
        return tuple(t.clone() for t in self.outputs)


def _fused_builder(cache_key, body: Callable, key: torch.Tensor,
                   inputs: Tuple[torch.Tensor, ...]) -> Callable:
    """The cached builder for ``cache_key``, made on first use: a
    :class:`_CapturedBuild` on the card, the eager body on the CPU (as
    ``jax.jit`` runs one compiled program there)."""
    fn = _JIT_BUILDERS.get(cache_key)
    if fn is None:
        fn = _CapturedBuild(body, key, inputs) if key.is_cuda else body
        _JIT_BUILDERS[cache_key] = fn
    return fn


def _fused_plan(spec: CoresetTask, ds: VFLDataset, m: int, key, backend: str,
                params: dict) -> DisPlan:
    """Scoring + :func:`dis_plan_full` through the builder cached per
    ``(task, shapes, backend, params)``: on the card one CUDA graph,
    replayed on every later call (the reference's one jitted dispatch).

    Outside the graph, eagerly: a task's ``capture_split`` prologue before
    the replay (``vrlr``: the stacked view and its Gram pseudo-inverses,
    since ``torch.linalg.eigh`` on the card reads its error flag on the
    host, which a capture refuses), and, in the caller, the positive-total
    check and the bill's ``counts.tolist()`` after it.  Everything else is
    in the graph: ``vrlr``'s leverage sweep (K1); ``vkmc``'s k-means++ (its
    picks by the categorical kernel), Lloyd and scores (K2); both DIS
    rounds (the categorical kernel) and the weights.
    """
    if spec.capture_split is not None:
        prologue, split_body = spec.capture_split
        inputs = tuple(prologue(ds, backend=backend, **params))

        def body(k, tensors):
            scores, dis_key = split_body(k, tensors, backend=backend, **params)
            return dis_plan_full(dis_key, scores, m)
    else:
        T = ds.T
        inputs = tuple(ds.parts) + (() if ds.y is None else (ds.y,))

        def body(k, tensors):
            y = tensors[T] if len(tensors) > T else None
            ds_t = VFLDataset(list(tensors[:T]), y, validate=False)
            scores, dis_key = spec.score_fn(k, ds_t, backend=backend, **params)
            return dis_plan_full(dis_key, scores, m)

    cache_key = (spec, ds.dims, ds.y is not None, ds.n, m, backend,
                 tuple(sorted(params.items())), ds.device,
                 tuple(t.dtype for t in inputs))
    return DisPlan(*_fused_builder(cache_key, body, key, inputs)(key, inputs))


@dataclasses.dataclass(frozen=True)
class BatchedCoresets:
    """A (num_seeds, num_budgets) grid of coresets from one batched build.

    ``indices``/``weights`` are ``(R, M, m_cap)`` with the valid-prefix
    convention: cell (r, i) holds ``ms[i]`` real samples; the padded tail
    has index 0 and weight 0.  ``counts`` carries the realised round-2 a_j
    per cell, so each cell's exact :class:`CommSchedule` is derived after
    the fact.
    """

    indices: torch.Tensor            # (R, M, m_cap) int64
    weights: torch.Tensor            # (R, M, m_cap) float32
    counts: Optional[torch.Tensor]   # (R, M, T) int64; None for the uniform task
    ms: Tuple[int, ...]
    T: int
    cells: int                       # round-1 mass-table entries per party (n)

    @property
    def num_seeds(self) -> int:
        return int(self.indices.shape[0])

    def schedule(self, seed_idx: int, m_idx: int) -> CommSchedule:
        m = self.ms[m_idx]
        if self.counts is None:
            return CommSchedule.uniform(self.T, m)
        return CommSchedule.dis(
            self.T, m, counts=self.counts[seed_idx, m_idx].tolist(),
            round1_payload=WirePayload.of((self.cells,), "float32", "raw_fp32"),
        )

    def coreset(self, seed_idx: int, m_idx: int = 0,
                ledger: Optional[CommLedger] = None) -> Coreset:
        """Extract cell (seed_idx, m_idx) as a plain :class:`Coreset`."""
        m = self.ms[m_idx]
        schedule = self.schedule(seed_idx, m_idx).record(ledger)
        return Coreset(
            self.indices[seed_idx, m_idx, :m],
            self.weights[seed_idx, m_idx, :m],
            schedule.total,
            comm_bits=schedule.total_bits,
        )


def _exec_batched(
    spec: CoresetTask, ds: VFLDataset, ms: Tuple[int, ...], keys: torch.Tensor,
    backend: str, m_cap: int, params: dict,
) -> BatchedCoresets:
    """The batched engine: every (seed, budget) cell of the grid, each a
    :func:`dis_plan_full` at draw capacity ``m_cap`` (the prefix-masking
    convention).  A cell at ``m == m_cap`` is exactly the eager
    :func:`_exec_materialized` result for that key.

    A ``deterministic_scores`` task is scored once for the whole grid, if
    its score function hands the key back unchanged (the contract that
    lets every seed sample from the same scores); the cells then share
    the eager per-party totals.  Any other task is scored once per seed.
    """
    if spec.needs_labels and ds.y is None:
        raise ValueError(f"{spec.name} requires labels at party T")
    if spec.score_fn is None:
        cells = [[uniform_plan(k, ds.n, m, m_cap=m_cap) for m in ms] for k in keys]
        return BatchedCoresets(
            indices=torch.stack([torch.stack([S for S, _ in row]) for row in cells]),
            weights=torch.stack([torch.stack([w for _, w in row]) for row in cells]),
            counts=None, ms=ms, T=ds.T, cells=ds.n)

    hoisted = totals = None
    if spec.deterministic_scores:
        sc0, dk0 = spec.score_fn(keys[0], ds, backend=backend, **params)
        if torch.equal(dk0, keys[0]):
            hoisted = sc0
    if hoisted is not None:
        if not bool(hoisted.sum() > 0):
            raise ValueError("DIS requires a positive total score")
        # the eager per-party totals, the reduction the materialized engine
        # runs, so w = G/(m g) matches its builds bit for bit
        totals = torch.sum(hoisted.to(torch.float32), dim=1)
    plans = []
    for k in keys:
        if hoisted is None:
            sc, dis_key = spec.score_fn(k, ds, backend=backend, **params)
        else:
            sc, dis_key = hoisted, k
        plans.append([dis_plan_full(dis_key, sc, m, m_cap=m_cap, totals=totals)
                      for m in ms])
    S, w, counts = (torch.stack([torch.stack([p[f] for p in row]) for row in plans])
                    for f in (0, 1, 2))
    if not bool(torch.all(w[..., 0] > 0)):
        # w[r, i, 0] = G / (m * g) is positive iff the realised total score G was
        raise ValueError("DIS requires a positive total score")
    return BatchedCoresets(indices=S, weights=w, counts=counts, ms=ms,
                           T=ds.T, cells=ds.n)


def _sharded_mass_table(task_name: str, key, ds: VFLDataset,
                        block_size: int, backend: str, params: dict,
                        device: torch.device,
                        centers: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (T, nb) block-mass table over the ranks of the default process
    group (a world of one without one): see
    :func:`repro_torch.core.streaming.vrlr_block_masses_sharded`.  The
    per-row scores the sampler later recomputes come from the scorer's own
    block path; vkmc's ``centers`` are the ones the scorer is handed (one
    solve for both, on the same key and kernels), so the table matches the
    scorer's up to fp reduction order."""
    if task_name == "vrlr":
        kw = {k: v for k, v in params.items() if k == "rcond"}
        return vrlr_block_masses_sharded(ds, block_size, device=device, **kw)
    if task_name == "vkmc":
        kw = {k: v for k, v in params.items()
              if k in ("k", "alpha", "local_iters", "center_sample")}
        return vkmc_block_masses_sharded(ds, block_size, key=key,
                                         backend=backend, device=device,
                                         centers=centers, **kw)
    raise ValueError(
        f"sharded_masses supports tasks ('vrlr', 'vkmc'), got {task_name!r}"
    )


def _exec_streaming(
    spec: CoresetTask, ds: VFLDataset, m: int, key, backend: str,
    ledger: Optional[CommLedger], probe: Optional[Callable[[], None]],
    block_size: int, chunk_blocks: int, prefetch: bool, params: dict,
    device: torch.device, sharded_masses: bool = False,
    transport: Optional[Transport] = None, fault_policy: str = "fail",
    codec: str = "raw_fp32", checkpoint: Optional[StreamCheckpoint] = None,
) -> Coreset:
    """The streamed and pipelined engines: block-scan scoring +
    hierarchical (party, block) DIS on ``device``, from ``ds`` on the CPU
    or on ``device``.  The passes scan superchunks of ``chunk_blocks``
    blocks (``prefetch``: double-buffered) and the redraw takes the
    touched blocks in groups of that size; the streamed engine is the
    width 1 without prefetch.  ``sharded_masses`` takes the (T, nb) table
    from :func:`_sharded_mass_table` instead of the scorer's mass pass.
    The round-1 upload is the (T, nb) block-mass table, one float32 per
    block per party.

    ``transport`` delivers the DIS rounds through the fault seam as in
    :func:`_exec_materialized`: round 1 before the scorer is built (so
    ``degrade`` drops a party before any pass over the data), the block
    table under envelopes, and a quarantine rebuilds the scorer — and the
    sharded table — over the survivors.  Without one the exact per-round
    bill is recorded on ``ledger``.

    ``checkpoint`` (a :class:`~repro_torch.core.faults.StreamCheckpoint`)
    is bound to this build's signature (task, geometry, knobs, m and the
    key's words) and makes the scorer's passes resumable per superchunk:
    rerun with the same arguments, a crashed build restores the last
    completed superchunk's accumulators and draws what an uninterrupted
    build draws.  It is cleared after the draw.  With ``sharded_masses``
    and ``vkmc`` the party-local centers are solved once, for the table
    and the scorer."""
    if spec.needs_labels and ds.y is None:
        raise ValueError(f"{spec.name} requires labels at party T")
    if spec.score_fn is None:
        S, w = uniform_plan(key, ds.n, m)
        return _uniform_coreset(S, w, ds.T, m, ledger, transport, fault_policy)
    nb = ds.block_geometry(int(block_size))[0]
    r1_payload = WirePayload.of((nb,), "float32", codec)
    if transport is None:
        _require_raw_without_transport(codec)
    alive = degraded = None
    units1 = bits1 = 0
    eff_ds = ds
    if transport is not None:
        eff_ds, alive, degraded, units1, bits1 = _faulted_round1(
            spec, ds, transport, ledger, fault_policy, payload=r1_payload)

    def _build_scorer(eff: VFLDataset):
        masses = centers = None
        kw = dict(params)
        if sharded_masses:
            # task/backend compatibility was validated by compile_plan —
            # every path into this executor goes through the planner
            if spec.name == "vkmc":
                centers, _ = vkmc_local_centers(
                    key, eff, use_kernel=_use_kernel(backend), device=device,
                    **{k: v for k, v in params.items()
                       if k in ("k", "local_iters", "center_sample")})
                kw["centers"] = centers
            masses = _sharded_mass_table(spec.name, key, eff, block_size,
                                         backend, params, device, centers)
        if checkpoint is not None:
            checkpoint.bind((
                spec.name, eff.n, eff.dims, eff.y is not None, int(block_size),
                int(chunk_blocks), bool(prefetch), backend,
                tuple(sorted(params.items())), int(m),
                tuple(key.cpu().tolist()),
            ))
        return make_stream_scorer(spec.name, key, eff, int(block_size), backend,
                                  probe=probe, device=device,
                                  chunk_blocks=chunk_blocks, prefetch=prefetch,
                                  masses=masses, ckpt=checkpoint, **kw)

    scorer = _build_scorer(eff_ds)
    ship_units = ship_bits = 0
    if transport is not None:
        delivered, offenders, ship_units, ship_bits = _integrity_round1(
            spec, eff_ds, transport, ledger, fault_policy,
            scorer.masses.cpu().numpy(), backend, params, codec=codec)
        if offenders:
            eff_ds, alive, degraded = _quarantine(spec, ds, alive, degraded,
                                                  offenders)
            scorer = _build_scorer(eff_ds)  # rescore the survivors
        elif delivered is not None:
            # what crossed the wire drives the draw: the lossy codec's
            # quantized table, or — unverified — a corrupted one
            scorer = with_masses(scorer, delivered)
    conds = None if scorer.gram_conds is None else scorer.gram_conds.cpu().numpy()
    health = health_from_masses(scorer.masses.cpu().numpy(), gram_conds=conds)
    if not bool(scorer.masses.sum() > 0):
        raise ValueError("DIS requires a positive total score")
    plan = dis_plan_streamed_batched(scorer, m, probe=probe)
    if checkpoint is not None:
        checkpoint.clear()            # the build completed; its state is stale
    if transport is not None:
        return _delivered_coreset(plan, m, ds.T, transport, ledger,
                                  fault_policy, codec, alive, degraded, health,
                                  units1 + ship_units, bits1 + ship_bits)
    schedule = CommSchedule.dis(ds.T, m, counts=plan.counts.tolist(),
                                round1_payload=r1_payload)
    schedule.record(ledger)
    return Coreset(plan.indices, plan.weights, schedule.total,
                   comm_bits=schedule.total_bits, health=health)


@dataclasses.dataclass
class CoresetPipeline:
    """The declarative entry point: ``build(spec)`` compiles the spec into
    an :class:`~repro_torch.core.plan.ExecutionPlan` and runs its engine.
    ``build`` also accepts a plan pre-compiled for its dataset and device.

    ``plan_cache`` (a :class:`~repro_torch.core.plan.PlanCache`) memoizes
    ``plan(spec, device)`` by (task, geometry, devices, knobs): the
    serving layer's seam, where one cache shared across tenants makes a
    repeated shape skip compilation."""

    ds: VFLDataset
    plan_cache: Optional[PlanCache] = None

    def plan(self, spec: CoresetSpec,
             device: Optional[DeviceLike] = None) -> ExecutionPlan:
        """``spec`` compiled for a build on ``device`` (default: where the
        dataset lives).  ``build`` runs the plan only on that device."""
        if self.plan_cache is not None:
            return self.plan_cache.get(spec, self.ds, device)
        return compile_plan(spec, self.ds, device)

    def build(
        self,
        spec: Union[CoresetSpec, ExecutionPlan],
        *,
        key: Optional[rng.Key] = None,
        keys: Optional[torch.Tensor] = None,
        ledger: Optional[CommLedger] = None,
        probe: Optional[Callable[[], None]] = None,
        transport: Optional[Transport] = None,
        checkpoint: Optional[StreamCheckpoint] = None,
        device: DeviceLike = "cuda",
    ) -> Union[Coreset, BatchedCoresets]:
        """Build per the (compiled) spec on ``device`` — the card unless
        the caller asks for the CPU.  The streamed and pipelined engines
        take a dataset on the CPU or on ``device`` and compute on
        ``device``; every other engine needs the dataset on ``device``.

        Returns a :class:`Coreset` for single-cell plans and a
        :class:`BatchedCoresets` grid for the batched engine.  ``keys`` (a
        ``(R, 2)`` key stack) overrides ``key`` + ``spec.num_seeds`` for
        the batched engine, which bills its cells lazily
        (``grid.coreset(..., ledger=...)``), so ``ledger`` applies to
        single-cell engines only.  ``probe`` (if given) runs after every
        block (pipelined: superchunk) of the streaming engines' passes and
        after every block (group) of their redraw.

        ``transport`` (a :class:`~repro_torch.core.faults.Transport`)
        delivers the protocol rounds through the party fault seam,
        honouring ``spec.fault_policy``; with no transport — or a null
        fault plan — every engine's draws and ledger entries are bit for
        bit a transportless build's.  ``checkpoint`` (a
        :class:`~repro_torch.core.faults.StreamCheckpoint`) makes the
        streamed and pipelined engines' passes resumable per superchunk:
        rerun with it, a crashed build finishes bit for bit the
        uninterrupted one."""
        dev = resolve_device(device)
        if isinstance(spec, ExecutionPlan):
            ep = spec
            if (ep.n, ep.dims) != (self.ds.n, self.ds.dims):
                raise ValueError(
                    f"plan was compiled for a dataset with n={ep.n}, "
                    f"dims={ep.dims}; this pipeline's dataset has "
                    f"n={self.ds.n}, dims={self.ds.dims} — recompile with "
                    f"plan(spec)"
                )
            if ep.device != dev:
                # the backend, the prefetch default and the engine's
                # lowering were resolved for the plan's device
                raise ValueError(
                    f"plan was compiled for a build on {ep.device}; this "
                    f"build runs on {dev} — recompile with "
                    f"plan(spec, device={str(dev)!r})"
                )
        else:
            ep = self.plan(spec, dev)
        streaming = ep.engine in ("streamed", "pipelined")
        host_stream = streaming and self.ds.device.type == "cpu"
        if self.ds.device != dev and not host_stream:
            raise ValueError(
                f"the dataset lives on {self.ds.device}, the build was asked "
                f"to run on {dev}; build the dataset with device={str(dev)!r}"
                f" (only the streamed and pipelined engines read a dataset "
                f"from the CPU)"
            )
        cspec = ep.spec
        task = get_task(cspec.task)
        if ep.engine == "batched":
            if transport is not None or checkpoint is not None:
                raise ValueError(
                    "the batched engine bills its cells lazily; transport "
                    "delivery and checkpointed resume apply to single-cell "
                    "engines only"
                )
            if keys is None:
                if key is None:
                    raise ValueError("pass either `key` (+ num_seeds) or `keys`")
                keys = rng.split(key, cspec.num_seeds)
            return _exec_batched(task, self.ds, cspec.budgets, keys.to(dev),
                                 ep.backend, ep.m_cap, cspec.params)
        if key is None:
            raise ValueError(f"the {ep.engine} engine requires `key`")
        if streaming:
            return _exec_streaming(task, self.ds, cspec.budget, key.to(dev),
                                   ep.backend, ledger, probe, ep.block_size,
                                   ep.chunk_blocks, ep.prefetch, cspec.params,
                                   dev, sharded_masses=cspec.sharded_masses,
                                   transport=transport,
                                   fault_policy=cspec.fault_policy,
                                   codec=ep.codec, checkpoint=checkpoint)
        if checkpoint is not None:
            raise ValueError(
                "checkpointed resume is a streamed/pipelined-engine "
                "feature; the materialized engine has no superchunk "
                "passes to checkpoint"
            )
        if cspec.jit and transport is not None:
            raise ValueError(
                "the fused jit path cannot deliver per-round schedules "
                "through a transport; use the eager materialized engine "
                "(jit=False)"
            )
        return _exec_materialized(task, self.ds, cspec.budget, key.to(dev),
                                  ep.backend, ledger, cspec.params,
                                  fused=cspec.jit, transport=transport,
                                  fault_policy=cspec.fault_policy,
                                  codec=ep.codec)

    def build_failover(
        self,
        spec: CoresetSpec,
        *,
        key: rng.Key,
        ledger: Optional[CommLedger] = None,
        probe: Optional[Callable[[], None]] = None,
        transport: Optional[Transport] = None,
        checkpoint: Optional[StreamCheckpoint] = None,
        memory_budget_bytes: Optional[int] = None,
        device: DeviceLike = "cuda",
    ) -> "FailoverOutcome":
        """:meth:`build` with the plan's engine failover ladder armed.

        Runs the plan's engine under a
        :class:`~repro_torch.core.plan.MemoryWatchdog` of ``device`` when
        ``memory_budget_bytes`` is given (checked at every probe of the
        streaming engines and once after the build); a breach or an engine
        crash retries once on each remaining rung of
        ``plan.fallback_chain`` (materialized -> pipelined -> streamed).
        The budget counts the build's own bytes, as the planner's
        ``memory_model`` does: the watchdog's baseline is
        :func:`~repro_torch.core.plan.live_bytes` of ``device`` taken once
        at the start (after a ``torch.cuda.synchronize()`` on the card),
        so tensors resident before the call (the caller's, a dataset on
        the card, another tenant's) count against no rung.  A failed rung
        keeps only its error string, so its tensors are freed before the
        next rung starts.  The last rung runs without the watchdog:
        streamed is the minimum-footprint engine.  Every rung runs on
        ``device`` with the same kernels; a kernel that fails to build or
        launch is an engine crash like any other, recorded in
        ``attempts`` and in the winning plan's ``notes``.

        Errors that do not depend on the engine propagate instead of
        burning rungs: :exc:`~repro_torch.core.faults.DeadlineExceeded`
        (the caller's time budget), :exc:`PartyUnavailable` and
        :exc:`IntegrityError` (party-side; a cheaper engine talks to the
        same parties), and ``ValueError`` (spec and geometry validation).

        Each failed attempt is rolled back to a ``ledger.mark()``, then a
        zero-unit ``fallback/<from>-><to>`` entry records the switch, so
        the ledger is the winning engine's bill plus that marker.  The
        checkpoint goes to streaming rungs only; its signature carries the
        engine's knobs, so a rung never resumes another's state.
        """
        watchdog = None
        if memory_budget_bytes is not None:
            dev = resolve_device(device)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            watchdog = MemoryWatchdog(memory_budget_bytes, dev,
                                      baseline=live_bytes(dev))
        first = self.plan(spec, device)
        chain = (first.engine,) + first.fallback_chain
        attempts = []
        tried = set()
        ep = first
        for rung, engine in enumerate(chain):
            if engine in tried:
                continue
            if rung > 0:
                # jit is a materialized/batched-only flag, never valid on
                # the rungs below
                ep = self.plan(dataclasses.replace(spec, engine=engine,
                                                   jit=False), device)
                if ep.engine in tried:     # pipelined may lower to streamed
                    continue
            tried.add(ep.engine)
            last_rung = all(e in tried for e in chain[rung + 1:])
            wd = None if last_rung else watchdog
            mark = None if ledger is None else ledger.mark()
            ckpt = (checkpoint if ep.engine in ("streamed", "pipelined")
                    else None)
            try:
                cs = self.build(ep, key=key, ledger=ledger,
                                probe=_compose_probes(probe, wd),
                                transport=transport, checkpoint=ckpt,
                                device=device)
                if wd is not None:
                    wd.check()     # the materialized engine has no probes
            except (DeadlineExceeded, PartyUnavailable, IntegrityError,
                    ValueError):
                if ledger is not None:
                    ledger.rollback(mark)
                raise
            except Exception as e:
                if ledger is not None:
                    ledger.rollback(mark)
                attempts.append(FailoverAttempt(
                    engine=ep.engine, error=f"{type(e).__name__}: {e}"))
                if last_rung:
                    raise
                continue
            if attempts:
                trail = " -> ".join([a.engine for a in attempts] + [ep.engine])
                ep = dataclasses.replace(ep, notes=ep.notes + (
                    f"failover: {trail} ({attempts[-1].error})",))
                if ledger is not None:
                    ledger.send(f"fallback/{attempts[-1].engine}->{ep.engine}",
                                "server", "server", 0)
            return FailoverOutcome(coreset=cs, plan=ep,
                                   attempts=tuple(attempts))
        raise RuntimeError("unreachable: failover chain exhausted silently")


def _compose_probes(*fns) -> Optional[Callable[[], None]]:
    """Chain probes (the caller's deadline check, the memory watchdog) into
    one hook; None entries drop out."""
    live = [f for f in fns if f is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def probe() -> None:
        for f in live:
            f()
    return probe


@dataclasses.dataclass(frozen=True)
class FailoverAttempt:
    """One failed rung of the ladder: which engine, what stopped it."""

    engine: str
    error: str


@dataclasses.dataclass(frozen=True)
class FailoverOutcome:
    """Result of :meth:`CoresetPipeline.build_failover`: the coreset, the
    plan that produced it (with any failover note appended), and the failed
    attempts in ladder order (empty when the first engine succeeded)."""

    coreset: Coreset
    plan: ExecutionPlan
    attempts: Tuple[FailoverAttempt, ...] = ()

    @property
    def engine(self) -> str:
        return self.plan.engine

    @property
    def fallback(self) -> Optional[str]:
        """``"<first failed>-><winner>"`` when the ladder fired, else None."""
        if not self.attempts:
            return None
        return f"{self.attempts[0].engine}->{self.plan.engine}"


def build_coreset(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    budget: int,
    *,
    key: rng.Key,
    backend: str = "auto",
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = "cuda",
    **params,
) -> Coreset:
    """Build one coreset of ``budget`` rows for ``task`` on ``ds`` — the
    materialized engine (shim over ``CoresetSpec(engine="materialized")``).
    ``backend="auto"`` takes the kernels on the card and the plain
    versions on the CPU."""
    spec = CoresetSpec(task=task, budgets=int(budget),
                       engine="materialized", backend=backend, params=params)
    return CoresetPipeline(ds).build(spec, key=key, ledger=ledger,
                                     device=device)


def build_coreset_jit(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    budget: int,
    *,
    key: rng.Key,
    backend: str = "auto",
    ledger: Optional[CommLedger] = None,
    device: DeviceLike = "cuda",
    **params,
) -> Coreset:
    """One-dispatch :func:`build_coreset` — the materialized engine's fused
    fast path (shim over ``CoresetSpec(engine="materialized", jit=True)``):
    on the card scoring + DIS replay as one CUDA graph, captured on the
    first call for each ``(task, shapes, backend, params)`` and cached (see
    :func:`_fused_plan` for the steps that stay outside it); on the CPU the
    same steps run eagerly.  Indices equal the eager build's; the
    reference holds the weights to fp tolerance."""
    spec = CoresetSpec(task=task, budgets=int(budget),
                       engine="materialized", jit=True, backend=backend,
                       params=params)
    return CoresetPipeline(ds).build(spec, key=key, ledger=ledger,
                                     device=device)


def build_coreset_streaming(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    budget: int,
    *,
    key: rng.Key,
    block_size: int = 65536,
    chunk_blocks: Optional[int] = None,
    prefetch: Optional[bool] = None,
    backend: str = "auto",
    ledger: Optional[CommLedger] = None,
    probe: Optional[Callable[[], None]] = None,
    device: DeviceLike = "cuda",
    **params,
) -> Coreset:
    """Build one coreset with n as a streaming dimension (shim over
    ``CoresetSpec(engine="pipelined")``, as in the reference).

    Block-scan scoring and the hierarchical (party, block) DIS sampler
    from ``ds`` on the CPU or on ``device``.  The defaults
    (``chunk_blocks`` from
    :data:`~repro_torch.core.plan.DEFAULT_CHUNK_BLOCKS`, ``prefetch``
    from :data:`~repro_torch.core.plan.PREFETCH_DEFAULT`) run the
    pipelined engine: superchunks of C blocks, each kernel launched once a
    superchunk, the next one's copy overlapping this one's kernels, and
    the touched blocks redrawn C at a time.  The planner lowers
    ``chunk_blocks=1, prefetch=False`` to the streamed engine, one
    (T, bs, s) block at a time; both draw the same coreset bit for bit.
    With ``block_size >= ds.n`` the draws equal :func:`build_coreset`'s bit
    for bit when the blockwise scores do (the row-local ``norm`` backend).
    """
    spec = CoresetSpec(task=task, budgets=int(budget), engine="pipelined",
                       backend=backend, block_size=block_size,
                       chunk_blocks=chunk_blocks, prefetch=prefetch,
                       params=params)
    return CoresetPipeline(ds).build(spec, key=key, ledger=ledger, probe=probe,
                                     device=device)


def build_coresets_batched(
    task: Union[str, CoresetTask],
    ds: VFLDataset,
    ms: Sequence[int],
    *,
    key: Optional[rng.Key] = None,
    num_seeds: int = 1,
    keys: Optional[torch.Tensor] = None,
    backend: str = "auto",
    m_cap: Optional[int] = None,
    device: DeviceLike = "cuda",
    **params,
) -> BatchedCoresets:
    """Construct coresets for every (seed, budget) pair — the batched
    engine (shim over ``CoresetSpec(engine="batched")``).

    ``ms`` is the budget grid; seeds come either from ``keys`` (a ``(R, 2)``
    key stack) or ``rng.split(key, num_seeds)``.  Budgets below
    ``max(ms)`` use the prefix-masking convention (draws are iid, so a
    prefix of the capacity draw is a valid m-sample); for ``m == max(ms)``
    each cell is exactly the :func:`build_coreset` result for that key.
    ``m_cap`` overrides the draw capacity; every budget must lie in
    [1, m_cap].

    Unlike the reference, whose default is ``backend="ref"`` (its plain
    scores are cheapest on a CPU), ``backend`` defaults to ``"auto"``: on
    the card the grid runs the hand-written kernels, on the CPU the plain
    versions.
    """
    ms = tuple(int(m) for m in ms)
    if keys is not None:
        num_seeds = int(keys.shape[0])
    spec = CoresetSpec(task=task, budgets=ms, num_seeds=num_seeds,
                       engine="batched", backend=backend, m_cap=m_cap,
                       params=params)
    return CoresetPipeline(ds).build(spec, key=key, keys=keys, device=device)
