# tpuc: ignore-file[fabric-mutation-path] — the adoption pass is the ONE
# designated raw-mutation path: it runs post-leader-acquire and
# pre-controller-start, before any shard lease exists to fence against,
# and its verbs are idempotent completion re-reads keyed by the durable
# intent nonce (double-issue is harmless by construction).
"""Cold-start adoption of in-flight fabric intents.
(Port of ``tpu_composer/controllers/adoption.py``.)

A process crash (or hard leader failover) loses every in-memory trace of
fabric work: the dispatcher's lanes and parked outcomes, reconcile workers
mid-call, completion latches. What survives is (a) the durable
``status.pending_op`` intent records the resource controller writes BEFORE
any fabric mutation, and (b) the fabric's own state. This pass — run by the
Manager after leader acquisition and before any controller starts — diffs
the two and classifies every in-flight op, the restart/adoption hard case
composable-orchestration work keeps rediscovering (arXiv:2404.06467 §V,
Funky/arXiv:2510.15755):

==============================  ==========================================
classification                  action
==============================  ==========================================
completed-but-unrecorded add    idempotent completion re-read
                                (``add_resource`` on an attachment the
                                fabric already holds — the reference's
                                ADD_COMPLETE re-scan), fold device ids +
                                cdi id into status, retire the intent
never-issued add                clear the intent; the normal reconcile
                                re-submits with fresh intent and normal
                                attach-budget accounting
fabric-async add in progress    hand to the dispatcher's re-poll pass
                                (submit; the provider's wait sentinel
                                parks it for shared per-node re-polls)
completed-but-unrecorded        retire the intent; the Detaching
remove                          reconcile's idempotent no-op remove
                                finishes the state machine
remove still in flight /        adopt any fabric-known device ids into
not yet effective               status, re-submit through the dispatcher
                                (idempotent), keep the intent
quarantined / deleted owner     retire stale intents without touching the
                                fabric (budget + quarantine accounting is
                                never rewritten by adoption)
==============================  ==========================================

Attach-budget and quarantine accounting are preserved bit-for-bit: adoption
never increments ``attach_attempts``, never quarantines, and never clears
either field — a probe failure simply leaves the retry (and its counting)
to the normal reconcile path, exactly like pre-crash failures that were
only floor-persisted.

With a fabric dispatcher (``dispatcher=``) an add or remove still in
progress is handed to its shared per-node re-poll pass; without one it is
left to the reconcile's own poll timers. With ``shards=`` and
``num_shards=`` the pass is scoped to the keys of those shards: the
shard-acquisition handoff of a sharded control plane. Adoption is the one
designated raw-mutation path: it runs post-leader-acquire (or
post-shard-acquire) and pre-controller-start, and its verbs are idempotent
completion re-reads keyed by the durable intent nonce.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_composer_torch.api.types import (
    ComposableResource,
    RESOURCE_STATE_DETACHING,
)
from tpu_composer_torch.fabric.provider import (
    FabricDevice,
    FabricError,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
)
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import adoption_ops_total
from tpu_composer_torch.runtime.store import ConflictError, NotFoundError, StoreError

log = logging.getLogger("adoption")


@dataclass
class AdoptionReport:
    """What the pass did, by resource name (introspection for logs/tests)."""

    adopted: List[str] = field(default_factory=list)  # results folded into status
    reissued: List[str] = field(default_factory=list)  # intent cleared; reconcile re-submits
    repolled: List[str] = field(default_factory=list)  # handed to dispatcher re-poll
    cleared: List[str] = field(default_factory=list)  # stale/moot intent retired
    deferred: List[str] = field(default_factory=list)  # left to normal reconcile
    errors: List[str] = field(default_factory=list)

    @property
    def total(self) -> int:
        return (
            len(self.adopted) + len(self.reissued) + len(self.repolled)
            + len(self.cleared) + len(self.deferred) + len(self.errors)
        )


def _devices_for(
    res: ComposableResource,
    by_owner: Dict[str, List[FabricDevice]],
    unowned: List[FabricDevice],
) -> List[FabricDevice]:
    """The fabric devices this resource's attach produced, if any.

    Exact when the provider reports ``resource_name`` (InMemoryPool, REST
    pool services with the field); otherwise falls back to matching the
    (slice, node) pair or the device ids already recorded in status —
    providers that report neither classify as not-attached and converge
    through the idempotent re-submit path instead.
    """
    exact = by_owner.get(res.metadata.name)
    if exact:
        return exact
    if res.spec.slice_name:
        return [
            d for d in unowned
            if d.slice_name == res.spec.slice_name
            and d.node == res.spec.target_node
        ]
    if res.status.device_ids:
        known = set(res.status.device_ids)
        return [d for d in unowned if d.device_id in known]
    return []


def adopt_pending_ops(
    store, fabric, dispatcher=None, shards=None, num_shards: int = 1
) -> AdoptionReport:
    """One cold-start pass over every durable ``pending_op`` record.

    Runs post-leader-acquire, pre-controller-start (Manager wiring): by the
    time the first reconcile fires, every surviving intent is either
    resolved into status, cleared for clean re-submission, or already
    re-polling inside the dispatcher (when one is wired).

    With ``shards`` (a set of shard indices) and ``num_shards``, the pass
    is SCOPED: only intents whose resource key hashes into one of the
    given shards are classified. This is the shard-acquisition handoff —
    a shard migration is a cold-start adoption scoped to the moved keys,
    so failover and rebalancing reuse exactly the machinery the
    kill–restart scenarios prove. The default (``shards=None``) scans
    everything, identical to the single-leader pass.
    """
    report = AdoptionReport()
    try:
        resources = store.list(ComposableResource)
    except StoreError as e:
        log.warning("adoption skipped: listing resources failed: %s", e)
        report.errors.append(f"list: {e}")
        return report
    pending = [r for r in resources if r.status.pending_op is not None]
    if shards is not None:
        from tpu_composer_torch.runtime.shards import shard_for

        pending = [
            r for r in pending
            if shard_for(r.metadata.name, num_shards) in shards
        ]
    if not pending:
        return report

    try:
        listing = fabric.get_resources()
    except FabricError as e:
        # Fabric dark at startup: leave every intent in place — the normal
        # reconcile path (breaker + backoff) owns the retry story.
        log.warning("adoption deferred: fabric listing failed: %s", e)
        for r in pending:
            report.deferred.append(r.metadata.name)
            adoption_ops_total.inc(
                verb=r.status.pending_op.verb, outcome="deferred"
            )
        return report

    by_owner: Dict[str, List[FabricDevice]] = {}
    unowned: List[FabricDevice] = []
    for dev in listing:
        if dev.resource_name:
            by_owner.setdefault(dev.resource_name, []).append(dev)
        else:
            unowned.append(dev)

    for res in pending:
        verb = res.status.pending_op.verb
        try:
            # The adoption span JOINS the op's pre-crash trace: the durable
            # nonce is the trace id, so a Perfetto export shows the dead
            # incarnation's reconcile/dispatch spans and this successor's
            # adoption span under one trace_id — the cross-crash continuity
            # the kill–restart soak asserts. The span additionally names
            # the adopting replica so a merged fleet trace reads "intent by
            # A, adopted by B" without decoding pseudo-pids.
            with tracing.span(
                "adopt", cat="adoption", resource=res.metadata.name,
                verb=verb,
                replica=tracing.current_replica() or "",
                ctx=tracing.TraceContext(trace_id=res.status.pending_op.nonce),
            ) as sp:
                outcome = _adopt_one(
                    store, fabric, dispatcher, res,
                    _devices_for(res, by_owner, unowned),
                )
                sp["outcome"] = outcome
        except (ConflictError, NotFoundError):
            # Another writer (a standby that just lost, a racing delete)
            # moved the object — the reconcile path owns it now.
            outcome = "deferred"
        except StoreError as e:
            log.warning("adoption of %s failed: %s", res.metadata.name, e)
            outcome = "error"
            report.errors.append(f"{res.metadata.name}: {e}")
        if outcome != "error":
            getattr(report, {
                "adopted": "adopted", "reissue": "reissued",
                "repoll": "repolled", "cleared": "cleared",
                "deferred": "deferred",
            }[outcome]).append(res.metadata.name)
        adoption_ops_total.inc(verb=verb, outcome=outcome)

    if report.total:
        log.info(
            "adoption: %d intent(s) — %d adopted, %d reissued, %d repolling,"
            " %d cleared, %d deferred, %d errors",
            report.total, len(report.adopted), len(report.reissued),
            len(report.repolled), len(report.cleared), len(report.deferred),
            len(report.errors),
        )
    return report


def _adopt_one(store, fabric, dispatcher, res, devices) -> str:
    """Classify and act on one pending intent; returns the outcome label."""
    po = res.status.pending_op
    name = res.metadata.name

    if po.verb == "add":
        if res.status.quarantined:
            # Terminal until the owner reallocates: never re-probe (let
            # alone re-issue) an attach the budget machinery retired.
            _clear_intent(store, res)
            return "cleared"
        if devices:
            # Completed but unrecorded: the fabric holds the attachment,
            # the crash ate the status write. The idempotent completion
            # re-read returns the full AttachResult (incl. cdi id, which
            # the listing does not carry).
            try:
                result = fabric.add_resource(res)
            except WaitingDeviceAttaching:
                return _hand_to_repoll(dispatcher, "add", res)
            except FabricError as e:
                log.warning("adoption re-read of %s failed: %s", name, e)
                return "deferred"  # intent kept; reconcile retries + counts
            res.status.device_ids = list(result.device_ids)
            res.status.cdi_device_id = result.cdi_device_id
            res.status.pending_op = None
            store.update_status(res)
            log.info("adopted completed attach %s (%d device(s))",
                     name, len(result.device_ids))
            return "adopted"
        if res.being_deleted:
            # Nothing materialized and the owner is going away: retire the
            # intent; the deletion path needs no fabric work. (A fabric
            # async attach that still lands later is the syncer's orphan
            # sweep to reclaim — its grace clock now survives restarts.)
            _clear_intent(store, res)
            return "cleared"
        # Not (visibly) attached: either never issued, or async-in-
        # progress. One direct probe tells them apart — the idempotent
        # contract makes it safe either way, and a sync provider answering
        # with the result is the same terminal state reconcile wanted.
        try:
            result = fabric.add_resource(res)
        except WaitingDeviceAttaching:
            # The fabric is (now) working on it — the dispatcher's shared
            # per-node re-poll pass takes over.
            return _hand_to_repoll(dispatcher, "add", res)
        except FabricError as e:
            # Never issued as far as anyone can prove, and the fabric is
            # not accepting right now: clear the intent so the reconcile
            # re-submits under its own (budget-counted) retry loop.
            log.warning(
                "adoption probe for %s failed (%s); clearing intent for"
                " normal re-submission", name, e,
            )
            _clear_intent(store, res)
            return "reissue"
        res.status.device_ids = list(result.device_ids)
        res.status.cdi_device_id = result.cdi_device_id
        res.status.pending_op = None
        store.update_status(res)
        return "adopted"

    # verb == "remove"
    if devices:
        # Fabric still holds chips for this resource: the detach never
        # became effective (or is async mid-flight). Make sure status
        # knows every id the fabric reports (a crash can predate the id
        # adoption), then re-drive through the dispatcher's re-poll pass.
        known = set(res.status.device_ids)
        fabric_ids = [d.device_id for d in devices]
        if not known.issuperset(fabric_ids):
            res.status.device_ids = sorted(known.union(fabric_ids))
            res = store.update_status(res)
        return _hand_to_repoll(dispatcher, "remove", res)
    # Nothing left at the fabric: the detach completed but the crash ate
    # the Deleting transition. Retire the intent; the Detaching reconcile
    # re-runs its (idempotent) tail and finishes the state machine.
    _clear_intent(store, res)
    if res.status.state == RESOURCE_STATE_DETACHING:
        log.info("detach of %s already effective at the fabric; reconcile"
                 " completes the teardown", name)
    return "cleared"


def _clear_intent(store, res) -> None:
    res.status.pending_op = None
    store.update_status(res)


def _hand_to_repoll(dispatcher, verb, res) -> str:
    """Submit an in-progress op to the dispatcher so its shared per-node
    re-poll pass (not a cold 30s-style requeue) drives it to completion.
    Without a dispatcher the normal reconcile poll timers take over."""
    if dispatcher is None:
        return "deferred"
    try:
        if verb == "add":
            dispatcher.add_resource(res)
        else:
            dispatcher.remove_resource(res)
    except (WaitingDeviceAttaching, WaitingDeviceDetaching):
        pass  # Dispatched*/Waiting* — submission parked, exactly the goal
    return "repoll"
