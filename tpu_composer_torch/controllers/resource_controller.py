"""ComposableResource reconciler — per chip-group attach/online/detach
(port of ``tpu_composer/controllers/resource_controller.py``).

Reference analog: internal/controller/composableresource_controller.go (the
5-state machine at :106-132). State strings and transition order are kept;
the actuation is TPU-native:

  ""        -> finalizer, adopt ready-to-detach labels        (:185-207)
  Attaching -> driver check -> fabric add (wait sentinels) ->
               CDI publish -> visibility poll -> Online       (:209-300)
  Online    -> fabric health poll; deletion -> Detaching      (:302-331)
  Detaching -> load check -> taint -> drain -> fabric remove ->
               CDI retract -> invisibility check -> untaint   (:333-420)
  Deleting  -> remove finalizer                               (:418-434)

TPU-first deltas:
- attach publishes a CDI spec exposing /dev/accel* + libtpu with TPU_*
  coordinate env instead of restarting nvidia daemonsets (:252-286);
- the group's chips are one fabric call, not per-device loops;
- polling quanta are sub-second and configurable (ResourceTiming) instead of
  the fixed 30s/3s requeues (:236,:298,:400);
- with a FabricDispatcher wired (``dispatcher=``), attach/detach SUBMIT and
  return instead of blocking the worker: same-node submissions coalesce
  into group provider calls, and completion re-enqueues this CR
  immediately — the poll quanta above become a safety net rather than the
  requeue clock.

The NVIDIA H100 (``nvidia-h100-sxm``) is composed as a chip group like a
TPU slice member (``topology.is_chip_group_model``): its GPUs get host-local
ordinals, its CDI spec names ``/dev/nvidia<ordinal>`` (which the node agent
rebases onto minors), NVIDIA's control nodes and driver libraries, and
carries the torchrun coordinate env of ``admission/coordinates.slice_env``;
the spec is retracted on detach. Since a job's torchrun reads its world
from that spec (a TPU pod gets its coordinates from the admission webhook
instead), an H100 group re-publishes the spec when its coordinate env
moves, as it does after a live resize of its slice. Other gpu models keep
the loose compat path.

Without a dispatcher, fabric verbs run inline on the worker thread. With
the scheduler's decision ledger wired (``decision_ledger=``), attach
intents join the placement decision that planned them. A breaker's
endpoint-wide rejection (``BreakerOpenError`` without a scope) never burns
a node's attach budget. With a shard ownership view (``ownership=``, a
``runtime.shards.ShardOwnership``), the workers drop keys of shards this
replica does not own, and both fabric write sites fence: a key whose
shard was lost mid-reconcile raises ``ShardFencedError`` before the
fabric sees the verb.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

from tpu_composer_torch.agent.cdi import generate_cdi_spec
from tpu_composer_torch.agent.nodeagent import AgentError, DeviceBusyError, NodeAgent
from tpu_composer_torch.agent.publisher import quarantined_nodes, retire_node
from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.api.types import (
    ANNOTATION_REPLACED_BY,
    ComposabilityRequest,
    ComposableResource,
    FailureRecord,
    FINALIZER,
    LABEL_MANAGED_BY,
    LABEL_READY_TO_DETACH,
    Node,
    PendingOp,
    RESOURCE_STATE_ATTACHING,
    RESOURCE_STATE_DEGRADED,
    RESOURCE_STATE_DELETING,
    RESOURCE_STATE_DETACHING,
    RESOURCE_STATE_EMPTY,
    RESOURCE_STATE_MIGRATING,
    RESOURCE_STATE_ONLINE,
    RESOURCE_STATE_REPAIRING,
)
from tpu_composer_torch.fabric.breaker import BreakerOpenError
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DispatchedAttaching,
    FabricError,
    FabricProvider,
    TransientFabricError,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
    classify_fabric_error,
)
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.contention import ObservedLock
from tpu_composer_torch.runtime.controller import Controller, Result
from tpu_composer_torch.runtime.events import WARNING, EventRecorder
from tpu_composer_torch.runtime.shards import ShardFencedError
from tpu_composer_torch.runtime.metrics import (
    composed_chips,
    fabric_requests_total,
    member_degradations_total,
    reconcile_total,
    resources_quarantined_total,
)
from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    Store,
    StoreError,
    WatchEvent,
    delete_tolerant,
)
from tpu_composer_torch.topology.slices import is_chip_group_model, is_gpu_model


@dataclass
class ResourceTiming:
    """Requeue cadences. Reference fixed values in parens."""

    attach_poll: float = 1.0  # fabric wait-sentinel re-poll (30s, :236)
    visibility_poll: float = 0.5  # chip-enumeration re-poll (30s, :298)
    health_poll: float = 30.0  # Online fabric health cadence (30s, :330)
    detach_poll: float = 1.0  # fabric detach re-poll (30s)
    detach_fast: float = 0.3  # still-visible fast requeue (3s, :400)
    busy_poll: float = 2.0  # device-in-use re-check
    # Attach-attempt budget (fabric resilience layer): consecutive TRANSIENT
    # attach failures tolerated before the resource is quarantined and the
    # owning request reallocates around its node. <= 0 disables (reference
    # behavior: retry the same host forever, requeueOnErr :436-446).
    attach_budget: int = 5
    # -- post-Ready failure detection (self-healing data plane) -----------
    # Consecutive FAILED health probes before an Online member transitions
    # to Degraded (flap damping: a single bad probe writes nothing). The
    # reference records every flip and never acts; <= 1 degrades on the
    # first bad probe.
    health_failure_threshold: int = 3
    # Consecutive HEALTHY probes before a Degraded member returns to Online
    # (the recovery side of the same damping — a brownout lifting must not
    # bounce members Online on one lucky probe).
    health_recovery_threshold: int = 2
    # Poll cadence while Degraded/Repairing (faster than health_poll so
    # recovery and repair completion are observed promptly).
    degraded_poll: float = 5.0
    # Node escalation: this many Degraded transitions on one node within
    # node_degrade_window seconds quarantine the node via the
    # DeviceTaintRule path (distinct reason) so replacements land
    # elsewhere. <= 0 disables.
    node_degrade_threshold: int = 3
    node_degrade_window: float = 600.0


def degrade_member(
    store, publisher, recorder, res: ComposableResource, *,
    reason: str, detail: str, source: str, probes: int = 0,
) -> bool:
    """Shared durable Online -> Degraded transition — the ONE encoding of
    "this attached member's hardware failed" consumed by both detectors
    (the controller's damped health probes and the syncer's device-vanished
    pass): structured failure record + device taints + event + metric, all
    anchored on the same status write. Returns False when the write lost
    (the caller's next pass re-detects from the same fabric state)."""
    res.status.state = RESOURCE_STATE_DEGRADED
    res.status.error = detail
    res.status.failure = FailureRecord(
        reason=reason, detail=detail, source=source,
        observed_at=now_iso(), probe_failures=probes,
    )
    try:
        store.update_status(res)
    except (ConflictError, NotFoundError):
        return False
    if res.status.device_ids:
        publisher.create_taints(
            res.spec.target_node, res.status.device_ids, "degraded"
        )
    member_degradations_total.inc(source=source)
    recorder.event(
        res, WARNING, "Degraded",
        f"{reason} on {res.spec.target_node}: {detail}"
        + (f" ({probes} consecutive failed observations)" if probes else ""),
    )
    return True


class ComposableResourceReconciler(Controller):
    primary_kind = "ComposableResource"
    quiet_exceptions = (FabricError, AgentError, ShardFencedError)

    def __init__(
        self,
        store: Store,
        fabric: FabricProvider,
        agent: NodeAgent,
        timing: Optional[ResourceTiming] = None,
        recorder: Optional[EventRecorder] = None,
        publisher=None,  # DevicePublisher; default built on the store
        decision_ledger=None,  # scheduler.DecisionLedger; None = no joins
        dispatcher=None,  # fabric.dispatcher.FabricDispatcher; None = direct
        ownership=None,  # runtime.shards.ShardOwnership; None = unsharded
    ) -> None:
        super().__init__(store, ownership=ownership)
        # The scheduler's decision ledger (the same instance the request
        # controller's ClusterScheduler records into): attach intents join
        # the placement decision that planned them at mint time. Explicit
        # handle, never the process-global — in-proc multi-replica
        # harnesses run one ledger per replica.
        self.decision_ledger = decision_ledger
        # Fabric I/O pipeline: with a dispatcher, attach/detach SUBMIT and
        # return — the worker thread never blocks on the fabric, same-node
        # submissions coalesce into group calls, and completion re-enqueues
        # this CR's key immediately (the poll timers below stay as the
        # safety net). Without one, fabric verbs run inline.
        self.dispatcher = dispatcher
        self.fabric = fabric
        self.agent = agent
        self.timing = timing or ResourceTiming()
        self.recorder = recorder or EventRecorder()
        if publisher is None:
            from tpu_composer_torch.agent.publisher import DevicePublisher

            publisher = DevicePublisher(store)
        # Scheduler-visible publication + quarantine (the reference's DRA
        # arm: ResourceSlice scan gpus.go:207-239, DeviceTaintRule
        # :894-975). The controller acts as the DRA driver's control side.
        self.publisher = publisher
        # Serializes host-local chip-index assignment across worker threads
        # (two groups landing on one node must get disjoint /dev/accel
        # sets). The lock guards only the in-memory ASSIGNMENT; the status
        # write that persists it happens outside, with _index_claims
        # covering the gap — holding a 10 ms apiserver write under this
        # lock serialized the whole attach wave's durability points.
        self._index_lock = ObservedLock("chip_index")
        # node -> resource name -> indices assigned but not yet persisted.
        # Consulted by _assign_chip_indices so a concurrently-attaching
        # co-located group can never compute an overlapping set while the
        # claimant's status write is in flight. Entries live only for the
        # duration of that write (dropped on success AND failure — a failed
        # write's retry recomputes from fresh store state).
        self._index_claims: dict = {}
        # In-memory attach-failure streaks (resource name -> count), seeded
        # from status.attach_attempts on first observation. Authoritative
        # during a streak: persisting every increment would make each failed
        # reconcile's status write self-trigger an immediate requeue through
        # the primary watch, bypassing the queue's backoff entirely (a
        # breaker-open resource then spins thousands of reconciles/minute).
        # Status is written only when the surfaced error message changes or
        # at quarantine — so a restart resumes the streak from the last
        # persisted floor, not necessarily the exact count.
        self._attach_streaks: dict = {}
        # Health-probe damping (resource name -> consecutive counts). In
        # memory ONLY — by design a transient flip leaves no trace in the
        # store (the debounce this subsystem exists for); a restart simply
        # restarts the window, which can only delay a Degraded transition
        # by < threshold probes.
        self._health_streaks: Dict[str, int] = {}
        # resource name -> the coordinate env its CDI spec was last
        # published with (H100 groups re-publish when it moves).
        self._published_env: Dict[str, Dict[str, str]] = {}
        self._recovery_streaks: Dict[str, int] = {}
        # Node escalation clock: node -> monotonic stamps of recent
        # Degraded transitions there (post-Ready analog of attach streaks),
        # plus the member names already counted this episode (so the
        # level-triggered Degraded handler feeds the clock exactly once
        # per episode, whichever detector wrote the transition).
        self._node_degrades: Dict[str, List[float]] = {}
        self._escalation_counted: set = set()
        # Node deletions GC dependent resources (reference watches nodes via
        # the request controller; we react directly, :137-183).
        self.watch("Node", mapper=self._map_node_event)

    def _map_node_event(self, ev: WatchEvent):
        if ev.type != "DELETED":
            return []
        node = ev.obj.metadata.name
        # Retire the node's circuit breaker + metric series (no-op for
        # providers without per-node breakers, e.g. the bare mock pool),
        # AND its durable quarantine marker: the host left the fleet, and a
        # recreated same-name node is presumptively repaired hardware — it
        # must start allocatable, not inherit the dead node's quarantine
        # forever.
        # Guarded: this mapper runs ONCE per DELETED event and the dispatch
        # loop logs-and-drops mapper exceptions — a transient store/wire
        # fault in the cleanup must not also drop the GC requeue keys
        # below. A failed clear retries: _gc_node_gone re-runs it on every
        # dependent resource's reconcile (queue backoff), and the syncer's
        # stale-quarantine sweep is the level-triggered backstop when no
        # dependents remain — either way the marker cannot permanently
        # exclude a recreated same-name node.
        try:
            retire_node(self.fabric, self.publisher, node)
        except Exception:
            self.log.exception(
                "node %s breaker/quarantine cleanup failed; the reconcile"
                " path and the syncer sweep retry the clear", node
            )
        try:
            return [
                r.metadata.name
                for r in self.store.list(ComposableResource)
                if r.spec.target_node == node
            ]
        except StoreError as e:
            # Same wire fault, worse spot: without the list there is
            # nothing to requeue. Dependent resources self-heal on their
            # own poll requeues / next watch events; losing the fast-path
            # kick must not also kill the dispatch thread's event.
            self.log.error(
                "node %s: listing dependents for GC failed (%s); relying"
                " on per-resource poll requeues", node, e,
            )
            return []

    # ------------------------------------------------------------------
    def reconcile(self, name: str) -> Result:
        res = self.store.try_get(ComposableResource, name)
        if res is None:
            self._attach_streaks.pop(name, None)
            self._health_streaks.pop(name, None)
            self._recovery_streaks.pop(name, None)
            self._escalation_counted.discard(name)
            self._published_env.pop(name, None)
            if self.dispatcher is not None:
                # Drop queued submissions and parked outcomes for a purged
                # CR. An op already at the fabric is left to complete: the
                # verbs are idempotent and the syncer's anti-drift sweep
                # reclaims any attachment that materializes without a CR.
                self.dispatcher.cancel("add", name)
                self.dispatcher.cancel("remove", name)
            return Result()
        # Causal tracing: a durable intent's nonce IS the trace id for that
        # fabric op. Adopting it here back-fills the already-open reconcile
        # span and makes every child span (fabric calls, dispatcher
        # submissions, status writes) part of the same trace — including
        # reconciles of a RESTARTED process, which read the same nonce back
        # from status (the crash-soak's continuity assertion).
        po = res.status.pending_op
        if po is not None and po.nonce:
            tracing.adopt_trace(tracing.TraceContext(trace_id=po.nonce))
        try:
            result = self._reconcile_inner(res)
            reconcile_total.inc(controller="resource", outcome="ok")
            return result
        except (FabricError, AgentError) as e:
            # requeueOnErr analog (:436-446): surface the error in status,
            # then let the queue's backoff retry.
            if not isinstance(e, (WaitingDeviceAttaching, WaitingDeviceDetaching)):
                reconcile_total.inc(controller="resource", outcome="error")
                self._set_error(name, str(e))
            raise

    def _reconcile_inner(self, res: ComposableResource) -> Result:
        if self._gc_node_gone(res):
            return Result(requeue_after=self.timing.detach_fast)

        state = res.status.state
        if state == RESOURCE_STATE_EMPTY:
            return self._handle_none(res)
        if state == RESOURCE_STATE_ATTACHING:
            return self._handle_attaching(res)
        if state == RESOURCE_STATE_ONLINE:
            return self._handle_online(res)
        if state == RESOURCE_STATE_DEGRADED:
            return self._handle_degraded(res)
        if state == RESOURCE_STATE_REPAIRING:
            return self._handle_repairing(res)
        if state == RESOURCE_STATE_MIGRATING:
            return self._handle_migrating(res)
        if state == RESOURCE_STATE_DETACHING:
            return self._handle_detaching(res)
        if state == RESOURCE_STATE_DELETING:
            return self._handle_deleting(res)
        self.log.warning("%s: unknown state %r", res.name, state)
        return Result()

    # ------------------------------------------------------------------
    def _gc_node_gone(self, res: ComposableResource) -> bool:
        """Target node deleted -> clean up and fast-track teardown
        (:137-183: taint cleanup + force Deleting; the fabric side is left to
        the UpstreamSyncer, which will see an orphaned attachment)."""
        if res.status.state in (RESOURCE_STATE_EMPTY, RESOURCE_STATE_DELETING):
            return False
        if self.store.try_get(Node, res.spec.target_node) is not None:
            return False
        if res.metadata.labels.get(LABEL_READY_TO_DETACH):
            # Syncer-created detach-CRs target orphans whose node is often
            # already gone — they MUST still run the detach path (fabric
            # remove needs no live host), else the orphan is never reclaimed
            # and the syncer recreates the CR every grace period.
            return False
        # Idempotent retry of the node-DELETED mapper's one-shot cleanup: if
        # that retirement failed (wire fault), this reconcile — retried
        # under backoff — re-runs it so a recreated same-name node starts
        # allocatable.
        retire_node(self.fabric, self.publisher, res.spec.target_node)
        self.agent.delete_device_taint(res.spec.target_node, res.status.device_ids)
        self.publisher.delete_taints(res.status.device_ids)
        self.publisher.retract_group(
            res.spec.target_node, self._cdi_name(res) or res.name
        )
        self.recorder.event(res, WARNING, "NodeGone",
                            f"target node {res.spec.target_node} deleted")
        if not res.being_deleted:
            res = delete_tolerant(self.store, ComposableResource, res.name)
            if res is None:
                return True  # finalizer-less object purged outright — done
        res.status.state = RESOURCE_STATE_DELETING
        # Any fabric intent is moot: the node is gone and the fabric side
        # is the syncer's to reclaim — a stale record would only make the
        # next cold start probe a dead host.
        res.status.pending_op = None
        try:
            self.store.update_status(res)
        except NotFoundError:
            pass  # purged between the delete and the status PUT — done
        return True

    def _handle_none(self, res: ComposableResource) -> Result:
        if res.add_finalizer(FINALIZER):
            res = self.store.update(res)
        # Adopt a syncer-created detach CR: it carries the leaked device id in
        # a label and exists only to run the detach path
        # (reference :195-202 + :310-315).
        leaked = res.metadata.labels.get(LABEL_READY_TO_DETACH, "")
        if leaked:
            res.status.device_ids = [leaked]
            res.status.state = RESOURCE_STATE_ONLINE
        else:
            # NOT fused into the attach pass (unlike the request's ""
            # state): Attaching must be durably visible before the fabric
            # call — async providers (CM flavor) sit in it for whole
            # requeue cycles and operators watch it.
            res.status.state = RESOURCE_STATE_ATTACHING
            # Durable attach intent rides the SAME write (crash
            # consistency at zero extra RTT): this transition is strictly
            # ordered before any fabric call, so a crash anywhere past
            # this point leaves a record the cold-start adoption pass can
            # classify against fabric.get_resources().
            res.status.pending_op = self._new_intent("add", res)
        self.store.update_status(res)
        return Result(requeue_after=0.0 if not res.being_deleted else self.timing.detach_fast)

    def _handle_attaching(self, res: ComposableResource) -> Result:
        if res.being_deleted:
            # Nothing durable attached yet vs attached-but-not-online —
            # same split as :214-218. With a dispatcher, an attach already
            # issued to the fabric cannot be cancelled: route through
            # Detaching anyway — per-node FIFO queues the (idempotent)
            # detach BEHIND the materializing attach, so whichever chips
            # land are released rather than leaked.
            uncancellable_add = (
                self.dispatcher is not None
                and not self.dispatcher.cancel("add", res.metadata.name)
            )
            res.status.state = (
                RESOURCE_STATE_DETACHING
                if res.status.device_ids or uncancellable_add
                else RESOURCE_STATE_DELETING
            )
            # Replace the attach intent: either a remove intent for the
            # teardown about to run, or nothing (cancelled before the
            # fabric saw it).
            res.status.pending_op = (
                self._new_intent("remove", res)
                if res.status.state == RESOURCE_STATE_DETACHING
                else None
            )
            self.store.update_status(res)
            return Result(requeue_after=self.timing.detach_fast)

        if res.status.quarantined:
            # Terminal until the owner reallocates (which deletes this CR)
            # or the spec changes; retrying here would keep hammering the
            # very attach path that exhausted the budget.
            return Result()

        self.agent.ensure_driver(res.spec.target_node)

        if not res.status.device_ids:
            # Fallback durability point (normally a no-op: "" -> Attaching
            # already wrote the intent). Guards objects created directly in
            # Attaching state and pre-intent objects from older versions.
            res = self._ensure_intent(res, "add")

        try:
            attach = self._fabric_add(res)
            fabric_requests_total.inc(op="add", outcome="ok")
        except DispatchedAttaching:
            # Synthetic dispatcher acknowledgment: the submission is queued
            # or executing but the FABRIC has not answered for this node —
            # the failure streak must survive (only the real wait sentinel
            # below is evidence of fabric-side progress). Completion fires
            # the latch and re-enqueues this key immediately; attach_poll
            # is the safety-net fallback.
            fabric_requests_total.inc(op="add", outcome="dispatched")
            return Result(requeue_after=self.timing.attach_poll)
        except WaitingDeviceAttaching:
            fabric_requests_total.inc(op="add", outcome="waiting")
            # The fabric answered for THIS node — break the failure streak
            # (matching the breaker's view of sentinels), else wire flakes
            # sprinkled across a long async attach would sum to a bogus
            # quarantine of a host whose attach is progressing.
            self._attach_streaks.pop(res.name, None)
            if res.status.attach_attempts:
                res.status.attach_attempts = 0
                try:
                    self.store.update_status(res)
                except (ConflictError, NotFoundError):
                    pass  # bookkeeping only
            return Result(requeue_after=self.timing.attach_poll)
        except TransientFabricError as e:
            fabric_requests_total.inc(op="add", outcome="transient")
            return self._attach_failed(res, e)

        changed = (
            res.status.device_ids != attach.device_ids
            or res.status.cdi_device_id != attach.cdi_device_id
        )
        if changed:
            res.status.device_ids = list(attach.device_ids)
            res.status.cdi_device_id = attach.cdi_device_id
        if res.status.pending_op is not None:
            # Intent fulfilled: the attach outcome lands in status in the
            # same write that retires the record (the crash window between
            # fabric completion and this write is exactly what the
            # adoption pass re-derives from the fabric listing).
            res.status.pending_op = None
            changed = True
        self._attach_streaks.pop(res.name, None)
        if res.status.attach_attempts:
            res.status.attach_attempts = 0  # streak broken by success
            changed = True
        # Chip indices: assignment is serialized under _index_lock, but the
        # persisting status write runs OUTSIDE it — the in-memory claim
        # keeps co-located assigners disjoint during the write, so an
        # 8-host wave's durability points land in parallel instead of
        # queueing behind one lock (safe in-process: exactly one controller
        # instance is active under leader election).
        if is_chip_group_model(res.spec.model):
            claimed = False
            with self._index_lock:
                assigned = self._assign_chip_indices(res)
                if assigned:
                    self._index_claims.setdefault(
                        res.spec.target_node, {}
                    )[res.metadata.name] = list(res.status.chip_indices)
                    claimed = True
                changed = assigned or changed
            try:
                if changed:
                    res = self.store.update_status(res)
            finally:
                if claimed:
                    with self._index_lock:
                        node_claims = self._index_claims.get(res.spec.target_node)
                        if node_claims is not None:
                            node_claims.pop(res.metadata.name, None)
                            if not node_claims:
                                self._index_claims.pop(res.spec.target_node, None)
        elif changed:
            res = self.store.update_status(res)

        # Publish to workloads: CDI spec with the coordinate env (:252-286's
        # replacement): TPU_* for a TPU group, torchrun's for an H100 group,
        # whose device nodes the spec names by model.
        if is_chip_group_model(res.spec.model):
            self._publish_spec(res, self._coordinate_env(res))

        if not self.agent.check_visible(
            res.spec.target_node, res.status.device_ids, group=self._cdi_name(res)
        ):
            return Result(requeue_after=self.timing.visibility_poll)

        # Scheduler-visible publication: the group's chips join the node's
        # ResourceSlice the moment the host enumerates them (reference
        # parity: attached devices appear in slices the operator scans,
        # gpus.go:207-239).
        self.publisher.publish_group(
            res.spec.target_node,
            self._cdi_name(res) or res.name,
            list(res.status.device_ids),
            res.spec.model,
            cdi_device_id=res.status.cdi_device_id,
        )

        res.status.state = RESOURCE_STATE_ONLINE
        res.status.error = ""
        self.store.update_status(res)
        self._refresh_composed_gauge(res.spec.target_node)
        self.recorder.event(res, "Normal", "Attached",
                            f"{len(res.status.device_ids)} chip(s) online on {res.spec.target_node}")
        return Result()

    def _attach_failed(self, res: ComposableResource, err: TransientFabricError) -> Result:
        """Count one transient attach failure against the budget; quarantine
        on exhaustion, otherwise surface the error and let the queue's
        jittered backoff retry (raising keeps requeueOnErr semantics).

        Endpoint-scoped breaker rejections are NOT counted: when the whole
        fabric manager is dark, every node's attach fails instantly, and
        counting those would durably quarantine the entire fleet during a
        brief outage — strictly worse than retry-forever. Only evidence
        against THIS node (real transport failures reaching it, or its own
        node breaker) burns its budget."""
        if isinstance(err, BreakerOpenError) and not err.scope:
            raise err
        name = res.name
        attempts = self._attach_streaks.get(name, res.status.attach_attempts) + 1
        self._attach_streaks[name] = attempts
        budget = self.timing.attach_budget
        msg = str(err)
        if budget > 0 and attempts >= budget:
            if self._quarantine_allowed(res):
                res.status.attach_attempts = attempts
                return self._quarantine(res, msg)
            # Nowhere to route replacement capacity: quarantining the last
            # healthy host would strand the owner in AllocationError —
            # strictly worse than the reference's retry-forever. This is
            # also the stop that keeps an endpoint-wide 5xx storm (which
            # arrives node-attributed as allocation marches through the
            # fleet) from quarantining 100% of capacity. Keep retrying;
            # re-check each failure in case capacity frees up later.
            # Static suffix — embedding the live count would change the
            # message (and thus write status) every failure, re-creating
            # the self-wake hot loop the streak cache exists to prevent.
            msg += (
                " (attach budget exhausted;"
                " quarantine withheld: no other healthy capacity)"
            )
        if res.status.error != msg:
            # Piggyback streak persistence on the writes that happen anyway;
            # identical repeat failures write nothing (see _attach_streaks).
            res.status.attach_attempts = attempts
            res.status.error = msg
            try:
                self.store.update_status(res)
            except (ConflictError, NotFoundError):
                pass  # bookkeeping only — the retry recounts
        # Raise under the SAME surfaced message so the generic requeueOnErr
        # _set_error pass is a no-op instead of clobbering the suffix.
        raise classify_fabric_error(err, msg) from err

    def _quarantine_allowed(self, res: ComposableResource) -> bool:
        """True only when the owner can actually reallocate: quarantining
        without a reallocation target strands it in AllocationError — the
        exact outcome this gate exists to prevent. Two checks:

        - an owner PINNED (spec.resource.target_node) to this node can
          never route elsewhere, whatever other capacity exists;
        - some OTHER node must be eligible by the allocator's own gates
          (ready, schedulable, not quarantined) — mere existence of a
          cordoned/NotReady node is not a reallocation target.
        """
        node = res.spec.target_node
        owner = res.metadata.labels.get(LABEL_MANAGED_BY, "")
        if owner:
            req = self.store.try_get(ComposabilityRequest, owner)
            if req is not None and req.spec.resource.target_node == node:
                return False
        quarantined = quarantined_nodes(self.store)
        return any(
            n.metadata.name != node
            and n.metadata.name not in quarantined
            and n.status.ready and not n.spec.unschedulable
            for n in self.store.list(Node)
        )

    def _quarantine(self, res: ComposableResource, reason: str) -> Result:
        """Attach budget exhausted: durably mark the node + resource
        quarantined so the owning request reallocates onto healthy capacity
        (the DRA-taint arm made real — see publisher.quarantine_node)."""
        node = res.spec.target_node
        self._attach_streaks.pop(res.name, None)
        msg = (
            f"quarantined: {res.status.attach_attempts} consecutive transient"
            f" attach failures on {node}: {reason}"
        )
        self.publisher.quarantine_node(node, msg)
        if res.status.device_ids:
            # A partially-attached group (async flow) also taints its known
            # devices so no scheduler claims them while quarantined.
            self.publisher.create_taints(node, res.status.device_ids, "quarantine")
        res.status.quarantined = True
        res.status.error = msg
        # Quarantine is terminal for the attach path: retire the intent so
        # a restart's adoption pass never re-probes (let alone re-issues)
        # an attach the budget machinery just gave up on.
        res.status.pending_op = None
        self.store.update_status(res)
        resources_quarantined_total.inc(node=node)
        self.recorder.event(res, WARNING, "Quarantined", msg)
        self.log.warning("%s: %s", res.name, msg)
        return Result()  # inert until the owner or operator reacts

    def _assign_chip_indices(self, res: ComposableResource) -> bool:
        """Assign host-local chip indices (/dev/accel<i>, or the H100's GPU
        ordinals) disjoint from every other
        group on the same node. Caller MUST hold _index_lock; the set of
        taken indices is the union of persisted store state and the
        in-flight _index_claims of writes still on the wire. Returns
        whether anything changed.

        Without this, co-located groups would all publish accel0..N-1 and
        hand containers the same physical chips (and deadlock each other's
        drain fd-checks). Assignment is serialized in-process — safe because
        exactly one controller instance is active (leader election)."""
        need = len(res.status.device_ids)
        if len(res.status.chip_indices) == need and need > 0:
            return False
        used = {
            i
            for other in self.store.list(ComposableResource)
            if other.metadata.name != res.metadata.name
            and other.spec.target_node == res.spec.target_node
            for i in other.status.chip_indices
        }
        for claimant, indices in self._index_claims.get(
            res.spec.target_node, {}
        ).items():
            if claimant != res.metadata.name:
                used.update(indices)
        indices: List[int] = []
        candidate = 0
        while len(indices) < need:
            if candidate not in used:
                indices.append(candidate)
            candidate += 1
        res.status.chip_indices = indices
        return True

    def _cdi_name(self, res: ComposableResource) -> str:
        """The CDI publication name for a chip group ('' for gpu compat) —
        the 'group' identity the node agent keys its claims on."""
        if not is_chip_group_model(res.spec.model):
            return ""
        return f"{res.spec.slice_name or res.name}-worker{res.spec.worker_id}"

    def _publish_spec(self, res: ComposableResource, env: Dict[str, str]) -> None:
        """Publish this chip group's CDI spec with ``env`` on its node."""
        spec = generate_cdi_spec(
            slice_name=res.spec.slice_name or res.name,
            worker_id=res.spec.worker_id,
            chip_indices=list(res.status.chip_indices),
            env=env,
            model=res.spec.model,
        )
        self.agent.refresh_device_stack(res.spec.target_node, spec=spec)
        self._published_env[res.name] = env

    def _coordinate_env(self, res: ComposableResource):
        """Coordinate env for this worker's CDI spec (TPU_* for a TPU group,
        torchrun's for an H100 group), sourced from the owning
        request's authoritative status.slice when it exists (coordinate
        consistency, SURVEY.md §7 hard-part #4); standalone CRs fall back to
        their own spec fields."""
        from tpu_composer_torch.admission.coordinates import slice_env
        from tpu_composer_torch.api.types import ComposabilityRequest, LABEL_MANAGED_BY, SliceStatus

        owner = res.metadata.labels.get(LABEL_MANAGED_BY, "")
        if owner:
            req = self.store.try_get(ComposabilityRequest, owner)
            if req is not None and req.status.slice.name:
                return slice_env(req.status.slice, res.spec.worker_id, res.spec.model)
        standalone = SliceStatus(
            name=res.spec.slice_name or res.name,
            topology=res.spec.topology,
            num_hosts=1,
            chips_per_host=res.spec.chip_count,
            worker_hostnames=[res.spec.target_node],
        )
        return slice_env(standalone, res.spec.worker_id, res.spec.model)

    def _new_intent(self, verb: str, res: ComposableResource) -> PendingOp:
        """Fresh durable intent record. The nonce identifies this logical
        op across crash/retry cycles: re-driving an interrupted op keeps
        the persisted nonce, so one fabric mutation traces to exactly one
        intent (the kill–restart harness's double-attach check)."""
        po = PendingOp(
            verb=verb,
            nonce=uuid.uuid4().hex[:12],
            node=res.spec.target_node,
            started_at=now_iso(),
        )
        # The nonce doubles as the trace id: adopt it the moment the intent
        # exists so the transition write and the fabric submission that
        # follow in this same reconcile belong to the op's trace.
        tracing.adopt_trace(tracing.TraceContext(trace_id=po.nonce))
        if verb == "add" and self.decision_ledger is not None:
            # Join the placement decision that planned this worker: the
            # ledger's pending flow handle becomes the Perfetto arrow
            # scheduler.decide -> this reconcile's span, and the nonce is
            # recorded on the decision so /debug/scheduler/explain shows
            # which intents executed it.
            self.decision_ledger.link_decision(
                res.metadata.labels.get(LABEL_MANAGED_BY, ""), po.nonce
            )
        return po

    def _ensure_intent(
        self, res: ComposableResource, verb: str
    ) -> ComposableResource:
        """Make sure a durable ``pending_op`` record for ``verb`` exists
        BEFORE the fabric sees the op. No-op (no write) when the record is
        already present — the state-transition writes normally carry it,
        so this costs a round trip only on unusual entry paths."""
        po = res.status.pending_op
        if po is not None and po.verb == verb:
            return res
        res.status.pending_op = self._new_intent(verb, res)
        return self.store.update_status(res)

    def _fence_check(self, res: ComposableResource) -> None:
        """End-to-end shard fencing at the fabric write boundary: the
        worker-side ownership filter stops NEW reconciles for unowned
        keys, but ownership can flip mid-reconcile (a shard lease fenced
        between dequeue and the fabric call) — the mutation itself is the
        last point the invariant can be enforced. The durable intent
        already written stays put; the shard's new owner resolves it via
        scoped adoption."""
        if self.ownership is not None and not self.ownership.owns_key(
            res.metadata.name
        ):
            raise ShardFencedError(
                f"{res.metadata.name}: shard no longer owned by this"
                " replica; mutation fenced"
            )

    def _fabric_add(self, res: ComposableResource):
        """Attach via the dispatcher (submit-and-return + completion latch)
        or inline when batching is disabled."""
        self._fence_check(res)
        if self.dispatcher is None:
            return self.fabric.add_resource(res)
        name = res.metadata.name
        if res.status.device_ids and self.dispatcher.op_state("add", name) is None:
            # Visibility-poll re-entry: the durable attach result already
            # sits in status and nothing is in flight — serving it skips a
            # fresh batch window + idempotent provider re-read per poll
            # cycle. A fabric-side loss of the attachment in this window
            # surfaces the same way the direct path's between-re-adds gap
            # does: via Online health polling / the anti-drift syncer.
            return AttachResult(
                list(res.status.device_ids), res.status.cdi_device_id
            )
        return self.dispatcher.add_resource(
            res, on_ready=lambda: self.queue.add(name)
        )

    def _fabric_remove(self, res: ComposableResource) -> None:
        self._fence_check(res)
        if self.dispatcher is None:
            return self.fabric.remove_resource(res)
        name = res.metadata.name
        # Migration/repair-ordered op pair: a source member that has a
        # named replacement parks its detach behind the replacement's
        # attach at the DISPATCHER level — even if controller sequencing
        # raced (crash replay, adoption re-drives), the fabric can never
        # see the source release before the target attach settled. A
        # replacement already settled (or unknown to this process) imposes
        # no wait.
        after = None
        repl = res.metadata.annotations.get(ANNOTATION_REPLACED_BY, "")
        if repl:
            after = ("add", repl)
        return self.dispatcher.remove_resource(
            res, on_ready=lambda: self.queue.add(name), after=after
        )

    def fabric_attached(self, node: str) -> Optional[List]:
        """Devices the fabric reports attached to ``node`` — or ``None``
        when the fabric is unreachable. The two outcomes MUST stay
        distinguishable: swallowing the error into ``[]`` made "fabric
        blip" identical to "no devices attached", and every caller that
        refreshed a gauge or reasoned about emptiness silently zeroed out
        on a wire flake.

        Dispatcher-served listings are single-flighted and snapshot-cached
        (staleness bounded by its batch window) — an attach wave's
        per-node gauge refreshes share one provider call."""
        provider = self.dispatcher if self.dispatcher is not None else self.fabric
        try:
            return [d for d in provider.get_resources() if d.node == node]
        except FabricError as e:
            self.log.debug("fabric listing for %s unavailable: %s", node, e)
            return None  # stale — callers must not treat as empty

    def _refresh_composed_gauge(self, node: str) -> None:
        """Level-set tpuc_composed_chips for one node; a fabric blip keeps
        the last known value instead of zeroing the gauge."""
        attached = self.fabric_attached(node)
        if attached is not None:
            composed_chips.set(len(attached), node=node)

    def _begin_teardown(self, res: ComposableResource) -> Optional[Result]:
        """Shared deletion/ready-to-detach entry for the attached states
        (Online/Degraded/Repairing): route to Detaching with a durable
        remove intent. Returns None when teardown is not requested."""
        if not (
            res.being_deleted or res.metadata.labels.get(LABEL_READY_TO_DETACH)
        ):
            return None
        if not res.being_deleted:
            # Syncer detach-CR: begin teardown immediately (:310-315).
            res = delete_tolerant(self.store, ComposableResource, res.name)
            if res is None:
                return Result()  # already purged — nothing left to detach
        res.status.state = RESOURCE_STATE_DETACHING
        # Durable detach intent rides the transition write, ordered
        # before any fabric remove.
        res.status.pending_op = self._new_intent("remove", res)
        try:
            self.store.update_status(res)
        except NotFoundError:
            return Result()  # purged concurrently — teardown already won
        return Result(requeue_after=self.timing.detach_fast)

    def _handle_online(self, res: ComposableResource) -> Result:
        teardown = self._begin_teardown(res)
        if teardown is not None:
            return teardown

        name = res.name
        if is_gpu_model(res.spec.model):
            # A TPU pod takes its coordinates from the admission webhook
            # (off status.slice); an H100 job's torchrun reads them from
            # the CDI spec. After a live resize the survivors' specs must
            # carry the new world, so an H100 group re-publishes when its
            # coordinate env moved.
            env = self._coordinate_env(res)
            if env != self._published_env.get(name):
                self._publish_spec(res, env)
        health = self.fabric.check_resource(res)
        fabric_requests_total.inc(op="check", outcome=health.state.lower())
        if health.healthy:
            self._health_streaks.pop(name, None)
            if res.status.error:
                # Clear a stale surfaced error (e.g. from the attach path);
                # written only when something was actually there.
                res.status.error = ""
                try:
                    self.store.update_status(res)
                except (ConflictError, NotFoundError):
                    pass  # bookkeeping only
            return Result(requeue_after=self.timing.health_poll)

        # Flap damping: a failed probe below the threshold writes NOTHING —
        # no status update, no event. A flapping probe must not spam the
        # store and event log (the reference rewrote status on every flip).
        streak = self._health_streaks.get(name, 0) + 1
        self._health_streaks[name] = streak
        threshold = max(1, self.timing.health_failure_threshold)
        if streak < threshold:
            return Result(requeue_after=self.timing.health_poll)
        return self._degrade(
            res,
            reason="health-probe",
            detail=f"fabric health {health.state}: {health.detail}",
            source="health-probe",
            probes=streak,
        )

    def _degrade(
        self, res: ComposableResource, *, reason: str, detail: str,
        source: str, probes: int,
    ) -> Result:
        """Durable Online -> Degraded transition (shared degrade_member
        encoding) plus the controller-local bits: streak reset and the
        node-escalation clock."""
        name = res.name
        self._health_streaks.pop(name, None)
        self._recovery_streaks.pop(name, None)
        if not degrade_member(
            self.store, self.publisher, self.recorder, res,
            reason=reason, detail=detail, source=source, probes=probes,
        ):
            # Lost the write — the next reconcile re-detects from the same
            # fabric state (streak restarts; strictly a delay, never a miss
            # for a persistent failure).
            return Result(requeue_after=self.timing.health_poll)
        self.log.warning("%s: degraded (%s): %s", name, source, detail)
        self._escalation_counted.add(name)
        self._note_node_degrade(res)
        return Result(requeue_after=self.timing.degraded_poll)

    def _note_node_degrade(self, res: ComposableResource) -> None:
        """Escalation clock: repeated post-Ready failures on one node mean
        the HOST (fabric port, PCIe path, cooling) is the problem, not the
        chips — quarantine it via the DeviceTaintRule path (distinct
        reason) so replacement capacity lands elsewhere. Same guard as the
        attach-budget quarantine: never taint the last healthy node."""
        threshold = self.timing.node_degrade_threshold
        if threshold <= 0:
            return
        node = res.spec.target_node
        now = time.monotonic()
        window = self.timing.node_degrade_window
        hits = self._node_degrades.setdefault(node, [])
        hits.append(now)
        hits[:] = [t for t in hits if now - t <= window]
        if len(hits) < threshold:
            return
        quarantined = quarantined_nodes(self.store)
        if node in quarantined:
            return
        others = any(
            n.metadata.name != node
            and n.metadata.name not in quarantined
            and n.status.ready and not n.spec.unschedulable
            for n in self.store.list(Node)
        )
        if not others:
            # Quarantining the last healthy host strands every owner in
            # AllocationError — same stop as the attach-budget path.
            return
        msg = (
            f"post-ready-failures: {len(hits)} member degradations on"
            f" {node} within {window:.0f}s (last: {res.status.error})"
        )
        self.publisher.quarantine_node(node, msg)
        resources_quarantined_total.inc(node=node)
        self.recorder.event(res, WARNING, "NodeQuarantined", msg)
        self.log.warning("node %s: %s", node, msg)
        hits.clear()

    def _handle_degraded(self, res: ComposableResource) -> Result:
        teardown = self._begin_teardown(res)
        if teardown is not None:
            return teardown

        name = res.name
        # Degrades written by other detectors (the syncer's device-vanished
        # pass) reach this handler via the watch without ever passing
        # _degrade — feed the node-escalation clock here, once per episode
        # (the in-memory set restarts with the process; re-counting a
        # still-degraded member once after a restart is conservative).
        if name not in self._escalation_counted:
            self._escalation_counted.add(name)
            self._note_node_degrade(res)
            # Level re-assert of the "degraded" device taints, once per
            # episode per process: degrade_member creates them AFTER the
            # status commit, so a store fault there (or a crash between
            # the two) would otherwise leave sick chips advertised to
            # schedulers forever. create_taints is idempotent.
            if res.status.device_ids:
                self.publisher.create_taints(
                    res.spec.target_node, res.status.device_ids, "degraded"
                )

        # A device-vanished degrade recovers on LISTING evidence, which the
        # syncer owns: the per-attachment health probe can answer OK while
        # the attachment is gone from get_resources() — the exact drift
        # that detector exists for. Probe-based recovery here would flip
        # the member Online, the syncer would re-degrade it next pass, and
        # the livelock would churn events forever while the repair driver's
        # healthy-probe last-look kept skipping it.
        fr = res.status.failure
        if fr is not None and fr.source == "syncer":
            return Result(requeue_after=self.timing.degraded_poll)

        # Recovery probing (damped like detection): a Degraded member whose
        # fabric health returns — e.g. a brownout lifting while the repair
        # breaker held repairs frozen — goes back to Online instead of
        # being detached.
        health = self.fabric.check_resource(res)
        fabric_requests_total.inc(op="check", outcome=health.state.lower())
        if health.healthy:
            streak = self._recovery_streaks.get(name, 0) + 1
            if streak >= max(1, self.timing.health_recovery_threshold):
                self._recovery_streaks.pop(name, None)
                # Taints first: if this raises (store fault) the member
                # stays Degraded and the whole recovery retries — ordered
                # the other way, a fault after the commit would strand
                # stale "degraded" taints on healthy chips until detach.
                self.publisher.delete_taints(res.status.device_ids)
                res.status.state = RESOURCE_STATE_ONLINE
                res.status.error = ""
                res.status.failure = None
                try:
                    self.store.update_status(res)
                except (ConflictError, NotFoundError):
                    return Result(requeue_after=self.timing.degraded_poll)
                # Only a COMMITTED recovery ends the episode: dropping the
                # escalation mark before the write could double-count one
                # real failure into the node clock when the write loses.
                self._escalation_counted.discard(name)
                self.recorder.event(
                    res, "Normal", "Recovered",
                    f"fabric health recovered after {streak} consecutive"
                    " healthy probes",
                )
                return Result(requeue_after=self.timing.health_poll)
            self._recovery_streaks[name] = streak
        else:
            self._recovery_streaks.pop(name, None)
        return Result(requeue_after=self.timing.degraded_poll)

    def _handle_repairing(self, res: ComposableResource) -> Result:
        """A member the repair driver committed to replacing: inert here —
        the owning request watches the replacement and deletes this member
        after the drain grace. Deletion (and node-gone GC) still route
        through the normal teardown."""
        teardown = self._begin_teardown(res)
        if teardown is not None:
            return teardown
        return Result(requeue_after=self.timing.degraded_poll)

    def _handle_migrating(self, res: ComposableResource) -> Result:
        """A HEALTHY member the migration driver is moving: it keeps
        serving (and keeps its damped health watch — migration is not
        immunity) while its replacement attaches; the owning request
        performs the cutover and the post-grace detach. A member that
        fails mid-move transitions Degraded and the repair driver takes
        over — its 1b pass finds the already-live replacement via the
        replaces annotation and completes the swap as a repair."""
        teardown = self._begin_teardown(res)
        if teardown is not None:
            return teardown
        name = res.name
        if is_gpu_model(res.spec.model):
            # A TPU pod takes its coordinates from the admission webhook
            # (off status.slice); an H100 job's torchrun reads them from
            # the CDI spec. After a live resize the survivors' specs must
            # carry the new world, so an H100 group re-publishes when its
            # coordinate env moved.
            env = self._coordinate_env(res)
            if env != self._published_env.get(name):
                self._publish_spec(res, env)
        health = self.fabric.check_resource(res)
        fabric_requests_total.inc(op="check", outcome=health.state.lower())
        if health.healthy:
            self._health_streaks.pop(name, None)
            return Result(requeue_after=self.timing.degraded_poll)
        streak = self._health_streaks.get(name, 0) + 1
        self._health_streaks[name] = streak
        if streak < max(1, self.timing.health_failure_threshold):
            return Result(requeue_after=self.timing.degraded_poll)
        return self._degrade(
            res,
            reason="health-probe",
            detail=f"fabric health {health.state}: {health.detail}",
            source="health-probe",
            probes=streak,
        )

    def _handle_detaching(self, res: ComposableResource) -> Result:
        node = res.spec.target_node
        # A gone node has no device stack to drain — skip the host-side steps
        # and run only the fabric detach (the syncer's orphan-reclaim case).
        node_exists = self.store.try_get(Node, node) is not None
        # 1. Load check unless force (:340-353).
        # Dispatcher fast path: once a remove is submitted (or its outcome
        # is parked awaiting consumption), the host-side prep below already
        # ran in the submitting pass — re-entries driven by the completion
        # latch / detach_poll must not re-pay the load check, taint writes
        # and drain every cycle.
        remove_submitted = (
            self.dispatcher is not None
            and self.dispatcher.op_state("remove", res.metadata.name) is not None
        )
        if not res.spec.force_detach and node_exists and not remove_submitted:
            if not self.agent.check_no_loads(node, res.status.device_ids, group=self._cdi_name(res)):
                msg = f"chips in use on {node}; waiting for workloads to finish"
                if res.status.error != msg:
                    res.status.error = msg
                    res = self.store.update_status(res)
                    self.recorder.event(res, WARNING, "DeviceBusy", msg)
                return Result(requeue_after=self.timing.busy_poll)

        if node_exists and not remove_submitted:
            # 2. Quarantine scheduling (:355-363 via DeviceTaintRule): both
            # the node-local marker the agent's drain honors and the
            # cluster-level rule a scheduler sees.
            self.agent.create_device_taint(node, res.status.device_ids, "detaching")
            self.publisher.create_taints(node, res.status.device_ids, "detaching")

            # 3. Drain the host device stack (:365-379).
            try:
                self.agent.drain(node, res.status.device_ids,
                                 force=res.spec.force_detach, group=self._cdi_name(res))
            except DeviceBusyError:
                return Result(requeue_after=self.timing.busy_poll)

        # Fallback durability point (normally a no-op: every transition
        # into Detaching piggybacks the remove intent on its own write).
        if not remove_submitted:
            res = self._ensure_intent(res, "remove")

        # 4. Fabric detach with wait sentinel (:372-378). DispatchedDetaching
        # (the dispatcher's submit-and-return acknowledgment) subclasses the
        # wait sentinel: same requeue, but completion re-enqueues this key
        # immediately so detach_poll is only the fallback.
        try:
            self._fabric_remove(res)
            fabric_requests_total.inc(op="remove", outcome="ok")
        except WaitingDeviceDetaching:
            fabric_requests_total.inc(op="remove", outcome="waiting")
            return Result(requeue_after=self.timing.detach_poll)

        if node_exists:
            # 5. Retract workload publication (:380-391). The publish name is
            # slice_name-or-resource-name + worker id, matching what
            # _handle_attaching published.
            if is_chip_group_model(res.spec.model):
                self.agent.refresh_device_stack(node, remove_name=self._cdi_name(res))
            self.publisher.retract_group(node, self._cdi_name(res) or res.name)

            # 6. Chips must stop enumerating before we declare success
            # (:393-401, 3s fast requeue in the reference; ours is
            # timing.detach_fast).
            if res.status.device_ids and self.agent.check_visible(
                node, res.status.device_ids, group=self._cdi_name(res)
            ):
                return Result(requeue_after=self.timing.detach_fast)

            # 7. Cleanup (:404-415).
            self.agent.delete_device_taint(node, res.status.device_ids)
            self.publisher.delete_taints(res.status.device_ids)
        res.status.device_ids = []
        res.status.cdi_device_id = ""
        res.status.chip_indices = []
        res.status.error = ""
        res.status.pending_op = None  # detach outcome recorded; intent retired
        res.status.state = RESOURCE_STATE_DELETING
        try:
            self.store.update_status(res)
        except NotFoundError:
            pass  # purged concurrently — the fabric release still happened
        self._refresh_composed_gauge(node)
        self.recorder.event(res, "Normal", "Detached", f"released from {node}")
        return Result(requeue_after=self.timing.detach_fast)

    def _handle_deleting(self, res: ComposableResource) -> Result:
        if not res.being_deleted:
            # GC-forced teardown finished but nobody asked the store to
            # delete the object yet — do it ourselves.
            res = delete_tolerant(self.store, ComposableResource, res.name)
            if res is None:
                return Result()  # purged concurrently — deletion complete
        if res.remove_finalizer(FINALIZER):
            try:
                self.store.update(res)  # purges (last finalizer, terminating)
            except NotFoundError:
                # Purged between the cache read and the PUT (e.g. a stale
                # watch-cache copy still carrying the finalizer after the
                # server already released the object) — deletion is complete.
                # 404 here means success.
                pass
        return Result()

    def _set_error(self, name: str, msg: str) -> None:
        res = self.store.try_get(ComposableResource, name)
        if res is None or res.status.error == msg:
            return
        res.status.error = msg
        try:
            self.store.update_status(res)
        except (ConflictError, NotFoundError):
            pass  # stale read or object gone — next reconcile re-surfaces it
