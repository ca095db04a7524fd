"""ComposabilityRequest reconciler — request-level state machine + allocator
(port of ``tpu_composer/controllers/request_controller.py``).

Reference analog: internal/controller/composabilityrequest_controller.go
(6-state machine at :108-142). State strings preserved:

  ""             -> finalizer; NodeAllocating                  (:197-211)
  NodeAllocating -> keep/discard children, deletion priorities,
                    node selection, placeholders; Updating     (:213-485)
  Updating       -> create/delete children; all Online->Running(:487-560)
  Running        -> spec-drift + child-health watch            (:562-586)
  Cleaning       -> delete children until none; Deleting       (:588-612)
  Deleting       -> remove finalizer                           (:614-625)

TPU-first deltas (SURVEY.md §5/§7):
- ``type: tpu`` requests are solved into a *connected slice shape*
  (topology.solve_slice) and placed all-or-nothing: one ComposableResource
  per host carrying (slice_name, worker_id, chip_count, topology), with the
  fabric reservation made atomically up front (reserve_slice) and rolled back
  on allocation failure — the reference's one-device-at-a-time fan-out
  (:361-467) cannot express this and deadlocks a slice at 31/32 chips
  (SURVEY.md §7 hard-part #1);
- losing a slice member (node death) invalidates the ICI topology, so Running
  re-enters NodeAllocating for a full re-solve instead of patching one child;
- the authoritative TPU_* coordinates (worker hostnames, topology) land in
  status.slice for the admission webhook to inject consistently;
- attach-to-Ready latency is observed into the histogram the reference never
  had (BASELINE.md).

gpu/cxlmemory requests keep the reference's independent-device semantics
(BASELINE.json config[0] compatibility).

Placement is DELEGATED: the node-picking logic that used to live inline here
(_pick_nodes / _pick_extra_nodes / _used_slots_map) moved to
``scheduler/`` — this controller asks the ClusterScheduler
where a slice goes (priority arbitration, gang admission, preemption) and
executes the decision: writing placeholders, reserving the fabric, and —
when the scheduler names victims — driving their eviction through the same
child-delete / re-solve paths every other disruption uses.

The NVIDIA H100 (``nvidia-h100-sxm``) is solved and placed as a chip group
like a TPU slice: one child per host holding that host's GPUs
(``chip_count`` = GPUs per host), never ``size`` one-GPU children, with the
slice reserved up front and ``status.slice`` written, so each child's CDI
spec carries the torchrun coordinates of
``admission/coordinates.slice_env``. Every branch that the JAX package takes
on ``type == "tpu"`` asks ``topology.is_chip_group(type, model)`` of the
object's own type and model, which is that test plus the H100; other gpu
models (TPU model names under ``type="gpu"`` among them) keep the
reference's independent-device path.

Writes and reads go to ``self.store`` (the port's Store). Shard ownership
and the fence at the fabric boundary (``ShardFencedError``) arrive with the
sub-slice that ports the sharded control plane.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

from tpu_composer_torch.agent.publisher import quarantined_nodes
from tpu_composer_torch.api.meta import now_iso, parse_iso
from tpu_composer_torch.api.types import (
    ANNOTATION_DELETE_DEVICE,
    ANNOTATION_EVACUATE,
    ANNOTATION_EVACUATE_TARGET,
    ANNOTATION_LAST_USED_TIME,
    ANNOTATION_REPAIR_DRAIN_START,
    ANNOTATION_REPLACED_BY,
    ANNOTATION_REPLACES,
    ComposabilityRequest,
    ComposableResource,
    ComposableResourceSpec,
    FINALIZER,
    LABEL_MANAGED_BY,
    MIGRATE_TRIGGER_EVACUATION,
    MigrationRecord,
    Node,
    REPAIR_DETACH_ONLY,
    REPAIR_NONE,
    REQUEST_STATE_CLEANING,
    REQUEST_STATE_DELETING,
    REQUEST_STATE_EMPTY,
    REQUEST_STATE_NODE_ALLOCATING,
    REQUEST_STATE_RUNNING,
    REQUEST_STATE_UPDATING,
    RESOURCE_STATE_DEGRADED,
    RESOURCE_STATE_MIGRATING,
    RESOURCE_STATE_ONLINE,
    RESOURCE_STATE_REPAIRING,
    ResourceStatus,
    SliceStatus,
)
from tpu_composer_torch.fabric.provider import (
    FabricError,
    FabricProvider,
    UnsupportedRepair,
    UnsupportedResize,
)
from tpu_composer_torch.runtime.controller import Controller, Result
from tpu_composer_torch.runtime.events import WARNING, EventRecorder
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import (
    attach_to_ready_seconds,
    degraded_members,
    migration_breaker_open,
    migration_duration_seconds,
    migrations_total,
    reconcile_total,
    repair_breaker_open,
    repair_time_to_replace_seconds,
    repairs_total,
    scheduler_preemptions_total,
)
from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    Store,
    StoreError,
    WatchEvent,
    delete_tolerant,
)
from tpu_composer_torch.scheduler import AllocationError, ClusterScheduler
from tpu_composer_torch.topology.slices import (
    TopologyError,
    is_chip_group,
    solve_slice,
)


@dataclass
class RequestTiming:
    updating_poll: float = 0.5  # children-not-ready re-check (30s, :558)
    # Running is EVENT-driven: child watch events (fold + mapper) wake the
    # request at delivery latency on member loss/degradation — proven by
    # tests/test_e2e_operator.py::TestEventDrivenRunning with this poll at
    # 600 s. The 30 s pass is only a safety net for missed events; the
    # reference's fixed requeue (:585) is its primary detection quantum.
    running_poll: float = 30.0
    cleaning_poll: float = 0.3  # children-still-terminating re-check (30s, :611)
    # Cadence while a repair is in flight: replacement progress is
    # event-driven via the child watch; this polls the drain-grace clock
    # and re-attempts failed placements.
    repair_poll: float = 0.5


@dataclass
class RepairConfig:
    """Fleet-level repair-storm containment knobs (self-healing data
    plane). Per-request policy lives on the spec (repairPolicy /
    maxConcurrentRepairs / repairGraceSeconds); these bound what ALL
    requests may do at once."""

    # Freeze all repairs when more than this fraction of attached members
    # fleet-wide are Degraded/Repairing simultaneously: a brownout is a
    # fabric problem, and mass-detaching the fleet would amplify it.
    breaker_fraction: float = 0.5
    # ...but only when at least this many members are attached — a tiny
    # fleet's single failure is not a brownout.
    breaker_min_members: int = 4
    # Dwell: a member must have been Degraded at least this long (from its
    # failure record's observed_at) before a repair may act on it. The
    # tail-of-brownout guard: as a brownout lifts, members recover at
    # staggered times, and the moment the fraction dips below the breaker
    # threshold an eager repair would replace a member that was one healthy
    # probe away from recovering in place. 0 repairs immediately.
    min_degraded_seconds: float = 0.0


@dataclass
class MigrateConfig:
    """Live-migration (evacuation) knobs — the make-before-break verb that
    moves a HEALTHY member off its host without killing the job. Three
    triggers share it: NodeMaintenance drains, node-escalation evacuation,
    and the defrag executor. Per-request surge still comes from
    spec.maxConcurrentRepairs (a migration occupies the same
    replacement-attach machinery a repair does); these bound the FLEET."""

    #: Master switch (--migrate / TPUC_MIGRATE=0): off = the migration
    #: driver never runs and no member is ever auto-marked for evacuation.
    enabled: bool = True
    #: Fleet-wide cap on members in Migrating at once — an N-node
    #: maintenance wave must trickle, not stampede, however many requests
    #: are involved.
    max_concurrent: int = 2
    #: Fleet migration breaker: no NEW evacuation starts (and cutover
    #: detaches wait) while more than this fraction of attached members is
    #: Degraded/Repairing — a brownout looks exactly like a dying node,
    #: and evacuating through it would amplify the outage. Deliberately
    #: tighter than the repair breaker: migrations are discretionary.
    breaker_fraction: float = 0.25
    #: ...armed only at this many attached members (tiny-fleet guard).
    breaker_min_members: int = 4


def generate_resource_name(device_type: str) -> str:
    """`<type>-<uuid>` (stringutils.go:26-33)."""
    return f"{device_type}-{uuid.uuid4()}"


def evacuate_trigger(child: ComposableResource) -> str:
    """Map a member's evacuation annotation to the metric/record trigger
    label ("maintenance:<name>" -> "maintenance")."""
    raw = child.metadata.annotations.get(ANNOTATION_EVACUATE, "")
    return raw.split(":", 1)[0] if raw else MIGRATE_TRIGGER_EVACUATION


class ComposabilityRequestReconciler(Controller):
    primary_kind = "ComposabilityRequest"
    quiet_exceptions = (FabricError, TopologyError)

    def __init__(
        self,
        store: Store,
        fabric: FabricProvider,
        timing: Optional[RequestTiming] = None,
        recorder: Optional[EventRecorder] = None,
        scheduler: Optional[ClusterScheduler] = None,
        repair: Optional[RepairConfig] = None,
        migrate: Optional[MigrateConfig] = None,
    ) -> None:
        super().__init__(store)
        self.fabric = fabric
        self.timing = timing or RequestTiming()
        self.recorder = recorder or EventRecorder()
        self.repair = repair or RepairConfig()
        self.migrate = migrate or MigrateConfig()
        # Repair-breaker edge detection: the freeze/resume transitions are
        # logged + evented exactly once (the state itself is level-checked
        # every repair pass).
        self._repairs_frozen = False
        # Migration-breaker twin (tighter threshold; see MigrateConfig).
        self._migrations_frozen = False
        # Fleet migration cap accounting: the cap is check-then-act over a
        # store scan, and concurrent request reconciles (worker pool) would
        # otherwise all read the same pre-start count and stampede past it.
        # The lock serializes the budget check + starts within this
        # replica; _recent_migration_starts covers the window where a
        # just-started member's Migrating status write has not landed (or
        # lost a conflict) and is invisible to the scan.
        self._migrate_lock = threading.Lock()
        self._recent_migration_starts: Dict[str, float] = {}
        # The cluster-wide placement authority (scheduler/). Shared with the
        # DefragLoop when cmd/main wires one; tests may inject their own.
        self.scheduler = scheduler or ClusterScheduler(store)
        # The decision ledger's Queued/Placed/Preempting events ride this
        # controller's recorder (the ledger is constructed before the
        # recorder exists when cmd/main builds the scheduler first).
        if (
            self.scheduler.ledger is not None
            and self.scheduler.ledger.recorder is None
        ):
            self.scheduler.ledger.recorder = self.recorder
        # Placement decisions must be serialized: two concurrent allocations
        # would otherwise both pick the same least-loaded node before either
        # writes its placeholders (the reference gets this implicitly from
        # controller-runtime's default MaxConcurrentReconciles=1). The lock
        # is the SCHEDULER's so the defrag executor contends on the same
        # one — its verify+delete must not interleave with a placement.
        self._alloc_lock = self.scheduler.alloc_lock
        # Request names whose folded child statuses haven't been written yet
        # (each reconcile is single-threaded per name; the set is only ever
        # touched for the name being reconciled).
        self._fold_pending: set = set()
        # Child status changes fold into the request (reference Watches with a
        # status-change predicate, :658-678 + :169-195).
        self.watch("ComposableResource", mapper=self._map_child_event)
        # Target-node deletion GCs the request (:147-167).
        self.watch("Node", mapper=self._map_node_event)

    def _map_child_event(self, ev: WatchEvent) -> List[str]:
        owner = ev.obj.metadata.labels.get(LABEL_MANAGED_BY, "")
        return [owner] if owner else []

    def _map_node_event(self, ev: WatchEvent) -> List[str]:
        if ev.type != "DELETED":
            return []
        node = ev.obj.metadata.name
        out = []
        for req in self.store.list(ComposabilityRequest):
            if req.spec.resource.target_node == node or any(
                rs.node_name == node for rs in req.status.resources.values()
            ):
                out.append(req.metadata.name)
        return out

    # ------------------------------------------------------------------
    def reconcile(self, name: str) -> Result:
        req = self.store.try_get(ComposabilityRequest, name)
        if req is None:
            return Result()
        try:
            result = self._reconcile_inner(req)
            reconcile_total.inc(controller="request", outcome="ok")
            return result
        except (FabricError, TopologyError) as e:
            reconcile_total.inc(controller="request", outcome="error")
            self._set_error(name, str(e))
            raise

    def _reconcile_inner(self, req: ComposabilityRequest) -> Result:
        # Transaction diet: folding child statuses no
        # longer costs its own wire write — the changes ride along on the
        # state handler's single update_status; only a handler that writes
        # nothing (steady-state Running) triggers the fallback write below.
        if self._fold_child_statuses(req):
            self._fold_pending.add(req.name)
        try:
            result = self._dispatch_state(req)
        finally:
            pending = req.name in self._fold_pending
            self._fold_pending.discard(req.name)
        if pending:
            # The handler never wrote. Re-fold against FRESH server state
            # rather than writing `req` — the handler may have mutated it in
            # memory (e.g. the fused ""-state path sets NodeAllocating
            # before an early return), and persisting those side effects
            # here would fake a transition the handler deliberately didn't
            # commit.
            try:
                fresh = self.store.try_get(ComposabilityRequest, req.name)
                if fresh is not None and self._fold_child_statuses(fresh):
                    self.store.update_status(fresh)
            except (ConflictError, NotFoundError):
                pass  # derived state — refolded on the next event anyway
        return result

    def _write_status(self, req: ComposabilityRequest) -> None:
        """The one status write per reconcile; absorbs any pending fold."""
        self.store.update_status(req)
        self._fold_pending.discard(req.name)

    def _dispatch_state(self, req: ComposabilityRequest) -> Result:

        # GC: explicit target node deleted -> the request is unsatisfiable as
        # written; tear it down (:147-167).
        if (
            req.spec.resource.target_node
            and not req.being_deleted
            and req.status.state in (REQUEST_STATE_UPDATING, REQUEST_STATE_RUNNING)
            and self.store.try_get(Node, req.spec.resource.target_node) is None
        ):
            self.recorder.event(req, WARNING, "TargetNodeGone",
                                f"target node {req.spec.resource.target_node} deleted")
            req = delete_tolerant(self.store, ComposabilityRequest, req.name)
            if req is None:
                return Result()  # finalizer-less object purged outright

        if req.being_deleted and req.status.state not in (
            REQUEST_STATE_CLEANING, REQUEST_STATE_DELETING,
        ):
            req.status.state = REQUEST_STATE_CLEANING
            try:
                self._write_status(req)
            except NotFoundError:
                return Result()  # purged concurrently — nothing to clean
            return Result(requeue_after=self.timing.cleaning_poll)

        state = req.status.state
        if state == REQUEST_STATE_EMPTY:
            return self._handle_none(req)
        if state == REQUEST_STATE_NODE_ALLOCATING:
            return self._handle_node_allocating(req)
        if state == REQUEST_STATE_UPDATING:
            return self._handle_updating(req)
        if state == REQUEST_STATE_RUNNING:
            return self._handle_running(req)
        if state == REQUEST_STATE_CLEANING:
            return self._handle_cleaning(req)
        if state == REQUEST_STATE_DELETING:
            return self._handle_deleting(req)
        self.log.warning("%s: unknown state %r", req.name, state)
        return Result()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _children(self, req: ComposabilityRequest) -> List[ComposableResource]:
        return self.store.list(
            ComposableResource, label_selector={LABEL_MANAGED_BY: req.name}
        )

    def _fold_child_statuses(self, req: ComposabilityRequest) -> bool:
        """Copy child state/devices into status.resources (:169-195).
        Mutates req in memory and returns whether anything changed; the
        caller decides when the write happens."""
        children = {c.name: c for c in self._children(req)}
        changed = False
        for name, child in children.items():
            rs = req.status.resources.get(name)
            if child.being_deleted and rs is None:
                # A draining child whose row is already gone (preemption
                # clears rows on eviction): resurrecting it would plant a
                # phantom placeholder claim — in NodeAllocating the
                # removal branch below never drops rows, so the claim
                # would outlive the child and block other placements.
                continue
            new = ResourceStatus(
                state=child.status.state,
                node_name=child.spec.target_node,
                device_ids=list(child.status.device_ids),
                cdi_device_id=child.status.cdi_device_id,
                worker_id=child.spec.worker_id if is_chip_group(child.spec.type, child.spec.model) else -1,
                error=child.status.error,
                quarantined=child.status.quarantined,
                # Surface in-flight fabric intent on the parent: `kubectl
                # get composabilityrequest -o yaml` answers "is any member
                # still mutating the fabric?" without walking children —
                # the question every drain/restart decision starts from.
                pending_verb=(
                    child.status.pending_op.verb
                    if child.status.pending_op is not None else ""
                ),
            )
            if rs is None or rs.to_dict() != new.to_dict():
                req.status.resources[name] = new
                changed = True
        for name in list(req.status.resources):
            if name not in children and req.status.state not in (
                REQUEST_STATE_NODE_ALLOCATING, REQUEST_STATE_EMPTY,
            ):
                # placeholder rows (no child yet) are legitimate only before
                # Updating creates them; otherwise the child is gone.
                if req.status.resources[name].state != "":
                    del req.status.resources[name]
                    changed = True
        return changed

    def _slice_name(self, req: ComposabilityRequest) -> str:
        return f"{req.name}-slice"

    def _slice_fabric(self, req: ComposabilityRequest):
        """Fabric handle for SLICE mutations (reserve/resize/release/
        repair). The JAX package fence-checks shard ownership here; the
        port's operator is unsharded until the sharded control plane is
        ported, so every request is this replica's."""
        return self.fabric

    def _quarantined_nodes(self) -> set:
        """Hosts under a node-level quarantine marker (attach budget
        exhausted there — see publisher.quarantine_node). ONE list per
        allocation pass, not a per-candidate get: allocation holds
        _alloc_lock, and on the wire store per-node GETs would serialize
        the fleet behind O(N) RTTs (same reasoning as _used_slots_map)."""
        return quarantined_nodes(self.store)

    def _set_error(self, name: str, msg: str) -> None:
        req = self.store.try_get(ComposabilityRequest, name)
        if req is None or req.status.error == msg:
            return
        req.status.error = msg
        try:
            self._write_status(req)
        except (ConflictError, NotFoundError):
            pass  # stale read or object gone — next reconcile re-surfaces it

    # ------------------------------------------------------------------
    # states
    # ------------------------------------------------------------------
    def _handle_none(self, req: ComposabilityRequest) -> Result:
        if req.add_finalizer(FINALIZER):
            req = self.store.update(req)
        # Fall straight into allocation: the NodeAllocating hop is not
        # persisted separately — the allocator's own status write records
        # both transitions, saving one sequential wire RTT on the
        # attach-critical path. No in-memory state mutation here either:
        # the allocator re-reads under its lock anyway, and a mutated
        # caller object is exactly what the fold-fallback write must never
        # accidentally persist. A failed allocation leaves the server-side
        # state at "" and the next reconcile retries from the top.
        return self._handle_node_allocating(req)

    def _handle_node_allocating(self, req: ComposabilityRequest) -> Result:
        with self._alloc_lock:
            # Re-read inside the lock so this decision sees every placeholder
            # written by allocations that just finished. Safe under cached
            # reads too: the CachedClient folds write RESPONSES into the
            # cache before update_status returns, so anything persisted
            # under this lock by the previous holder is visible here.
            req = self.store.get(ComposabilityRequest, req.name)
            res = req.spec.resource
            children = self._children(req)

            if is_chip_group(res.type, res.model):
                return self._allocate_tpu(req, children)
            return self._allocate_scalar(req, children)

    # -- TPU slice allocation ------------------------------------------
    def _allocate_tpu(self, req: ComposabilityRequest, children) -> Result:
        res = req.spec.resource
        if res.size == 0:
            return self._shrink_to_zero(req, children)
        shape = solve_slice(res.model, res.size, res.topology)
        slice_name = self._slice_name(req)
        # A node-pinned request can never span hosts — enforced here so the
        # grow path errors the same way a fresh allocation does.
        if res.target_node and shape.num_hosts > 1:
            raise AllocationError(
                f"topology {shape.topology} spans {shape.num_hosts} hosts;"
                " target_node only supports single-host slices"
            )

        # Children that can't belong to ANY shape of this slice go first:
        # wrong model/flags, their node is gone, or they/their node are
        # quarantined (attach budget exhausted — replacement capacity must
        # land elsewhere). Topology and member count are judged separately
        # below — a resize keeps survivors (reference contrast: device
        # reuse on drift, composabilityrequest_controller.go:254-305; our
        # live-resize extends it to connected slices).
        quarantined_nodes = self._quarantined_nodes()
        healthy = [
            c for c in children
            if not c.being_deleted
            and c.spec.model == res.model
            and c.spec.slice_name == slice_name
            and c.spec.force_detach == res.force_detach
            and not c.status.quarantined
            # Degraded/Repairing/Migrating members never re-enter a solved
            # slice: a re-solve reaching this path replaces them on fresh
            # capacity (the break-before-make fallback the repair and
            # migration drivers lean on; a Migrating source's replacement
            # already claims its worker id, so keeping both would collide).
            and c.status.state not in (
                RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING,
                RESOURCE_STATE_MIGRATING,
            )
            and c.spec.target_node not in quarantined_nodes
            and self.store.try_get(Node, c.spec.target_node) is not None
        ]
        stale = [c for c in children if c not in healthy]
        if stale:
            self._delete_children(req, stale)
            return Result(requeue_after=self.timing.cleaning_poll)

        healthy.sort(key=lambda c: c.spec.worker_id)
        # Reuse is only sound when the survivors are exactly workers
        # 0..k-1 with the new shape's chips_per_host: worker_ids (and the
        # TPU_* coordinates already injected into pods) must stay a stable
        # prefix, and a chips_per_host change reshapes every host's chip
        # group. Anything else dissolves (atomicity over reuse).
        reusable = (
            [c.spec.worker_id for c in healthy] == list(range(len(healthy)))
            and all(c.spec.chip_count == shape.chips_per_host for c in healthy)
        )
        if healthy and not reusable:
            self._delete_children(req, healthy)
            return Result(requeue_after=self.timing.cleaning_poll)

        cur_hosts = [c.spec.target_node for c in healthy]
        if len(healthy) > shape.num_hosts:
            # Shrink: drain the highest worker_ids first; the fabric
            # reservation is trimmed on the next pass once they're gone.
            victims = healthy[shape.num_hosts:]
            self._delete_children(req, victims)
            return Result(requeue_after=self.timing.cleaning_poll)
        if len(healthy) == shape.num_hosts:
            nodes = cur_hosts
            # any(): a child whose topology rewrite failed last pass (update
            # conflict) must be retried, not just the first worker's.
            if any(c.spec.topology != shape.topology for c in healthy):
                # Same members, new shape (post-shrink trim, or a pure
                # topology change like 1x2x2 -> 2x2x1): reprogram ICI links
                # around the live members.
                try:
                    self._slice_fabric(req).resize_slice(
                        slice_name, res.model, shape.topology, nodes
                    )
                except UnsupportedResize:
                    self._delete_children(req, healthy)
                    return Result(requeue_after=self.timing.cleaning_poll)
                self._retopologize(healthy, shape.topology)
        elif healthy:
            # Grow: survivors keep their worker_ids/chips; reserve only the
            # delta on fresh hosts appended after the stable prefix. A
            # provider without live resize forces the dissolve-and-rebuild
            # path instead (release+reserve under running pods is unsafe).
            extra = self.scheduler.place_extra(
                req, shape, exclude=set(cur_hosts),
                count=shape.num_hosts - len(healthy),
                quarantined=quarantined_nodes,
            )
            nodes = cur_hosts + extra
            try:
                self._slice_fabric(req).resize_slice(
                    slice_name, res.model, shape.topology, nodes
                )
            except UnsupportedResize:
                self._delete_children(req, healthy)
                return Result(requeue_after=self.timing.cleaning_poll)
            self._retopologize(healthy, shape.topology)
        else:
            self._slice_fabric(req).release_slice(slice_name)
            placement = self.scheduler.place(req, shape, quarantined_nodes)
            if placement.victims:
                self._preempt(req, placement.victims)
                raise AllocationError(
                    f"preempting {len(placement.victims)} lower-priority"
                    f" request(s) ({', '.join(placement.victims)});"
                    " waiting for their capacity to drain"
                )
            nodes = placement.nodes
            try:
                self._slice_fabric(req).reserve_slice(slice_name, res.model, shape.topology, nodes)
            except FabricError:
                # place() dequeued this request on success; a failed
                # reservation (transient fabric fault, open breaker) means
                # it is still unplaced — put the backfill-gate protection
                # back before the backoff retry, or a lower-priority
                # request could take the very hosts just picked.
                self.scheduler.requeue(
                    req, shape.num_hosts, shape.chips_per_host
                )
                raise
        # Placeholders + authoritative coordinates (:471-484, plus slice
        # block for webhook injection). Kept children retain their status
        # rows; only the added workers get placeholders.
        req.status.resources = {
            c.name: req.status.resources.get(c.name, ResourceStatus(node_name=c.spec.target_node))
            for c in healthy
        }
        for w in range(len(healthy), shape.num_hosts):
            placeholder = generate_resource_name(res.type)
            req.status.resources[placeholder] = ResourceStatus(
                node_name=nodes[w], worker_id=w
            )
        req.status.slice = SliceStatus(
            name=slice_name,
            topology=shape.topology,
            num_hosts=shape.num_hosts,
            chips_per_host=shape.chips_per_host,
            worker_hostnames=list(nodes),
        )
        req.status.scalar_resource = res
        req.status.state = REQUEST_STATE_UPDATING
        req.status.error = ""
        self._write_status(req)
        return Result(requeue_after=0.0)

    def _preempt(self, req: ComposabilityRequest, victims: List[str]) -> None:
        """Evict the scheduler's victim set through the normal controller
        paths: delete each victim's children (the resource controller
        drains/detaches them) and push the victim back to NodeAllocating so
        an Updating victim cannot recreate children from its placeholder
        rows and steal the capacity back. The victim's own re-solve then
        releases its fabric reservation, fails placement (the backfill gate
        protects the pending preemptor), and re-queues until capacity
        returns."""
        for v_name in victims:
            v = self.store.try_get(ComposabilityRequest, v_name)
            if v is None or v.being_deleted:
                continue
            self.recorder.event(
                v, WARNING, "Preempted",
                f"preempted by {req.name} (priority {req.spec.priority} >"
                f" {v.spec.priority}); re-queued until capacity returns",
            )
            self.recorder.event(
                req, "Normal", "Preempting",
                f"evicting lower-priority request {v_name} to free capacity",
            )
            self._delete_children(v, [c for c in self._children(v)
                                      if not c.being_deleted])
            scheduler_preemptions_total.inc()
            # Every pre-terminal state, including a victim ALREADY in
            # NodeAllocating (mid-re-solve after a Degraded event): its
            # placeholder rows are capacity claims (used_slots_map counts
            # them), and a preempted request keeping rows for the very
            # hosts it was evicted from would read as still pinning them —
            # the preemptor would name it a victim again every pass. The
            # write RETRIES on conflict: the child deletions above race the
            # victim's own reconcile, and losing the write while the
            # victim sits in Updating would let _handle_updating recreate
            # the just-deleted children from its placeholder rows — the
            # eviction would converge to resurrection, not re-queueing.
            for _ in range(4):
                if v is None or v.being_deleted or v.status.state in (
                    REQUEST_STATE_CLEANING, REQUEST_STATE_DELETING,
                ):
                    break
                v.status.state = REQUEST_STATE_NODE_ALLOCATING
                v.status.error = (
                    f"preempted by higher-priority request {req.name}"
                )
                v.status.resources = {}
                try:
                    self.store.update_status(v)
                    break
                except NotFoundError:
                    break
                except ConflictError:
                    v = self.store.try_get(ComposabilityRequest, v_name)
            else:
                # Never silent: an Updating victim whose push kept losing
                # will recreate its children from placeholder rows, and
                # the next preemption pass re-names it — this log is the
                # only trace of that loop's cause.
                self.log.warning(
                    "preemption of %s by %s: status push kept conflicting;"
                    " victim may recreate children until the next pass",
                    v_name, req.name,
                )

    def _retopologize(self, children: List[ComposableResource], topology: str) -> None:
        """Rewrite spec.topology on surviving members after a live resize.
        Their chips, worker_id and node are untouched — only the slice shape
        they report (and the agent republishes in CDI/ResourceSlice form)
        changes."""
        for c in children:
            if c.spec.topology != topology:
                c.spec.topology = topology
                try:
                    self.store.update(c)
                except (ConflictError, NotFoundError) as e:
                    # Benign races — a stale rv (the any() drift check in
                    # _allocate_tpu retries it next pass) or the child purged
                    # mid-resize (allocation re-notices). Logged so a rewrite
                    # that keeps failing is visible; anything else raises.
                    self.log.info("retopologize %s -> %s deferred: %s",
                                  c.name, topology, e)

    # -- scalar (gpu/cxlmemory) allocation ------------------------------
    def _allocate_scalar(self, req: ComposabilityRequest, children) -> Result:
        res = req.spec.resource
        keep: List[ComposableResource] = []
        discard: List[ComposableResource] = []
        quarantined_nodes = self._quarantined_nodes()
        for c in children:
            if (
                not c.being_deleted
                and c.spec.model == res.model
                and c.spec.force_detach == res.force_detach
                and (not res.target_node or c.spec.target_node == res.target_node)
                and not c.status.quarantined
                and c.status.state not in (
                    RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING,
                    RESOURCE_STATE_MIGRATING,
                )
                and c.spec.target_node not in quarantined_nodes
                and self.store.try_get(Node, c.spec.target_node) is not None
            ):
                keep.append(c)
            else:
                discard.append(c)

        if len(keep) > res.size:
            excess = self._deletion_order(keep)[: len(keep) - res.size]
            discard.extend(excess)
            keep = [c for c in keep if c not in excess]
        if discard:
            self._delete_children(req, discard)
            return Result(requeue_after=self.timing.cleaning_poll)

        # Node placement for missing devices (:361-467).
        assignments = [c.spec.target_node for c in keep]
        missing = res.size - len(keep)
        if missing > 0:
            assignments.extend(self._pick_scalar_nodes(
                req, missing, assignments, quarantined_nodes))

        req.status.resources = {
            c.name: req.status.resources.get(c.name, ResourceStatus(node_name=c.spec.target_node))
            for c in keep
        }
        for node in assignments[len(keep):]:
            req.status.resources[generate_resource_name(res.type)] = ResourceStatus(node_name=node)
        req.status.scalar_resource = res
        req.status.slice = SliceStatus()
        req.status.state = REQUEST_STATE_UPDATING
        req.status.error = ""
        self._write_status(req)
        return Result(requeue_after=0.0)

    def _pick_scalar_nodes(
        self, req, count: int, existing: List[str], quarantined_nodes: set,
    ) -> List[str]:
        # Same engine and admission gate as slice placement, so scalar
        # devices and TPU workers share one capacity map, cannot
        # double-book a host, and cannot backfill-steal ports a pending
        # higher-priority slice is queued for.
        return self.scheduler.place_scalar(
            req, count, existing, quarantined_nodes
        )

    def _deletion_order(self, children: List[ComposableResource]) -> List[ComposableResource]:
        """5-bucket deletion priority, oldest-used first within a bucket
        (:307-359, buckets :329-339, last-used annotation :320-327)."""

        def bucket(c: ComposableResource) -> int:
            if c.metadata.annotations.get(ANNOTATION_DELETE_DEVICE) == "true":
                return 0  # explicitly marked for deletion
            if c.status.error:
                return 1  # failed
            if c.status.state != RESOURCE_STATE_ONLINE:
                return 2  # not yet online — cheapest to cancel
            if ANNOTATION_LAST_USED_TIME not in c.metadata.annotations:
                return 3  # online, never used
            return 4  # online, used — last resort, oldest first

        def last_used(c: ComposableResource) -> float:
            ts = c.metadata.annotations.get(ANNOTATION_LAST_USED_TIME, "")
            try:
                return parse_iso(ts).timestamp()
            except ValueError:
                return 0.0

        return sorted(children, key=lambda c: (bucket(c), last_used(c), c.name))

    def _delete_children(self, req, children) -> None:
        for c in children:
            try:
                self.store.delete(ComposableResource, c.name)
            except NotFoundError:
                pass  # already gone — the goal state
            except StoreError as e:
                # Absorbed so one child's API failure doesn't abort its
                # siblings' deletes; callers requeue after cleaning_poll so
                # each is retried. Logged so a delete that keeps failing is
                # visible.
                self.log.warning("delete child %s of %s failed (will retry): %s",
                                 c.name, req.name, e)

    # -- Updating / Running / Cleaning / Deleting ----------------------
    def _handle_updating(self, req: ComposabilityRequest) -> Result:
        res = req.spec.resource
        # Spec drifted since allocation -> re-solve (:495-499).
        if req.status.scalar_resource is None or (
            req.status.scalar_resource.to_dict() != res.to_dict()
        ):
            req.status.state = REQUEST_STATE_NODE_ALLOCATING
            self._write_status(req)
            return Result(requeue_after=0.0)

        children = {c.name: c for c in self._children(req)}
        # A quarantined member will never come Online — go straight back to
        # allocation, which discards it and places a replacement on healthy
        # capacity (automatic reallocation, docs/RESILIENCE.md). Without
        # this the request would sit in Updating polling forever. Members
        # that degraded DURING the attach wave (post-Ready detection firing
        # while siblings still attach) take the same path: pre-Ready there
        # is no workload to make-before-break for, so the re-solve simply
        # replaces them.
        unusable = [
            c for c in children.values()
            if c.status.quarantined or c.status.state in (
                RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING,
                RESOURCE_STATE_MIGRATING,
            )
        ]
        if unusable:
            self.recorder.event(
                req, WARNING, "MemberQuarantined",
                f"{len(unusable)} member(s) quarantined/degraded"
                f" ({', '.join(sorted(c.spec.target_node for c in unusable))});"
                " reallocating on healthy capacity",
            )
            req.status.state = REQUEST_STATE_NODE_ALLOCATING
            self._write_status(req)
            return Result(requeue_after=0.0)
        # Delete children that lost their placeholder row (:509-521).
        redundant = [c for name, c in children.items() if name not in req.status.resources]
        if redundant:
            self._delete_children(req, redundant)
            return Result(requeue_after=self.timing.cleaning_poll)
        # Create missing children (:523-542). Creations are independent
        # wire ops, so they go out concurrently: serially, an N-host slice
        # paid N sequential apiserver RTTs on the attach-critical path
        # (measured: each create shifted the whole downstream attach chain
        # of its child by one RTT). Any failure is re-raised and the next
        # reconcile retries the missing subset — same semantics as the
        # serial loop erroring mid-way.
        missing = []
        for name, rs in req.status.resources.items():
            if name in children:
                continue
            child = ComposableResource()
            child.metadata.name = name
            child.metadata.labels[LABEL_MANAGED_BY] = req.name
            # Pre-set the lifecycle finalizer: the child controller's
            # add_finalizer then no-ops, saving one spec PUT per child on
            # the attach-critical path.
            child.metadata.finalizers = [FINALIZER]
            child.spec = ComposableResourceSpec(
                type=res.type,
                model=res.model,
                target_node=rs.node_name,
                force_detach=res.force_detach,
            )
            if is_chip_group(res.type, res.model):
                child.spec.chip_count = req.status.slice.chips_per_host
                child.spec.slice_name = req.status.slice.name
                child.spec.worker_id = rs.worker_id if rs.worker_id >= 0 else 0
                child.spec.topology = req.status.slice.topology
            child.set_owner(req)
            missing.append(child)
        if missing:
            if len(missing) == 1:
                self.store.create(missing[0])
            else:
                with ThreadPoolExecutor(
                    max_workers=min(len(missing), 16)
                ) as pool:
                    futures = [pool.submit(self.store.create, c)
                               for c in missing]
                    errors = [f.exception() for f in futures]
                for err in errors:
                    if err is not None:
                        raise err
            return Result(requeue_after=self.timing.updating_poll)

        # All children Online -> Running (:544-559).
        if children and all(
            c.status.state == RESOURCE_STATE_ONLINE for c in children.values()
        ):
            first_ready = not req.status.first_ready_time
            req.status.state = REQUEST_STATE_RUNNING
            req.status.error = ""
            if first_ready:
                req.status.first_ready_time = now_iso()
            self._write_status(req)
            if first_ready and req.metadata.creation_timestamp:
                try:
                    dt = (
                        parse_iso(req.status.first_ready_time)
                        - parse_iso(req.metadata.creation_timestamp)
                    ).total_seconds()
                    attach_to_ready_seconds.observe(dt, type=res.type)
                except ValueError:
                    pass
            self.recorder.event(req, "Normal", "Ready",
                                f"{res.size} x {res.model} composed")
            return Result()
        if not children and res.size == 0:
            req.status.state = REQUEST_STATE_RUNNING
            self._write_status(req)
            return Result()
        return Result(requeue_after=self.timing.updating_poll)

    def _handle_running(self, req: ComposabilityRequest) -> Result:
        res = req.spec.resource
        # Spec drift -> full re-allocation (:562-586). For TPU this is the
        # resize path: NodeAllocating re-solves the shape, dissolving or
        # extending the slice.
        if req.status.scalar_resource is None or (
            req.status.scalar_resource.to_dict() != res.to_dict()
        ):
            req.status.state = REQUEST_STATE_NODE_ALLOCATING
            self._write_status(req)
            return Result(requeue_after=0.0)
        children = self._children(req)
        live = [c for c in children if not c.being_deleted]
        # Authoritative member count — NOT len(status.resources), which the
        # fold step already shrank when a child vanished.
        expected = (
            req.status.slice.num_hosts if is_chip_group(res.type, res.model) and res.size > 0 else res.size
        )
        # A member that is fully GONE (child object lost — node deletion
        # GC, manual delete) is a structural hole the repair driver cannot
        # fill; the full re-solve below owns it. Checked FIRST so a
        # sibling sitting Degraded (repairPolicy=None, or a repair
        # retrying placement) can never starve lost-member recovery.
        if len(live) < expected:
            self.recorder.event(req, WARNING, "Degraded",
                                f"{len(live)}/{expected} members present")
            req.status.state = REQUEST_STATE_NODE_ALLOCATING
            self._write_status(req)
            return Result(requeue_after=0.0)
        # Self-healing: members that FAILED post-Ready (damped health
        # probes, or the syncer seeing their devices vanish) are handled by
        # the repair driver — make-before-break replacement under the surge
        # budget and the fleet breaker — NOT by the blunt full re-solve
        # below, which would tear surviving members' coordinates apart.
        failed = [
            c for c in live
            if c.status.state in (RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING)
        ]
        if failed:
            return self._drive_repairs(req, live, failed)
        if self._repairs_frozen:
            # Every member recovered in place (the brownout lifted before
            # any repair ran): recompute so the breaker gauge and the
            # resume edge don't stay latched open.
            self._repairs_frozen_now(req)
        # Live migration: healthy members marked for evacuation (a
        # NodeMaintenance drain, the defrag executor) or already mid-move,
        # plus the node-escalation upgrade — still-Online members on a
        # quarantined host are moved off make-before-break instead of
        # waiting to die there. Repairs take precedence (a Degraded member
        # is a present outage; an evacuation is a scheduled one).
        migrants = self._migration_candidates(req, live)
        if migrants:
            return self._drive_migrations(req, live, migrants)
        if self._migrations_frozen:
            self._migrations_frozen_now(req)  # resume edge, like repairs
        if req.status.migration:
            # Janitor: records whose member vanished outside the driver
            # (node-gone GC, manual delete) must not linger in status.
            live_names = {c.name for c in live}
            stale = [m for m in req.status.migration if m not in live_names]
            if stale:
                for m in stale:
                    req.status.migration.pop(m, None)
                try:
                    self._write_status(req)
                except (ConflictError, NotFoundError):
                    pass  # re-pruned next pass
        # With migration enabled a Migrating member is never seen here (it
        # is always a candidate above); with the escape hatch off, a
        # member stranded mid-move falls through to the full re-solve.
        if any(c.status.state != RESOURCE_STATE_ONLINE for c in live):
            # Unknown non-Online state -> full re-solve. (Scalar requests
            # must also go through NodeAllocating, not Updating: the fold
            # step already dropped a lost child's status row, so Updating
            # would find nothing to create and flap Running<->Updating
            # forever.) A replacement member mid-attach never lands here:
            # its failed member is still in `failed` until the post-grace
            # delete, and after that delete the replacement is Online.
            self.recorder.event(req, WARNING, "Degraded",
                                f"{len(live)}/{expected} members online")
            req.status.state = REQUEST_STATE_NODE_ALLOCATING
            self._write_status(req)
            return Result(requeue_after=0.0)
        # Fully healthy: retire any stale repair-era error surfaced on the
        # request (DegradedNoRepair / RepairFailed messages must not
        # outlive the condition).
        if req.status.error:
            req.status.error = ""
            try:
                self._write_status(req)
            except (ConflictError, NotFoundError):
                pass  # cosmetic — retried on the next pass
        return Result(requeue_after=self.timing.running_poll)

    # ------------------------------------------------------------------
    # self-healing repair driver (Running-state member failures)
    # ------------------------------------------------------------------
    def _repairs_frozen_now(self, req: ComposabilityRequest) -> bool:
        """Fleet-level repair breaker: when more than breaker_fraction of
        the attached fleet is Degraded/Repairing at once, the failure is
        the FABRIC's (brownout/partition), not the members' — freezing
        repairs keeps the operator from mass-detaching a fleet that will
        recover when the fabric does. Level-checked every pass; the
        freeze/resume edges are evented once."""
        cfg = self.repair
        attached = [
            r for r in self.store.list(ComposableResource)
            if r.status.state in (
                RESOURCE_STATE_ONLINE, RESOURCE_STATE_DEGRADED,
                RESOURCE_STATE_REPAIRING,
            ) and not r.being_deleted
        ]
        bad = sum(
            1 for r in attached
            if r.status.state in (RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING)
        )
        degraded_members.set(float(bad))
        frozen = (
            len(attached) >= max(1, cfg.breaker_min_members)
            and bad > cfg.breaker_fraction * len(attached)
        )
        repair_breaker_open.set(1.0 if frozen else 0.0)
        if frozen and not self._repairs_frozen:
            msg = (
                f"repairs frozen: {bad}/{len(attached)} attached members"
                f" degraded (> {cfg.breaker_fraction:.0%}) — treating as a"
                " fabric-wide brownout, not member failures; no members"
                " will be detached until the fraction recedes"
            )
            self.recorder.event(req, WARNING, "RepairsFrozen", msg)
            self.log.warning("%s", msg)
            repairs_total.inc(outcome="frozen")
        elif not frozen and self._repairs_frozen:
            self.log.warning(
                "repairs resumed: degraded fraction receded (%d/%d)",
                bad, len(attached),
            )
            self.recorder.event(
                req, "Normal", "RepairsResumed",
                f"degraded fraction receded ({bad}/{len(attached)});"
                " repairs resume",
            )
        self._repairs_frozen = frozen
        return frozen

    def _drive_repairs(
        self,
        req: ComposabilityRequest,
        live: List[ComposableResource],
        failed: List[ComposableResource],
    ) -> Result:
        policy = req.spec.repair_policy
        if policy == REPAIR_NONE:
            msg = (
                f"{len(failed)} member(s) degraded; repairPolicy=None —"
                " operator action required"
            )
            if req.status.error != msg:
                req.status.error = msg
                try:
                    self._write_status(req)
                except (ConflictError, NotFoundError):
                    return Result(requeue_after=self.timing.running_poll)
                self.recorder.event(req, WARNING, "DegradedNoRepair", msg)
            return Result(requeue_after=self.timing.running_poll)

        if self._repairs_frozen_now(req):
            # Frozen: start nothing, detach nothing. Members stay attached
            # (Degraded members keep probing for recovery); in-flight
            # replacement ATTACHES may finish — adding capacity is never
            # the storm — but the grace-expiry detaches wait too.
            return Result(requeue_after=self.timing.running_poll)

        degraded = sorted(
            (c for c in failed if c.status.state == RESOURCE_STATE_DEGRADED),
            key=lambda c: c.name,
        )
        repairing = [
            c for c in failed if c.status.state == RESOURCE_STATE_REPAIRING
        ]
        by_replaces = {
            c.metadata.annotations.get(ANNOTATION_REPLACES): c
            for c in live if c.metadata.annotations.get(ANNOTATION_REPLACES)
        }

        # 1. Progress in-flight repairs (make-before-break back half).
        still_in_flight = 0
        for c in repairing:
            repl = by_replaces.get(c.name)
            if repl is None or repl.status.quarantined:
                # Replacement died before coming Online (node gone, attach
                # budget exhausted): revert to Degraded so a FRESH repair
                # attempt places elsewhere (a quarantined replacement's
                # node is already excluded by the allocator gates).
                if repl is not None:
                    self._delete_children(req, [repl])
                c.status.state = RESOURCE_STATE_DEGRADED
                try:
                    self.store.update_status(c)
                except (ConflictError, NotFoundError):
                    pass  # retried next pass
                # Re-point the authoritative coordinates at the failed
                # member's node — it is still the one actually attached
                # for worker w; leaving the dead replacement's node there
                # would hand the webhook hostnames with nothing behind
                # them for the whole retry window.
                w = c.spec.worker_id
                if (
                    is_chip_group(req.spec.resource.type, req.spec.resource.model)
                    and 0 <= w < len(req.status.slice.worker_hostnames)
                    and req.status.slice.worker_hostnames[w] != c.spec.target_node
                ):
                    req.status.slice.worker_hostnames[w] = c.spec.target_node
                    try:
                        self._write_status(req)
                    except (ConflictError, NotFoundError):
                        pass  # re-asserted next pass
                repairs_total.inc(outcome="retried")
                continue
            # Re-assert the authoritative coordinates every pass: the
            # _start_replacement write can lose a conflict, and stale
            # worker_hostnames would hand the webhook the dead node.
            w = repl.spec.worker_id
            if (
                is_chip_group(req.spec.resource.type, req.spec.resource.model)
                and 0 <= w < len(req.status.slice.worker_hostnames)
                and req.status.slice.worker_hostnames[w] != repl.spec.target_node
            ):
                req.status.slice.worker_hostnames[w] = repl.spec.target_node
                try:
                    self._write_status(req)
                except (ConflictError, NotFoundError):
                    pass  # retried next pass
            if repl.status.state != RESOURCE_STATE_ONLINE:
                still_in_flight += 1
                continue  # replacement still attaching — event-driven wait
            # Replacement Online: run the drain grace, then force-detach
            # the failed member.
            if not self._drain_grace_expired(c, req.spec.repair_grace_seconds):
                still_in_flight += 1
                continue
            if not c.spec.force_detach:
                # The member is failed hardware: load checks against it
                # would block teardown behind a workload that already
                # migrated to the replacement.
                c.spec.force_detach = True
                try:
                    c = self.store.update(c)
                except (ConflictError, NotFoundError):
                    still_in_flight += 1
                    continue  # retried next pass
            self._delete_children(req, [c])
            repairs_total.inc(outcome="replaced")
            # Time-to-replace: from the failure record's Degraded
            # observed_at to this detach — the SLO engine's repair_p99
            # objective reads this histogram.
            fr = c.status.failure
            if fr is not None and fr.observed_at:
                try:
                    repair_time_to_replace_seconds.observe(
                        (parse_iso(now_iso()) - parse_iso(fr.observed_at))
                        .total_seconds()
                    )
                except ValueError:
                    pass  # unreadable timestamp: skip the observation
            self.recorder.event(
                req, "Normal", "RepairComplete",
                f"member {c.name} ({c.spec.target_node}) replaced by"
                f" {repl.name} ({repl.spec.target_node}); detaching failed"
                " member",
            )

        # 1b. Complete interrupted transitions: a Degraded member that
        # already HAS a live replacement lost the Repairing mark (crash or
        # write conflict between store.create(repl) and the member's
        # status write in _start_replacement). Re-mark it instead of
        # placing a second replacement — and count it against the surge
        # budget, which a double-place would silently bypass.
        fresh = []
        for c in degraded:
            if by_replaces.get(c.name) is None:
                fresh.append(c)
                continue
            c.status.state = RESOURCE_STATE_REPAIRING
            try:
                self.store.update_status(c)
            except (ConflictError, NotFoundError):
                pass  # retried next pass; the replacement already exists
            still_in_flight += 1
        degraded = fresh

        # 2. Start new repairs within the surge budget. Members inside the
        # dwell window (recently degraded — possibly a brownout tail about
        # to recover in place) are skipped this pass and re-checked on the
        # repair_poll requeue.
        dwell = self.repair.min_degraded_seconds
        if dwell > 0:
            now = parse_iso(now_iso())
            ripe = []
            for c in degraded:
                fr = c.status.failure
                try:
                    age = (now - parse_iso(fr.observed_at)).total_seconds()
                except (AttributeError, ValueError):
                    age = dwell  # no/unreadable record: repair immediately
                if age >= dwell:
                    ripe.append(c)
            degraded = ripe
        # Last-look health probe — applied BEFORE the budget slice (like
        # the dwell) so a probe-healthy member cannot consume the repair
        # slot and starve a genuinely dead sibling: never replace a member
        # whose hardware is answering healthy RIGHT NOW. After a brownout
        # lifts, members recover at staggered times, and the one still
        # marked Degraded may be a single damped probe away from
        # recovering in place; its own recovery streak reclaims it —
        # repair is for members that are still sick. An unreachable fabric
        # is not evidence of member failure either. Device-vanished
        # degrades are exempt: their evidence is the fabric LISTING (probe
        # health can be OK while the attachment is gone), and their
        # recovery belongs to the syncer — a healthy probe must not
        # indefinitely defer their repair.
        vetted = []
        for c in degraded:
            fr = c.status.failure
            if fr is None or fr.source != "syncer":
                try:
                    if self.fabric.check_resource(c).healthy:
                        continue
                except FabricError:
                    continue
            vetted.append(c)
        degraded = vetted

        budget = max(1, req.spec.max_concurrent_repairs) - still_in_flight
        for c in degraded[: max(0, budget)]:
            if policy == REPAIR_DETACH_ONLY:
                if not c.spec.force_detach:
                    c.spec.force_detach = True
                    try:
                        c = self.store.update(c)
                    except (ConflictError, NotFoundError):
                        continue  # retried next pass
                self._delete_children(req, [c])
                repairs_total.inc(outcome="detached")
                self.recorder.event(
                    req, WARNING, "RepairDetachOnly",
                    f"detaching failed member {c.name}"
                    f" ({c.spec.target_node}); repairPolicy=DetachOnly —"
                    " normal lost-member recovery replaces it",
                )
                continue
            try:
                self._start_replacement(req, c)
            except UnsupportedRepair:
                # Provider cannot swap a worker's chips in place: fall back
                # to break-before-make — detach the failed member and let
                # the full re-solve rebuild (today's recovery path).
                if not c.spec.force_detach:
                    c.spec.force_detach = True
                    try:
                        c = self.store.update(c)
                    except (ConflictError, NotFoundError):
                        continue
                self._delete_children(req, [c])
                repairs_total.inc(outcome="fallback")
                self.recorder.event(
                    req, WARNING, "RepairFallback",
                    f"provider has no in-place member repair; detaching"
                    f" {c.name} and re-solving",
                )
            except (AllocationError, FabricError) as e:
                repairs_total.inc(outcome="failed")
                msg = f"repair of {c.name} failed (will retry): {e}"
                if req.status.error != msg:
                    req.status.error = msg
                    try:
                        self._write_status(req)
                    except (ConflictError, NotFoundError):
                        pass
                    self.recorder.event(req, WARNING, "RepairFailed", msg)
                break  # capacity/fabric problem — no point trying siblings now
        return Result(requeue_after=self.timing.repair_poll)

    # -- shared replacement machinery (repair AND migration ride it) ----
    def _pick_replacement_node(
        self, req: ComposabilityRequest, c: ComposableResource,
        quarantined: set, exclude: set,
    ) -> str:
        """Place ONE replacement for member ``c`` on healthy capacity
        (slice-aware for tpu, scalar otherwise)."""
        res = req.spec.resource
        if is_chip_group(res.type, res.model) and c.spec.slice_name:
            shape = solve_slice(res.model, res.size, res.topology)
            return self.scheduler.place_extra(
                req, shape, exclude=exclude, count=1, quarantined=quarantined
            )[0]
        return self.scheduler.place_scalar(
            req, 1,
            [ch.spec.target_node for ch in self._children(req)
             if not ch.being_deleted],
            quarantined,
        )[0]

    def _build_replacement_child(
        self, req: ComposabilityRequest, c: ComposableResource, node: str
    ) -> ComposableResource:
        """The replacement ComposableResource taking over ``c``'s worker
        slot on ``node`` — identical shape for repair and migration; the
        ``replaces`` annotation makes the pairing durable."""
        res = req.spec.resource
        repl = ComposableResource()
        repl.metadata.name = generate_resource_name(res.type)
        repl.metadata.labels[LABEL_MANAGED_BY] = req.name
        repl.metadata.annotations[ANNOTATION_REPLACES] = c.name
        repl.metadata.finalizers = [FINALIZER]
        repl.spec = ComposableResourceSpec(
            type=res.type,
            model=res.model,
            target_node=node,
            force_detach=res.force_detach,
            chip_count=c.spec.chip_count,
            slice_name=c.spec.slice_name,
            worker_id=c.spec.worker_id,
            topology=c.spec.topology,
        )
        repl.set_owner(req)
        return repl

    def _pair_and_mark(
        self, c: ComposableResource, repl_name: str, state: str
    ) -> None:
        """Durably point the source at its replacement and move it to
        Repairing/Migrating. Write losses are benign: the replacement
        already exists, and the drivers' 1b passes re-mark from the
        ``replaces`` pairing."""
        c.metadata.annotations[ANNOTATION_REPLACED_BY] = repl_name
        try:
            c = self.store.update(c)
            c.status.state = state
            self.store.update_status(c)
        except (ConflictError, NotFoundError):
            pass

    def _drain_grace_expired(
        self, c: ComposableResource, grace: float
    ) -> bool:
        """Crash-safe drain-grace clock shared by repair and migration:
        stamps the window's start on first call (False — wait), then
        reports whether ``grace`` seconds have elapsed."""
        start_iso = c.metadata.annotations.get(ANNOTATION_REPAIR_DRAIN_START, "")
        if not start_iso:
            c.metadata.annotations[ANNOTATION_REPAIR_DRAIN_START] = now_iso()
            try:
                self.store.update(c)
            except (ConflictError, NotFoundError):
                pass  # clock starts on the retry
            return False
        try:
            elapsed = (
                parse_iso(now_iso()) - parse_iso(start_iso)
            ).total_seconds()
        except ValueError:
            return True  # unreadable stamp: no extra wait
        return elapsed >= grace

    def _start_replacement(
        self, req: ComposabilityRequest, c: ComposableResource
    ) -> None:
        """Make-before-break front half: place a replacement member on
        healthy capacity, re-carve the slice worker's chips there (tpu),
        create the replacement child, and mark the failed member Repairing.
        The replacement's attach then runs the normal Attaching machinery —
        durable pending_op intent, dispatcher batching, attach budget — so
        a crash mid-repair is adopted like any other in-flight attach."""
        res = req.spec.resource
        quarantined = self._quarantined_nodes()
        exclude = {
            ch.spec.target_node
            for ch in self._children(req) if not ch.being_deleted
        }
        node = self._pick_replacement_node(req, c, quarantined, exclude)
        if is_chip_group(res.type, res.model) and c.spec.slice_name:
            # Fabric step: swap worker w's chip group onto the new node
            # from healthy inventory (raises UnsupportedRepair -> caller
            # falls back; FabricError -> retried next pass, nothing
            # created yet).
            self._slice_fabric(req).repair_slice_member(
                c.spec.slice_name, c.spec.worker_id, node
            )
        repl = self._build_replacement_child(req, c, node)
        self.store.create(repl)

        # Mark the failed member Repairing so the surge accounting and a
        # restarted operator see the repair in flight.
        self._pair_and_mark(c, repl.metadata.name, RESOURCE_STATE_REPAIRING)
        # Bookkeeping on the parent: the replacement's row (placement
        # claim) and the authoritative coordinates for worker w.
        req.status.resources[repl.metadata.name] = ResourceStatus(
            node_name=node,
            worker_id=c.spec.worker_id if is_chip_group(res.type, res.model) else -1,
        )
        if (
            is_chip_group(res.type, res.model)
            and 0 <= c.spec.worker_id < len(req.status.slice.worker_hostnames)
        ):
            req.status.slice.worker_hostnames[c.spec.worker_id] = node
        try:
            self._write_status(req)
        except (ConflictError, NotFoundError):
            pass  # refolded from children on the next pass
        repairs_total.inc(outcome="started")
        self.recorder.event(
            req, "Normal", "RepairStarted",
            f"replacing failed member {c.name} ({c.spec.target_node}) with"
            f" {repl.metadata.name} on {node}"
            f" (worker {c.spec.worker_id})",
        )

    # ------------------------------------------------------------------
    # live migration driver (healthy-member evacuation, Running state)
    # ------------------------------------------------------------------
    def _migration_candidates(
        self, req: ComposabilityRequest, live: List[ComposableResource]
    ) -> List[ComposableResource]:
        """Members this pass should move: explicitly marked for evacuation
        (maintenance drain / defrag), already mid-move (Migrating), or —
        the node-escalation upgrade — still Online on a host that carries
        a NON-maintenance quarantine marker (attach-budget exhaustion or
        post-Ready escalation: the hardware under them is failing; move
        them before they die there). Maintenance cordons are excluded from
        the auto-mark so the drain's own marks keep their attribution."""
        if not self.migrate.enabled:
            return []
        # repairPolicy=None opts the request out of the replacement
        # machinery migration rides on (the same invariant the defrag
        # planner's migratability gate states): never mark and never start
        # moves for it. Members already mid-move (a policy change while a
        # migration was in flight) are still progressed to completion —
        # abandoning a half-cutover move helps nobody.
        opted_out = req.spec.repair_policy == REPAIR_NONE
        out = []
        bad_nodes: Optional[set] = None
        for c in live:
            if c.status.state == RESOURCE_STATE_MIGRATING:
                out.append(c)
                continue
            if opted_out or c.status.state != RESOURCE_STATE_ONLINE:
                continue  # repairs own every failed state
            if c.metadata.annotations.get(ANNOTATION_EVACUATE):
                out.append(c)
                continue
            if bad_nodes is None:
                bad_nodes = self._escalation_quarantined_nodes()
            if c.spec.target_node in bad_nodes:
                # Durable auto-mark so a crash mid-evacuation resumes and
                # the trigger label survives into the record/metric.
                c.metadata.annotations[ANNOTATION_EVACUATE] = (
                    MIGRATE_TRIGGER_EVACUATION
                )
                try:
                    c = self.store.update(c)
                    out.append(c)
                except (ConflictError, NotFoundError):
                    pass  # re-marked next pass
        return out

    def _escalation_quarantined_nodes(self) -> set:
        """Quarantined hosts whose marker is NOT a maintenance cordon."""
        from tpu_composer_torch.agent.publisher import is_node_quarantine_marker
        from tpu_composer_torch.api.dra import DeviceTaintRule
        from tpu_composer_torch.api.maintenance import MAINTENANCE_REASON_PREFIX

        return {
            r.spec.node_name
            for r in self.store.list(DeviceTaintRule)
            if is_node_quarantine_marker(r)
            and not r.spec.reason.startswith(MAINTENANCE_REASON_PREFIX)
        }

    def _migrations_frozen_now(self, req: ComposabilityRequest) -> bool:
        """Fleet migration breaker: evacuations are DISCRETIONARY — when
        the fleet is browning out (degraded fraction above the migration
        threshold, tighter than the repair breaker's), starting or
        finishing them would pile scheduled disruption onto an outage.
        Level-checked every migration pass; edges evented once."""
        cfg = self.migrate
        attached = bad = 0
        for r in self.store.list(ComposableResource):
            if r.being_deleted:
                continue
            if r.status.state in (
                RESOURCE_STATE_ONLINE, RESOURCE_STATE_DEGRADED,
                RESOURCE_STATE_REPAIRING, RESOURCE_STATE_MIGRATING,
            ):
                attached += 1
                if r.status.state in (
                    RESOURCE_STATE_DEGRADED, RESOURCE_STATE_REPAIRING,
                ):
                    bad += 1
        frozen = (
            attached >= max(1, cfg.breaker_min_members)
            and bad > cfg.breaker_fraction * attached
        )
        migration_breaker_open.set(1.0 if frozen else 0.0)
        if frozen and not self._migrations_frozen:
            msg = (
                f"migrations frozen: {bad}/{attached} attached members"
                f" degraded (> {cfg.breaker_fraction:.0%}) — a brownout"
                " must not trigger a mass evacuation; drains resume when"
                " the fleet recovers"
            )
            self.recorder.event(req, WARNING, "MigrationsFrozen", msg)
            self.log.warning("%s", msg)
            migrations_total.inc(trigger="fleet", outcome="frozen")
        elif not frozen and self._migrations_frozen:
            self.recorder.event(
                req, "Normal", "MigrationsResumed",
                f"degraded fraction receded ({bad}/{attached});"
                " evacuations resume",
            )
        self._migrations_frozen = frozen
        return frozen

    def _fleet_migration_budget(self) -> int:
        """Remaining fleet-wide migration slots. Caller holds
        ``_migrate_lock``: the count is a store scan, and the slots must
        be claimed atomically with it. Recently-started members whose
        Migrating write has not landed yet are counted via the in-memory
        overlay (pruned once the scan sees them, the member vanishes, or
        the entry ages out — a lost status write is re-marked by step 1b
        within a pass or two). Cross-REPLICA reads share only the store,
        so a sharded fleet can briefly overshoot by at most one start per
        replica; the cap is a stampede brake, not a hard invariant."""
        migrating = {
            r.metadata.name
            for r in self.store.list(ComposableResource)
            if r.status.state == RESOURCE_STATE_MIGRATING
            and not r.being_deleted
        }
        now = time.monotonic()
        self._recent_migration_starts = {
            n: t for n, t in self._recent_migration_starts.items()
            if n not in migrating
            and now - t < 30.0
            and self.store.try_get(ComposableResource, n) is not None
        }
        return self.migrate.max_concurrent - len(migrating) - len(
            self._recent_migration_starts
        )

    def _drive_migrations(
        self,
        req: ComposabilityRequest,
        live: List[ComposableResource],
        migrants: List[ComposableResource],
    ) -> Result:
        frozen = self._migrations_frozen_now(req)
        by_replaces = {
            c.metadata.annotations.get(ANNOTATION_REPLACES): c
            for c in live if c.metadata.annotations.get(ANNOTATION_REPLACES)
        }
        migrating = [
            c for c in migrants
            if c.status.state == RESOURCE_STATE_MIGRATING
        ]
        marked = [
            c for c in migrants if c.status.state == RESOURCE_STATE_ONLINE
        ]
        status_dirty = False
        in_flight = 0

        # 1. Progress in-flight moves (make-before-break back half).
        for c in migrating:
            trigger = evacuate_trigger(c)
            record = req.status.migration.get(c.name)
            if record is None:
                # Crash window between the child writes and the request's
                # status write: rebuild the record from the durable
                # annotations so duration/trace identity survive-ish.
                record = MigrationRecord(
                    member=c.name, from_node=c.spec.target_node,
                    trigger=trigger, phase="attaching",
                    nonce=uuid.uuid4().hex[:12], started_at=now_iso(),
                )
                req.status.migration[c.name] = record
                status_dirty = True
            repl = by_replaces.get(c.name)
            if repl is None or repl.status.quarantined:
                # Replacement died before Online. The source is HEALTHY —
                # revert it to Online and retry the move fresh (the
                # evacuation annotation stays, so the next pass re-places
                # elsewhere; a quarantined target is excluded by the
                # allocator gates).
                if repl is not None:
                    self._delete_children(req, [repl])
                c.metadata.annotations.pop(ANNOTATION_REPLACED_BY, None)
                c.metadata.annotations.pop(ANNOTATION_REPAIR_DRAIN_START, None)
                try:
                    c = self.store.update(c)
                    c.status.state = RESOURCE_STATE_ONLINE
                    self.store.update_status(c)
                except (ConflictError, NotFoundError):
                    pass  # retried next pass
                req.status.migration.pop(c.name, None)
                status_dirty = True
                migrations_total.inc(trigger=trigger, outcome="retried")
                continue
            if record.replacement != repl.name:
                record.replacement = repl.name
                record.to_node = repl.spec.target_node
                status_dirty = True
            if repl.status.state != RESOURCE_STATE_ONLINE:
                in_flight += 1
                continue  # replacement attaching — event-driven wait
            # Cutover: the replacement is Online. Flip the authoritative
            # coordinates to the target — THIS status write is the
            # slice-change event workloads watch to checkpoint + reshard
            # onto the moved mesh (the test_reshard discipline) — then run
            # the drain grace before detaching the source.
            w = repl.spec.worker_id
            if (
                is_chip_group(req.spec.resource.type, req.spec.resource.model)
                and 0 <= w < len(req.status.slice.worker_hostnames)
                and req.status.slice.worker_hostnames[w] != repl.spec.target_node
            ):
                req.status.slice.worker_hostnames[w] = repl.spec.target_node
                status_dirty = True
            if record.phase != "cutover":
                record.phase = "cutover"
                status_dirty = True
                migrations_total.inc(trigger=trigger, outcome="cutover")
                with tracing.span(
                    "migrate.cutover", cat="controller",
                    trace_id=record.nonce or None, object=req.name,
                    resource=c.name, node=repl.spec.target_node,
                ):
                    self.recorder.event(
                        req, "Normal", "MigrationCutover",
                        f"worker {w} now serves from {repl.name}"
                        f" ({repl.spec.target_node}); draining source"
                        f" {c.name} ({c.spec.target_node})",
                    )
            if frozen:
                # Breaker open: the cutover stands (capacity was added),
                # but the source detach — a capacity REMOVAL — waits.
                in_flight += 1
                continue
            if not self._drain_grace_expired(
                c, req.spec.repair_grace_seconds
            ):
                in_flight += 1
                continue
            if not c.spec.force_detach:
                # The workload has had the whole grace window since the
                # cutover event to reshard off this member; load checks
                # against it would wedge the drain behind a client that
                # never releases.
                c.spec.force_detach = True
                try:
                    c = self.store.update(c)
                except (ConflictError, NotFoundError):
                    in_flight += 1
                    continue
            with tracing.span(
                "migrate.complete", cat="controller",
                trace_id=record.nonce or None, object=req.name,
                resource=c.name, node=c.spec.target_node,
            ):
                self._delete_children(req, [c])
            migrations_total.inc(trigger=trigger, outcome="completed")
            if record.started_at:
                try:
                    migration_duration_seconds.observe(
                        (parse_iso(now_iso()) - parse_iso(record.started_at))
                        .total_seconds(),
                        trigger=trigger,
                    )
                except ValueError:
                    pass
            req.status.migration.pop(c.name, None)
            status_dirty = True
            self.recorder.event(
                req, "Normal", "MigrationComplete",
                f"member {c.name} evacuated {record.from_node} ->"
                f" {record.to_node or repl.spec.target_node}"
                f" (trigger: {trigger}); detaching source",
            )

        # 1b. Complete interrupted transitions: a marked member that
        # already HAS a live replacement lost its Migrating mark (crash or
        # write conflict mid-_start_migration). Re-mark instead of placing
        # a second replacement.
        fresh = []
        for c in marked:
            if by_replaces.get(c.name) is None:
                fresh.append(c)
                continue
            c.status.state = RESOURCE_STATE_MIGRATING
            try:
                self.store.update_status(c)
            except (ConflictError, NotFoundError):
                pass  # retried next pass; the replacement already exists
            in_flight += 1

        # 2. Start new moves within the surge budgets (per-request AND
        # fleet-wide) — never while the breaker is open. The fleet budget
        # check and the starts it authorizes are one atomic section:
        # concurrent request reconciles must not all read the pre-start
        # count and stampede past --migrate-max-concurrent.
        if not frozen and fresh:
            per_request = max(1, req.spec.max_concurrent_repairs) - in_flight
            with self._migrate_lock:
                budget = min(per_request, self._fleet_migration_budget())
                for c in fresh[: max(0, budget)]:
                    trigger = evacuate_trigger(c)
                    try:
                        self._start_migration(req, c, trigger)
                        self._recent_migration_starts[c.name] = (
                            time.monotonic()
                        )
                        status_dirty = True
                    except UnsupportedRepair:
                        # Provider cannot re-carve a worker in place: fall
                        # back to break-before-make — detach the member
                        # and let the re-solve rebuild it elsewhere (the
                        # cordon keeps the drained host out of the
                        # re-placement).
                        if not c.spec.force_detach:
                            c.spec.force_detach = True
                            try:
                                c = self.store.update(c)
                            except (ConflictError, NotFoundError):
                                continue
                        self._delete_children(req, [c])
                        migrations_total.inc(trigger=trigger,
                                             outcome="fallback")
                        self.recorder.event(
                            req, WARNING, "MigrationFallback",
                            f"provider has no in-place member move;"
                            f" detaching {c.name} and re-solving"
                            " (break-before-make)",
                        )
                    except (AllocationError, FabricError) as e:
                        migrations_total.inc(trigger=trigger,
                                             outcome="failed")
                        msg = (
                            f"migration of {c.name} failed (will retry): {e}"
                        )
                        if req.status.error != msg:
                            req.status.error = msg
                            status_dirty = True
                            self.recorder.event(
                                req, WARNING, "MigrationFailed", msg
                            )
                        break  # capacity/fabric problem — siblings too
        if status_dirty:
            try:
                self._write_status(req)
            except (ConflictError, NotFoundError):
                pass  # rebuilt from durable child state next pass
        return Result(requeue_after=self.timing.repair_poll)

    def _start_migration(
        self, req: ComposabilityRequest, c: ComposableResource, trigger: str
    ) -> None:
        """Make-before-break front half for a HEALTHY member: place the
        replacement (honoring a defrag target hint when it still fits),
        re-carve the slice worker's chips there (tpu), create the
        replacement child, and mark the source Migrating. The replacement
        rides the normal Attaching machinery — durable pending_op intent,
        dispatcher batching, cold-start adoption — so a crash mid-migration is
        recovered like any other in-flight attach. Mutates req.status in
        memory; the caller's single end-of-pass write persists it."""
        res = req.spec.resource
        quarantined = self._quarantined_nodes()
        exclude = {
            ch.spec.target_node
            for ch in self._children(req) if not ch.being_deleted
        }
        node = self._migration_target(c, exclude, quarantined)
        if node is None:
            node = self._pick_replacement_node(req, c, quarantined, exclude)
        if is_chip_group(res.type, res.model) and c.spec.slice_name:
            # Re-carve worker w's chip group on the target from healthy
            # inventory (UnsupportedRepair -> caller falls back; the
            # source group stays attached until the source detaches).
            self._slice_fabric(req).repair_slice_member(
                c.spec.slice_name, c.spec.worker_id, node
            )

        nonce = uuid.uuid4().hex[:12]
        repl = self._build_replacement_child(req, c, node)
        with tracing.span(
            "migrate.start", cat="controller", trace_id=nonce,
            object=req.name, resource=c.name, node=node, trigger=trigger,
        ):
            self.store.create(repl)
        # Step 1b re-marks if this write loses; the replacement exists.
        self._pair_and_mark(c, repl.metadata.name, RESOURCE_STATE_MIGRATING)
        # Bookkeeping on the parent: the replacement's placement claim and
        # the durable migration record. The authoritative coordinates do
        # NOT flip yet — the source still serves worker w until cutover.
        req.status.resources[repl.metadata.name] = ResourceStatus(
            node_name=node,
            worker_id=c.spec.worker_id if is_chip_group(res.type, res.model) else -1,
        )
        req.status.migration[c.name] = MigrationRecord(
            member=c.name,
            replacement=repl.metadata.name,
            from_node=c.spec.target_node,
            to_node=node,
            trigger=trigger,
            phase="attaching",
            nonce=nonce,
            started_at=now_iso(),
        )
        migrations_total.inc(trigger=trigger, outcome="started")
        self.recorder.event(
            req, "Normal", "MigrationStarted",
            f"evacuating member {c.name} ({c.spec.target_node}) to"
            f" {repl.metadata.name} on {node}"
            f" (worker {c.spec.worker_id}, trigger: {trigger})",
        )

    def _migration_target(
        self, c: ComposableResource, exclude: set, quarantined: set
    ) -> Optional[str]:
        """Honor the defrag planner's verified target hint when it still
        fits; None sends the caller to the scheduler."""
        hint = c.metadata.annotations.get(ANNOTATION_EVACUATE_TARGET, "")
        if not hint or hint in exclude or hint in quarantined:
            return None
        node = self.store.try_get(Node, hint)
        if node is None or not node.status.ready or node.spec.unschedulable:
            return None
        used = self.scheduler.engine.used_slots_map()
        if node.status.tpu_slots - used.get(hint, 0) < c.spec.chip_count:
            return None
        return hint

    def _shrink_to_zero(self, req: ComposabilityRequest, children) -> Result:
        if children:
            self._delete_children(req, children)
            return Result(requeue_after=self.timing.cleaning_poll)
        self._slice_fabric(req).release_slice(self._slice_name(req))
        req.status.resources = {}
        req.status.slice = SliceStatus()
        req.status.scalar_resource = req.spec.resource
        req.status.state = REQUEST_STATE_UPDATING
        self._write_status(req)
        return Result(requeue_after=0.0)

    def _handle_cleaning(self, req: ComposabilityRequest) -> Result:
        self.scheduler.forget(req.name)  # a dying request stops queueing
        children = self._children(req)
        if children:
            self._delete_children(req, children)
            return Result(requeue_after=self.timing.cleaning_poll)
        self._slice_fabric(req).release_slice(self._slice_name(req))
        req.status.state = REQUEST_STATE_DELETING
        self._write_status(req)
        return Result(requeue_after=0.0)

    def _handle_deleting(self, req: ComposabilityRequest) -> Result:
        if not req.being_deleted:
            req = delete_tolerant(self.store, ComposabilityRequest, req.name)
            if req is None:
                return Result()  # purged concurrently — deletion complete
        if req.remove_finalizer(FINALIZER):
            try:
                self.store.update(req)
            except NotFoundError:
                pass  # purged between cache read and PUT — already gone
        return Result()
