"""NodeMaintenance reconciler — cordon, drain via live migration, abort.
(Port of ``tpu_composer/controllers/maintenance.py``.)

The declarative node-drain verb (api/maintenance.py): an operator creates a
NodeMaintenance naming a host; this controller cordons it with the durable
whole-node quarantine marker (distinct ``maintenance:<name>`` reason) and
marks every live member on it for evacuation. The owning requests' live-
migration drivers (request_controller._drive_migrations) do the actual
make-before-break moves — this controller only CLAIMS members and watches
the node empty, so the surge budgets and the fleet migration breaker bound
a drain exactly like any other evacuation.

State machine::

    "" ── cordon (quarantine marker) ──▶ Cordoned ──▶ Draining
                                                        │
                     node empty of members ◀────────────┤
                               │                        │ deadline expired
                               ▼                        ▼
                            Drained                  Aborted
                     (marker STAYS until           (unstarted marks
                      the object is deleted         withdrawn, marker
                      — the maintenance window)     cleared — capacity
                                                    returns)

Deleting the object at ANY point uncordons: evacuation marks this drain
placed are withdrawn from members not yet moving, and the maintenance
quarantine marker is cleared (markers placed by the attach-budget or
escalation paths are never touched — only our own ``maintenance:`` reason).
In-flight migrations are left to complete: aborting a half-cutover move
would be strictly worse than finishing it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from tpu_composer_torch.agent.publisher import (
    DevicePublisher,
    node_quarantine_name,
)
from tpu_composer_torch.api.dra import DeviceTaintRule
from tpu_composer_torch.api.maintenance import (
    MAINTENANCE_REASON_PREFIX,
    MAINTENANCE_STATE_ABORTED,
    MAINTENANCE_STATE_CORDONED,
    MAINTENANCE_STATE_DRAINED,
    MAINTENANCE_STATE_DRAINING,
    MAINTENANCE_STATE_EMPTY,
    NodeMaintenance,
)
from tpu_composer_torch.api.meta import now_iso, parse_iso
from tpu_composer_torch.api.types import (
    ANNOTATION_EVACUATE,
    ANNOTATION_EVACUATE_TARGET,
    ComposableResource,
    FINALIZER,
    LABEL_READY_TO_DETACH,
    MIGRATE_TRIGGER_MAINTENANCE,
    RESOURCE_STATE_ONLINE,
)
from tpu_composer_torch.runtime.controller import Controller, Result
from tpu_composer_torch.runtime.events import WARNING, EventRecorder
from tpu_composer_torch.runtime.metrics import (
    migrations_total,
    node_maintenances_active,
)
from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    Store,
    WatchEvent,
)


@dataclass
class MaintenanceTiming:
    #: Drain-progress safety-net poll; the ComposableResource watch is the
    #: primary wake signal (a member leaving the node re-enqueues).
    drain_poll: float = 0.5
    #: Deadline applied when spec.deadline_seconds == 0
    #: (--migrate-drain-deadline); <= 0 means no default deadline.
    default_deadline: float = 1800.0


def evacuate_value(maintenance_name: str) -> str:
    return f"{MIGRATE_TRIGGER_MAINTENANCE}:{maintenance_name}"


class NodeMaintenanceReconciler(Controller):
    primary_kind = "NodeMaintenance"

    def __init__(
        self,
        store: Store,
        timing: Optional[MaintenanceTiming] = None,
        recorder: Optional[EventRecorder] = None,
        publisher=None,
        ownership=None,
    ) -> None:
        super().__init__(store, ownership=ownership)
        self.timing = timing or MaintenanceTiming()
        self.recorder = recorder or EventRecorder()
        self.publisher = publisher or DevicePublisher(store)
        # Drain progress is event-driven: any member change on a drained
        # node wakes its maintenance object (DELETED events especially —
        # the "node empty" edge must not wait out drain_poll).
        self.watch("ComposableResource", mapper=self._map_member_event)

    def _map_member_event(self, ev: WatchEvent) -> List[str]:
        node = ev.obj.spec.target_node
        if not node:
            return []
        return [
            m.metadata.name
            for m in self.store.list(NodeMaintenance)
            if m.spec.node_name == node
        ]

    # ------------------------------------------------------------------
    def reconcile(self, name: str) -> Result:
        m = self.store.try_get(NodeMaintenance, name)
        if m is None:
            self._refresh_gauge()
            return Result()
        if m.being_deleted:
            return self._handle_deleted(m)
        state = m.status.state
        if state == MAINTENANCE_STATE_EMPTY:
            return self._handle_none(m)
        if state in (MAINTENANCE_STATE_CORDONED, MAINTENANCE_STATE_DRAINING):
            return self._handle_draining(m)
        if state == MAINTENANCE_STATE_ABORTED:
            # Level-triggered sweep: a mark withdrawal that lost a write
            # conflict during _abort must not leave a live evacuation mark
            # on an uncordoned node — the migration driver would execute
            # the very move the abort cancelled. Member watch events (and
            # any reconcile of this object) retry the withdrawal.
            self._withdraw_marks(m)
        # Drained / Aborted: terminal until deletion (the window).
        self._refresh_gauge()
        return Result()

    # ------------------------------------------------------------------
    def _members(self, node: str) -> List[ComposableResource]:
        """Live members still occupying the node. Syncer detach-CRs
        (ready-to-detach orphan reclaimers) are already teardown-bound and
        never block a drain."""
        return [
            c for c in self.store.list(ComposableResource)
            if c.spec.target_node == node
            and not c.being_deleted
            and not c.metadata.labels.get(LABEL_READY_TO_DETACH)
        ]

    def _refresh_gauge(self) -> None:
        active = sum(
            1 for m in self.store.list(NodeMaintenance)
            if not m.being_deleted and m.status.state in (
                MAINTENANCE_STATE_CORDONED, MAINTENANCE_STATE_DRAINING,
            )
        )
        node_maintenances_active.set(float(active))

    def _opted_out(self, c: ComposableResource) -> bool:
        """True when the member's owner opted out of the replacement
        machinery (repairPolicy=None) — live migration rides it, so such
        members are never claimed for evacuation."""
        from tpu_composer_torch.api.types import (
            LABEL_MANAGED_BY,
            REPAIR_NONE,
            ComposabilityRequest,
        )

        owner = c.metadata.labels.get(LABEL_MANAGED_BY, "")
        if not owner:
            return True  # standalone CR: nothing drives a migration for it
        req = self.store.try_get(ComposabilityRequest, owner)
        return req is None or req.spec.repair_policy == REPAIR_NONE

    def _own_marker(self, node: str):
        """This drain's quarantine marker, or None when the node is
        unmarked OR carries someone else's marker (attach-budget /
        escalation reasons are never ours to clear)."""
        rule = self.store.try_get(DeviceTaintRule, node_quarantine_name(node))
        if rule is None:
            return None
        if not rule.spec.reason.startswith(MAINTENANCE_REASON_PREFIX):
            return None
        return rule

    # ------------------------------------------------------------------
    def _handle_none(self, m: NodeMaintenance) -> Result:
        if m.add_finalizer(FINALIZER):
            m = self.store.update(m)
        # Cordon FIRST (idempotent create; a marker already present from
        # the escalation path serves the same purpose and stays theirs),
        # then record the durable deadline clock. Ordered so a crash
        # between the two re-runs the no-op cordon, never drains an
        # uncordoned node.
        self.publisher.quarantine_node(
            m.spec.node_name,
            evacuate_value(m.name)
            + (f" ({m.spec.reason})" if m.spec.reason else ""),
        )
        m.status.state = MAINTENANCE_STATE_CORDONED
        m.status.started_at = now_iso()
        m.status.remaining = len(self._members(m.spec.node_name))
        try:
            self._update_status(m)
        except NotFoundError:
            return Result()
        self.recorder.event(
            m, "Normal", "Cordoned",
            f"node {m.spec.node_name} cordoned for maintenance"
            f" ({m.status.remaining} member(s) to evacuate)",
        )
        self._refresh_gauge()
        return Result(requeue_after=0.0)

    def _handle_draining(self, m: NodeMaintenance) -> Result:
        node = m.spec.node_name
        members = self._members(node)
        prev_remaining = m.status.remaining
        changed = False

        if not members:
            m.status.state = MAINTENANCE_STATE_DRAINED
            m.status.evacuated += max(0, prev_remaining)
            m.status.remaining = 0
            m.status.message = (
                "node empty; maintenance window open — delete this"
                " NodeMaintenance to uncordon"
            )
            try:
                self._update_status(m)
            except NotFoundError:
                return Result()
            self.recorder.event(
                m, "Normal", "Drained",
                f"node {node} drained ({m.status.evacuated} member(s)"
                " evacuated); hardware work can start",
            )
            self._refresh_gauge()
            return Result()

        # Deadline: the drain may not run forever — capacity must return.
        deadline = m.spec.deadline_seconds
        if deadline == 0:
            deadline = self.timing.default_deadline
        if deadline > 0 and m.status.started_at:
            try:
                elapsed = (
                    parse_iso(now_iso()) - parse_iso(m.status.started_at)
                ).total_seconds()
            except ValueError:
                elapsed = 0.0
            if elapsed > deadline:
                return self._abort(m, members, elapsed, deadline)

        # Claim members for evacuation. Only Online members are marked
        # (Degraded/Repairing belong to the repair driver, which already
        # places replacements OFF the cordoned node; Attaching members are
        # claimed once they come up). Members whose owner opted out of the
        # replacement machinery (repairPolicy=None) are never claimed —
        # the migration driver would refuse the move anyway; they hold the
        # drain until the deadline aborts it, and the status message says
        # why. Marks carry this drain's identity so cleanup withdraws
        # only its own.
        unmigratable = 0
        for c in members:
            if c.status.state != RESOURCE_STATE_ONLINE:
                continue
            if self._opted_out(c):
                unmigratable += 1
                continue
            if c.metadata.annotations.get(ANNOTATION_EVACUATE):
                continue  # already claimed (by us, defrag, or escalation)
            c.metadata.annotations[ANNOTATION_EVACUATE] = evacuate_value(m.name)
            try:
                self.store.update(c)
            except (ConflictError, NotFoundError):
                pass  # re-claimed next pass

        if m.status.state != MAINTENANCE_STATE_DRAINING:
            m.status.state = MAINTENANCE_STATE_DRAINING
            changed = True
        if len(members) != prev_remaining:
            m.status.evacuated += max(0, prev_remaining - len(members))
            m.status.remaining = len(members)
            changed = True
        msg = (
            f"{len(members)} member(s) remaining on {node}"
            f" ({sum(1 for c in members if c.status.state == 'Migrating')}"
            " migrating"
            + (f", {unmigratable} unmigratable: repairPolicy=None"
               if unmigratable else "")
            + ")"
        )
        if m.status.message != msg:
            m.status.message = msg
            changed = True
        if changed:
            try:
                self._update_status(m)
            except NotFoundError:
                return Result()
        self._refresh_gauge()
        return Result(requeue_after=self.timing.drain_poll)

    def _withdraw_marks(self, m: NodeMaintenance, count: bool = False) -> int:
        """Withdraw this drain's unstarted (Online-member) evacuation
        marks. Idempotent and level-triggered: the Aborted sweep re-runs
        it until every mark is gone, so a lost write conflict here is a
        retry, never a leak. Members already mid-move (Migrating) keep
        their marks and finish — their make-before-break is past the
        point where stopping helps anyone."""
        withdrawn = 0
        for c in self._members(m.spec.node_name):
            if (
                c.metadata.annotations.get(ANNOTATION_EVACUATE)
                == evacuate_value(m.name)
                and c.status.state == RESOURCE_STATE_ONLINE
            ):
                c.metadata.annotations.pop(ANNOTATION_EVACUATE, None)
                c.metadata.annotations.pop(ANNOTATION_EVACUATE_TARGET, None)
                try:
                    self.store.update(c)
                    withdrawn += 1
                    if count:
                        migrations_total.inc(
                            trigger=MIGRATE_TRIGGER_MAINTENANCE,
                            outcome="aborted",
                        )
                except (ConflictError, NotFoundError):
                    pass  # the Aborted sweep / deleted-path retries
        return withdrawn

    def _abort(
        self, m: NodeMaintenance, members, elapsed: float, deadline: float
    ) -> Result:
        """Deadline expired: withdraw this drain's unstarted evacuation
        marks, uncordon, park in Aborted (whose reconcile keeps sweeping
        leftover marks until they are gone)."""
        node = m.spec.node_name
        withdrawn = self._withdraw_marks(m, count=True)
        if self._own_marker(node) is not None:
            self.publisher.clear_node_quarantine(node)
        m.status.state = MAINTENANCE_STATE_ABORTED
        m.status.remaining = len(members)
        m.status.message = (
            f"drain deadline expired after {elapsed:.0f}s"
            f" (deadline {deadline:.0f}s) with {len(members)} member(s)"
            f" remaining; {withdrawn} evacuation mark(s) withdrawn and the"
            " node uncordoned"
        )
        try:
            self._update_status(m)
        except NotFoundError:
            return Result()
        self.recorder.event(m, WARNING, "DrainAborted", m.status.message)
        self.log.warning("%s: %s", m.name, m.status.message)
        self._refresh_gauge()
        return Result()

    def _handle_deleted(self, m: NodeMaintenance) -> Result:
        """Uncordon on deletion, whatever state the drain reached: withdraw
        this drain's remaining marks, clear our marker, release the
        finalizer."""
        node = m.spec.node_name
        for c in self._members(node):
            if (
                c.metadata.annotations.get(ANNOTATION_EVACUATE)
                == evacuate_value(m.name)
            ):
                c.metadata.annotations.pop(ANNOTATION_EVACUATE, None)
                c.metadata.annotations.pop(ANNOTATION_EVACUATE_TARGET, None)
                try:
                    self.store.update(c)
                except (ConflictError, NotFoundError):
                    pass
        if self._own_marker(node) is not None:
            self.publisher.clear_node_quarantine(node)
        if m.remove_finalizer(FINALIZER):
            try:
                self.store.update(m)
            except NotFoundError:
                pass  # purged concurrently — done
        self._refresh_gauge()
        return Result()

    def _update_status(self, m: NodeMaintenance) -> None:
        try:
            self.store.update_status(m)
        except ConflictError:
            pass  # level-derived; the requeue recomputes from fresh state
