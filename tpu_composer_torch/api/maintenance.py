"""NodeMaintenance — declarative node drain for planned maintenance.
(Port of ``tpu_composer/api/maintenance.py``.)

The K8s DRA composable-architecture work (PAPERS.md 2506.23628) argues for
drain/maintenance as a declarative node-side state, and Funky (PAPERS.md
2510.15755) makes checkpoint + live migration first-class operator verbs;
this kind is where the two meet in tpu-composer. Creating a NodeMaintenance
for a host:

1. **Cordon** — the maintenance controller writes the durable whole-node
   quarantine marker (the DeviceTaintRule shape, distinct
   ``maintenance:<name>`` reason) so the scheduler routes nothing new there
   for the whole maintenance window;
2. **Drain** — every live slice member on the node is marked for
   evacuation; the owning requests' migration drivers move each one
   make-before-break (replacement attached on fresh capacity BEFORE the
   source detaches, workloads resharding on the cutover event), bounded by
   per-request surge budgets and the fleet migration breaker;
3. **Drained** — the node holds no members; hardware work can start. The
   quarantine marker stays until the NodeMaintenance is DELETED (ending the
   window uncordons the node) — mirroring kubectl cordon/uncordon.

A drain that cannot finish by ``deadline_seconds`` **aborts**: unstarted
evacuation marks are withdrawn, the quarantine marker is cleared, and the
object parks in Aborted with the reason — capacity returns instead of
wedging half-drained forever. In-flight make-before-break moves are left to
complete (aborting a half-cutover move would be strictly worse than
finishing it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from tpu_composer_torch.api.meta import ApiObject, ObjectMeta
from tpu_composer_torch.api.types import ValidationError

# State machine (status.state).
MAINTENANCE_STATE_EMPTY = ""
MAINTENANCE_STATE_CORDONED = "Cordoned"
MAINTENANCE_STATE_DRAINING = "Draining"
MAINTENANCE_STATE_DRAINED = "Drained"
MAINTENANCE_STATE_ABORTED = "Aborted"

#: Quarantine-marker reason prefix for maintenance cordons — the
#: maintenance controller clears only ITS OWN marker on completion/abort,
#: never one placed by the attach-budget or node-escalation paths.
MAINTENANCE_REASON_PREFIX = "maintenance:"


@dataclass
class NodeMaintenanceSpec:
    #: Host to cordon + drain. Immutable in spirit (the webhook rejects
    #: empty; retargeting a live drain is undefined — delete and recreate).
    node_name: str = ""
    #: Seconds the drain may run before aborting; 0 falls back to the
    #: operator-wide default (--migrate-drain-deadline), < 0 disables the
    #: deadline entirely (drain until done).
    deadline_seconds: float = 0.0
    #: Free-form operator note, surfaced in events and status.
    reason: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"node_name": self.node_name}
        if self.deadline_seconds:
            d["deadline_seconds"] = self.deadline_seconds
        if self.reason:
            d["reason"] = self.reason
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeMaintenanceSpec":
        return cls(
            node_name=d.get("node_name", ""),
            deadline_seconds=float(d.get("deadline_seconds", 0.0) or 0.0),
            reason=d.get("reason", ""),
        )

    def validate(self) -> None:
        if not self.node_name:
            raise ValidationError("node_name must be non-empty")


@dataclass
class NodeMaintenanceStatus:
    state: str = ""
    #: Wall-clock ISO of the Draining transition — the deadline clock
    #: (crash-safe: a restarted operator resumes the same window).
    started_at: str = ""
    #: Members already evacuated off the node by this drain.
    evacuated: int = 0
    #: Live members still on the node (level-set every pass).
    remaining: int = 0
    message: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"state": self.state}
        if self.started_at:
            d["started_at"] = self.started_at
        if self.evacuated:
            d["evacuated"] = self.evacuated
        if self.remaining:
            d["remaining"] = self.remaining
        if self.message:
            d["message"] = self.message
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeMaintenanceStatus":
        return cls(
            state=d.get("state", ""),
            started_at=d.get("started_at", ""),
            evacuated=int(d.get("evacuated", 0) or 0),
            remaining=int(d.get("remaining", 0) or 0),
            message=d.get("message", ""),
        )


class NodeMaintenance(ApiObject):
    KIND = "NodeMaintenance"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[NodeMaintenanceSpec] = None,
        status: Optional[NodeMaintenanceStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or NodeMaintenanceSpec()
        self.status = status or NodeMaintenanceStatus()

    def validate(self) -> None:
        self.spec.validate()
