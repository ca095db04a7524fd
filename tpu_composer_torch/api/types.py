"""CRD-equivalent typed objects (port of ``tpu_composer/api/types.py``).

Reference analog:
- ComposabilityRequest: api/v1alpha1/composabilityrequest_types.go:36-106
- ComposableResource:   api/v1alpha1/composableresource_types.go:27-56

TPU-first deltas from the reference's data model:
- ``type: tpu`` is first-class; ``size`` means chip count and must solve to a
  valid ICI slice topology (see tpu_composer_torch.topology.slices), not N
  independent devices.
- A ComposableResource represents one *chip group on one host* (a slice
  member), carrying ``chip_count``, ``slice_name``, ``worker_id`` and
  ``topology`` — because TPU slices are allocated as connected topologies
  (SURVEY.md §5 "slice topology" note), unlike the reference's strictly
  per-device children.
- Status carries ``device_ids`` (list of chip UUIDs) instead of the single
  ``device_id`` string at composableresource_types.go:40.
- The request status gains a ``slice`` block (topology + worker hostnames) that
  the mutating webhook uses to inject ``TPU_*`` coordinates consistently with
  the final allocation (SURVEY.md §7 hard-part #4).

The NVIDIA H100 is ``type="gpu"`` with ``model="nvidia-h100-sxm"``: a
ComposableResource of that model is a slice member like a TPU group (one
host's GPUs, ``chip_count`` of them, with ``slice_name``, ``worker_id`` and
``topology``), and serializes those fields as a TPU group does. Field names
stay the API's, ``NodeStatus.tpu_slots`` included.

State strings deliberately match the reference's controller literals
(composableresource_controller.go:107-127, composabilityrequest_controller.go:108-142)
so operational knowledge transfers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch.api.meta import ApiObject, ObjectMeta
from tpu_composer_torch.topology.slices import is_gpu_model

# --- state machines (string literals, as the reference's controllers use) ---

# ComposabilityRequest states — composabilityrequest_controller.go:108-142
REQUEST_STATE_EMPTY = ""
REQUEST_STATE_NODE_ALLOCATING = "NodeAllocating"
REQUEST_STATE_UPDATING = "Updating"
REQUEST_STATE_RUNNING = "Running"
REQUEST_STATE_CLEANING = "Cleaning"
REQUEST_STATE_DELETING = "Deleting"

# ComposableResource states — composableresource_controller.go:107-127
RESOURCE_STATE_EMPTY = ""
RESOURCE_STATE_ATTACHING = "Attaching"
RESOURCE_STATE_ONLINE = "Online"
RESOURCE_STATE_DETACHING = "Detaching"
RESOURCE_STATE_DELETING = "Deleting"
# Self-healing additions (no reference analog — the reference's Online
# health poll only records an error string and a member with a dead chip
# sits Ready forever). Degraded: consecutive failed health probes (or the
# syncer observing the member's devices vanished from the fabric listing)
# crossed the damping threshold; the member stays attached, carries a
# structured status.failure record, and the owning request's repair driver
# decides what happens next. Repairing: the repair driver committed to
# replacing this member — a replacement child is attaching; once it is
# Online (plus the drain grace) this member is force-detached.
RESOURCE_STATE_DEGRADED = "Degraded"
RESOURCE_STATE_REPAIRING = "Repairing"
# Live migration (the evacuation analog of Repairing, but for a HEALTHY
# member being moved off its host — maintenance drain, node-escalation
# evacuation, defrag): the migration driver committed to moving this
# member; a replacement child is attaching on the target node while this
# member keeps serving. Once the replacement is Online the request's
# coordinates cut over (the slice-change event workloads reshard on) and
# this member is force-detached after the drain grace.
RESOURCE_STATE_MIGRATING = "Migrating"

# Device types — reference enum gpu|cxlmemory (composabilityrequest_types.go:41);
# tpu is our first-class addition.
DEVICE_TYPES = ("tpu", "gpu", "cxlmemory")

# Allocation policies — reference enum samenode|differentnode
# (composabilityrequest_types.go:47-49); "topology" is the TPU-native policy:
# place a connected slice across however many hosts its shape requires.
ALLOCATION_POLICIES = ("samenode", "differentnode", "topology")

# Preemption policies — modeled after PriorityClass.preemptionPolicy, but a
# single knob with victim-side meaning too: the default lets a request both
# preempt strictly-lower-priority requests and be preempted by strictly-higher
# ones; "Never" opts the request out of preemption in BOTH directions (it
# neither evicts others nor may be chosen as a victim or defrag migrant).
PREEMPT_LOWER_PRIORITY = "PreemptLowerPriority"
PREEMPT_NEVER = "Never"
PREEMPTION_POLICIES = (PREEMPT_LOWER_PRIORITY, PREEMPT_NEVER)

# Priority bounds (k8s user-priority range).
PRIORITY_MIN = -1_000_000_000
PRIORITY_MAX = 1_000_000_000

# Repair policies (spec.repairPolicy) — what the request controller does
# when a member degrades post-Ready:
#   Replace    make-before-break: place + attach a replacement member on
#              healthy capacity first, then force-detach the failed member
#              after the drain grace (default);
#   DetachOnly detach the failed member immediately and let the normal
#              lost-member recovery re-solve (break-before-make);
#   None       no automatic action — the member sits Degraded with its
#              failure record for an operator.
REPAIR_REPLACE = "Replace"
REPAIR_DETACH_ONLY = "DetachOnly"
REPAIR_NONE = "None"
REPAIR_POLICIES = (REPAIR_REPLACE, REPAIR_DETACH_ONLY, REPAIR_NONE)

FINALIZER = "tpu.composer.dev/finalizer"  # analog of com.ie.ibm.hpsys/finalizer

# Annotations (reference: cohdi.io/* at composabilityrequest_controller.go:46-47)
ANNOTATION_LAST_USED_TIME = "tpu.composer.dev/last-used-time"
ANNOTATION_DELETE_DEVICE = "tpu.composer.dev/delete-device"
# Wall-clock ISO timestamp on the syncer's orphan tracking objects: the
# first time the fabric reported a device with no local owner. Persisted so
# a controller restart cannot reset the orphan grace window (crash-loops
# would otherwise defer leak reclamation indefinitely).
ANNOTATION_ORPHAN_FIRST_SEEN = "tpu.composer.dev/orphan-first-seen"
# Repair linkage (self-healing data plane): a replacement member created by
# the repair driver names the failed member it replaces; the failed member
# names its replacement. Durable so a crash mid-repair resumes instead of
# double-placing (the surge budget and completion logic key on these).
ANNOTATION_REPLACES = "tpu.composer.dev/replaces"
ANNOTATION_REPLACED_BY = "tpu.composer.dev/replaced-by"
# Wall-clock ISO stamp set on the failed member when its replacement came
# Online: the drain grace window runs from here (crash-safe clock).
ANNOTATION_REPAIR_DRAIN_START = "tpu.composer.dev/repair-drain-start"
# Live migration (evacuation) marks. ANNOTATION_EVACUATE on a member asks
# its owner's migration driver to move it make-before-break; the value
# names the trigger ("maintenance:<name>" | "evacuation" | "defrag") so
# tpuc_migrations_total and the status.migration record attribute the move.
# Durable on the child so a crash mid-drain resumes instead of forgetting
# which members a NodeMaintenance already claimed.
ANNOTATION_EVACUATE = "tpu.composer.dev/evacuate"
# Optional placement hint from the defrag planner: the verified target the
# plan predicted. The migration driver honors it only if it still fits;
# otherwise it re-places via the scheduler like any other migration.
ANNOTATION_EVACUATE_TARGET = "tpu.composer.dev/evacuate-target"

# Migration triggers (the label values on tpuc_migrations_total{trigger}).
MIGRATE_TRIGGER_MAINTENANCE = "maintenance"
MIGRATE_TRIGGER_EVACUATION = "evacuation"
MIGRATE_TRIGGER_DEFRAG = "defrag"
LABEL_MANAGED_BY = "app.kubernetes.io/managed-by"
LABEL_READY_TO_DETACH = "tpu.composer.dev/ready-to-detach-device-id"


class ValidationError(ValueError):
    """Schema-level rejection, the analog of kubebuilder validation markers."""


# --------------------------------------------------------------------------
# Shared spec fragments
# --------------------------------------------------------------------------


@dataclass
class OtherSpec:
    """Extra node capacity the allocator must leave available.

    Reference: NodeSpec at composabilityrequest_types.go:56-64 (milli_cpu,
    memory, ephemeral_storage, allowed_pod_number) used by
    CheckNodeCapacitySufficient (utils/nodes.go:78-117).
    """

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "milli_cpu": self.milli_cpu,
            "memory": self.memory,
            "ephemeral_storage": self.ephemeral_storage,
            "allowed_pod_number": self.allowed_pod_number,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OtherSpec":
        return cls(
            milli_cpu=int(d.get("milli_cpu", 0)),
            memory=int(d.get("memory", 0)),
            ephemeral_storage=int(d.get("ephemeral_storage", 0)),
            allowed_pod_number=int(d.get("allowed_pod_number", 0)),
        )

    def validate(self) -> None:
        for f in ("milli_cpu", "memory", "ephemeral_storage", "allowed_pod_number"):
            if getattr(self, f) < 0:
                raise ValidationError(f"other_spec.{f} must be >= 0")


@dataclass
class ResourceDetails:
    """What the user asks for — reference ScalarResourceDetails
    (composabilityrequest_types.go:40-53).

    ``size`` for tpu means chip count; ``topology`` optionally pins an explicit
    slice shape (e.g. "2x2x1"); otherwise the solver picks one.
    """

    type: str = "tpu"
    model: str = ""
    size: int = 0
    force_detach: bool = False
    allocation_policy: str = "samenode"
    target_node: str = ""
    topology: str = ""
    other_spec: Optional[OtherSpec] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": self.type,
            "model": self.model,
            "size": self.size,
            "force_detach": self.force_detach,
            "allocation_policy": self.allocation_policy,
        }
        if self.target_node:
            d["target_node"] = self.target_node
        if self.topology:
            d["topology"] = self.topology
        if self.other_spec is not None:
            d["other_spec"] = self.other_spec.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceDetails":
        other = d.get("other_spec")
        return cls(
            type=d.get("type", "tpu"),
            model=d.get("model", ""),
            size=int(d.get("size", 0)),
            force_detach=bool(d.get("force_detach", False)),
            allocation_policy=d.get("allocation_policy", "samenode"),
            target_node=d.get("target_node", ""),
            topology=d.get("topology", ""),
            other_spec=OtherSpec.from_dict(other) if other is not None else None,
        )

    def validate(self) -> None:
        if self.type not in DEVICE_TYPES:
            raise ValidationError(
                f"resource.type must be one of {DEVICE_TYPES}, got {self.type!r}"
            )
        if not self.model:
            raise ValidationError("resource.model must be non-empty")  # MinLength=1
        if self.size < 0:
            raise ValidationError("resource.size must be >= 0")  # Minimum=0
        if self.allocation_policy not in ALLOCATION_POLICIES:
            raise ValidationError(
                f"resource.allocation_policy must be one of {ALLOCATION_POLICIES},"
                f" got {self.allocation_policy!r}"
            )
        if self.other_spec is not None:
            self.other_spec.validate()


# --------------------------------------------------------------------------
# ComposabilityRequest
# --------------------------------------------------------------------------


@dataclass
class ComposabilityRequestSpec:
    resource: ResourceDetails = field(default_factory=ResourceDetails)
    # Cluster-scheduler arbitration (scheduler/): higher priority places
    # first and may preempt strictly-lower-priority requests when capacity
    # is fragmented away. 0 is the batch default.
    priority: int = 0
    preemption_policy: str = PREEMPT_LOWER_PRIORITY
    # Self-healing: what the request controller does when a member of this
    # request degrades post-Ready (see REPAIR_POLICIES).
    repair_policy: str = REPAIR_REPLACE
    # Surge budget: at most this many members of this request may be under
    # active repair (replacement attaching / failed member draining) at
    # once — a multi-member brownout must not detach half the slice in one
    # pass.
    max_concurrent_repairs: int = 1
    # Seconds the failed member stays attached AFTER its replacement is
    # Online, so workloads can migrate off it before the force-detach.
    repair_grace_seconds: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"resource": self.resource.to_dict()}
        if self.priority:
            d["priority"] = self.priority
        if self.preemption_policy != PREEMPT_LOWER_PRIORITY:
            d["preemptionPolicy"] = self.preemption_policy
        if self.repair_policy != REPAIR_REPLACE:
            d["repairPolicy"] = self.repair_policy
        if self.max_concurrent_repairs != 1:
            d["maxConcurrentRepairs"] = self.max_concurrent_repairs
        if self.repair_grace_seconds:
            d["repairGraceSeconds"] = self.repair_grace_seconds
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComposabilityRequestSpec":
        return cls(
            resource=ResourceDetails.from_dict(d.get("resource", {})),
            priority=int(d.get("priority", 0)),
            preemption_policy=d.get("preemptionPolicy", PREEMPT_LOWER_PRIORITY),
            repair_policy=d.get("repairPolicy", REPAIR_REPLACE),
            max_concurrent_repairs=int(d.get("maxConcurrentRepairs", 1)),
            repair_grace_seconds=float(d.get("repairGraceSeconds", 0.0)),
        )

    def validate(self) -> None:
        self.resource.validate()
        if not PRIORITY_MIN <= self.priority <= PRIORITY_MAX:
            raise ValidationError(
                f"priority must be within [{PRIORITY_MIN}, {PRIORITY_MAX}],"
                f" got {self.priority}"
            )
        if self.preemption_policy not in PREEMPTION_POLICIES:
            raise ValidationError(
                f"preemptionPolicy must be one of {PREEMPTION_POLICIES},"
                f" got {self.preemption_policy!r}"
            )
        if self.repair_policy not in REPAIR_POLICIES:
            raise ValidationError(
                f"repairPolicy must be one of {REPAIR_POLICIES},"
                f" got {self.repair_policy!r}"
            )
        if self.max_concurrent_repairs < 1:
            raise ValidationError("maxConcurrentRepairs must be >= 1")
        if self.repair_grace_seconds < 0:
            raise ValidationError("repairGraceSeconds must be >= 0")


@dataclass
class PendingOp:
    """Durable record of a fabric mutation in flight for one resource.

    Written into ComposableResource.status BEFORE the attach/detach reaches
    the fabric, cleared when its outcome is recorded — so the *intent*
    survives a controller crash even when the in-memory dispatcher lanes and
    parked outcomes do not. The cold-start adoption pass
    (controllers/adoption.py) diffs these records against
    ``fabric.get_resources()`` to classify every in-flight op after a
    restart. No reference analog: the reference loses all in-flight intent
    on restart and leans entirely on its 30 s requeues + 10 min orphan
    grace to re-converge.
    """

    verb: str = ""  # "add" | "remove"
    #: Unique per issued intent; an op re-driven after a crash keeps its
    #: nonce, so a fabric mutation can be traced to exactly one intent
    #: (the kill–restart harness asserts zero double-attach on this).
    nonce: str = ""
    node: str = ""
    started_at: str = ""  # wall-clock ISO (monotonic clocks die with the process)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "verb": self.verb,
            "nonce": self.nonce,
            "node": self.node,
            "started_at": self.started_at,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PendingOp":
        return cls(
            verb=d.get("verb", ""),
            nonce=d.get("nonce", ""),
            node=d.get("node", ""),
            started_at=d.get("started_at", ""),
        )


@dataclass
class FailureRecord:
    """Structured record of why a member left Online for Degraded.

    Written by the detection paths (damped health probes in the resource
    controller, the syncer's device-vanished pass) in the same status write
    as the Degraded transition; cleared by recovery or teardown. Durable so
    a restarted operator — and the repair driver — see WHAT failed and HOW
    it was detected, not just an error string.
    """

    #: Short machine-readable cause: "health-probe" | "device-vanished".
    reason: str = ""
    detail: str = ""  # last health detail / missing device ids
    #: Which detector fired: "health-probe" | "syncer".
    source: str = ""
    observed_at: str = ""  # wall-clock ISO of the Degraded transition
    #: Consecutive failed observations that crossed the damping threshold.
    probe_failures: int = 0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"reason": self.reason}
        if self.detail:
            d["detail"] = self.detail
        if self.source:
            d["source"] = self.source
        if self.observed_at:
            d["observed_at"] = self.observed_at
        if self.probe_failures:
            d["probe_failures"] = self.probe_failures
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FailureRecord":
        return cls(
            reason=d.get("reason", ""),
            detail=d.get("detail", ""),
            source=d.get("source", ""),
            observed_at=d.get("observed_at", ""),
            probe_failures=int(d.get("probe_failures", 0)),
        )


@dataclass
class MigrationRecord:
    """One in-flight live migration of a slice member, recorded on the
    owning request's status (keyed by the migrating member's name).

    Written when the migration driver commits to the move (replacement
    child created, member marked Migrating) and removed when the source is
    detached (or the move is retired). Durable so a restarted operator —
    and any workload watching the request — sees WHERE each worker is
    moving, WHY, and how far along the make-before-break sequence it is.
    ``phase``: "attaching" (replacement still coming up; source remains the
    authoritative host) | "cutover" (replacement Online; coordinates point
    at the target and the drain grace runs before the source detach).
    """

    member: str = ""  # migrating (source) ComposableResource name
    replacement: str = ""  # the target-side child riding the normal attach
    from_node: str = ""
    to_node: str = ""
    trigger: str = ""  # maintenance | evacuation | defrag
    phase: str = ""  # attaching | cutover
    #: Migration identity: the trace id every migrate.* span joins, so the
    #: whole move renders as one connected trace across reconciles.
    nonce: str = ""
    started_at: str = ""  # wall-clock ISO (duration metric anchors here)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"member": self.member}
        if self.replacement:
            d["replacement"] = self.replacement
        if self.from_node:
            d["from_node"] = self.from_node
        if self.to_node:
            d["to_node"] = self.to_node
        if self.trigger:
            d["trigger"] = self.trigger
        if self.phase:
            d["phase"] = self.phase
        if self.nonce:
            d["nonce"] = self.nonce
        if self.started_at:
            d["started_at"] = self.started_at
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MigrationRecord":
        return cls(
            member=d.get("member", ""),
            replacement=d.get("replacement", ""),
            from_node=d.get("from_node", ""),
            to_node=d.get("to_node", ""),
            trigger=d.get("trigger", ""),
            phase=d.get("phase", ""),
            nonce=d.get("nonce", ""),
            started_at=d.get("started_at", ""),
        )


@dataclass
class ResourceStatus:
    """Per-child summary folded into the request status.

    Reference: ScalarResourceStatus (composabilityrequest_types.go:74-80), plus
    TPU additions (device_ids list, worker_id).
    """

    state: str = ""
    node_name: str = ""
    device_ids: List[str] = field(default_factory=list)
    cdi_device_id: str = ""
    worker_id: int = -1
    error: str = ""
    quarantined: bool = False
    # Verb of the child's in-flight fabric op ("add"/"remove", "" when
    # settled) — surfaced so an operator watching the request can see which
    # members still have fabric mutations outstanding (and a drain/restart
    # can be judged from the parent object alone).
    pending_verb: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"state": self.state}
        if self.node_name:
            d["node_name"] = self.node_name
        if self.device_ids:
            d["device_ids"] = list(self.device_ids)
        if self.cdi_device_id:
            d["cdi_device_id"] = self.cdi_device_id
        if self.worker_id >= 0:
            d["worker_id"] = self.worker_id
        if self.error:
            d["error"] = self.error
        if self.quarantined:
            d["quarantined"] = True
        if self.pending_verb:
            d["pending_verb"] = self.pending_verb
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceStatus":
        return cls(
            state=d.get("state", ""),
            node_name=d.get("node_name", ""),
            device_ids=list(d.get("device_ids", [])),
            cdi_device_id=d.get("cdi_device_id", ""),
            worker_id=int(d.get("worker_id", -1)),
            error=d.get("error", ""),
            quarantined=bool(d.get("quarantined", False)),
            pending_verb=d.get("pending_verb", ""),
        )


@dataclass
class SliceStatus:
    """The composed-slice view used for coordinate injection: the
    allocator's authoritative record of a slice's hosts, in worker
    order."""

    name: str = ""
    topology: str = ""
    num_hosts: int = 0
    chips_per_host: int = 0
    worker_hostnames: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.name:
            d["name"] = self.name
        if self.topology:
            d["topology"] = self.topology
        if self.num_hosts:
            d["num_hosts"] = self.num_hosts
        if self.chips_per_host:
            d["chips_per_host"] = self.chips_per_host
        if self.worker_hostnames:
            d["worker_hostnames"] = list(self.worker_hostnames)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SliceStatus":
        return cls(
            name=d.get("name", ""),
            topology=d.get("topology", ""),
            num_hosts=int(d.get("num_hosts", 0)),
            chips_per_host=int(d.get("chips_per_host", 0)),
            worker_hostnames=list(d.get("worker_hostnames", [])),
        )


@dataclass
class ComposabilityRequestStatus:
    state: str = ""
    error: str = ""
    resources: Dict[str, ResourceStatus] = field(default_factory=dict)
    # Spec snapshot for drift detection — reference status.scalarResource
    # (composabilityrequest_types.go:71, used at composabilityrequest_controller.go:495,:570-579)
    scalar_resource: Optional[ResourceDetails] = None
    slice: SliceStatus = field(default_factory=SliceStatus)
    # In-flight live migrations, keyed by the migrating member's name
    # (live-migration verb; see MigrationRecord).
    migration: Dict[str, MigrationRecord] = field(default_factory=dict)
    # Set once on the first transition to Running; guards the attach-to-ready
    # histogram against re-observation on recovery transitions.
    first_ready_time: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"state": self.state}
        if self.error:
            d["error"] = self.error
        if self.first_ready_time:
            d["first_ready_time"] = self.first_ready_time
        if self.resources:
            d["resources"] = {k: v.to_dict() for k, v in self.resources.items()}
        if self.scalar_resource is not None:
            d["scalarResource"] = self.scalar_resource.to_dict()
        s = self.slice.to_dict()
        if s:
            d["slice"] = s
        if self.migration:
            d["migration"] = {k: v.to_dict() for k, v in self.migration.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComposabilityRequestStatus":
        sr = d.get("scalarResource")
        return cls(
            state=d.get("state", ""),
            error=d.get("error", ""),
            resources={
                k: ResourceStatus.from_dict(v) for k, v in d.get("resources", {}).items()
            },
            scalar_resource=ResourceDetails.from_dict(sr) if sr is not None else None,
            slice=SliceStatus.from_dict(d.get("slice", {})),
            migration={
                k: MigrationRecord.from_dict(v)
                for k, v in d.get("migration", {}).items()
            },
            first_ready_time=d.get("first_ready_time", ""),
        )


class ComposabilityRequest(ApiObject):
    KIND = "ComposabilityRequest"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[ComposabilityRequestSpec] = None,
        status: Optional[ComposabilityRequestStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or ComposabilityRequestSpec()
        self.status = status or ComposabilityRequestStatus()

    def validate(self) -> None:
        self.spec.validate()


# --------------------------------------------------------------------------
# ComposableResource
# --------------------------------------------------------------------------


@dataclass
class ComposableResourceSpec:
    """One chip-group on one host.

    Reference: ComposableResourceSpec (composableresource_types.go:27-33) plus
    the TPU slice-membership fields.
    """

    type: str = "tpu"
    model: str = ""
    target_node: str = ""
    force_detach: bool = False
    # TPU slice membership (no reference analog; SURVEY.md §7 checklist #1)
    chip_count: int = 1
    slice_name: str = ""
    worker_id: int = 0
    topology: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": self.type,
            "model": self.model,
            "target_node": self.target_node,
            "force_detach": self.force_detach,
        }
        if self.type == "tpu" or is_gpu_model(self.model):
            d["chip_count"] = self.chip_count
            d["slice_name"] = self.slice_name
            d["worker_id"] = self.worker_id
            d["topology"] = self.topology
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComposableResourceSpec":
        return cls(
            type=d.get("type", "tpu"),
            model=d.get("model", ""),
            target_node=d.get("target_node", ""),
            force_detach=bool(d.get("force_detach", False)),
            chip_count=int(d.get("chip_count", 1)),
            slice_name=d.get("slice_name", ""),
            worker_id=int(d.get("worker_id", 0)),
            topology=d.get("topology", ""),
        )

    def validate(self) -> None:
        if self.type not in DEVICE_TYPES:
            raise ValidationError(f"type must be one of {DEVICE_TYPES}")
        if not self.model:
            raise ValidationError("model must be non-empty")
        if not self.target_node:
            raise ValidationError("target_node must be non-empty")
        if self.chip_count < 1:
            raise ValidationError("chip_count must be >= 1")


@dataclass
class ComposableResourceStatus:
    state: str = ""
    error: str = ""
    device_ids: List[str] = field(default_factory=list)
    cdi_device_id: str = ""
    # Host-local device-node indices (/dev/accel<i>) assigned to this group.
    # Persisted so co-located groups on one host keep disjoint nodes across
    # controller restarts (no reference analog — one GPU per CR there).
    chip_indices: List[int] = field(default_factory=list)
    # Resilience bookkeeping (docs/RESILIENCE.md): consecutive transient
    # attach failures; when the budget is exhausted the resource is marked
    # quarantined and the owning request reallocates around its node.
    # Persisted in status so the budget survives controller restarts.
    attach_attempts: int = 0
    quarantined: bool = False
    # Durable fabric-mutation intent (crash consistency): set before the
    # attach/detach is issued, cleared when its outcome lands in status.
    # The cold-start adoption pass reconstructs in-flight work from this.
    pending_op: Optional[PendingOp] = None
    # Structured cause of the Degraded transition (self-healing data plane);
    # set with the Online->Degraded write, cleared on recovery/teardown.
    failure: Optional[FailureRecord] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"state": self.state}
        if self.error:
            d["error"] = self.error
        if self.device_ids:
            d["device_ids"] = list(self.device_ids)
        if self.cdi_device_id:
            d["cdi_device_id"] = self.cdi_device_id
        if self.chip_indices:
            d["chip_indices"] = list(self.chip_indices)
        if self.attach_attempts:
            d["attach_attempts"] = self.attach_attempts
        if self.quarantined:
            d["quarantined"] = True
        if self.pending_op is not None:
            d["pending_op"] = self.pending_op.to_dict()
        if self.failure is not None:
            d["failure"] = self.failure.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComposableResourceStatus":
        pending = d.get("pending_op")
        failure = d.get("failure")
        return cls(
            state=d.get("state", ""),
            error=d.get("error", ""),
            device_ids=list(d.get("device_ids", [])),
            cdi_device_id=d.get("cdi_device_id", ""),
            chip_indices=[int(i) for i in d.get("chip_indices", [])],
            attach_attempts=int(d.get("attach_attempts", 0)),
            quarantined=bool(d.get("quarantined", False)),
            pending_op=PendingOp.from_dict(pending) if pending else None,
            failure=FailureRecord.from_dict(failure) if failure else None,
        )


class ComposableResource(ApiObject):
    KIND = "ComposableResource"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[ComposableResourceSpec] = None,
        status: Optional[ComposableResourceStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or ComposableResourceSpec()
        self.status = status or ComposableResourceStatus()

    def validate(self) -> None:
        self.spec.validate()


# --------------------------------------------------------------------------
# Node — the worker-node view the allocator and node agent operate on.
# Reference analog: corev1.Node objects listed by utils/nodes.go:119-135 and
# capacity-checked at nodes.go:78-117. We model only what the controllers use.
# --------------------------------------------------------------------------


@dataclass
class NodeSpec:
    # Hostname or address the node agent for this node is reachable at.
    agent_endpoint: str = ""
    # Schedulable toggle (reference analog: node cordon).
    unschedulable: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "agent_endpoint": self.agent_endpoint,
            "unschedulable": self.unschedulable,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeSpec":
        return cls(
            agent_endpoint=d.get("agent_endpoint", ""),
            unschedulable=bool(d.get("unschedulable", False)),
        )


@dataclass
class NodeStatus:
    # Allocatable scalar capacity, the fields CheckNodeCapacitySufficient
    # consults (utils/nodes.go:78-117).
    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    # Max chips this host can accept over the fabric (PCIe/ICI ports free):
    # TPU chips on a TPU host, GPUs on an H100 host (the API keeps the name).
    tpu_slots: int = 0
    ready: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return {
            "milli_cpu": self.milli_cpu,
            "memory": self.memory,
            "ephemeral_storage": self.ephemeral_storage,
            "allowed_pod_number": self.allowed_pod_number,
            "tpu_slots": self.tpu_slots,
            "ready": self.ready,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NodeStatus":
        return cls(
            milli_cpu=int(d.get("milli_cpu", 0)),
            memory=int(d.get("memory", 0)),
            ephemeral_storage=int(d.get("ephemeral_storage", 0)),
            allowed_pod_number=int(d.get("allowed_pod_number", 0)),
            tpu_slots=int(d.get("tpu_slots", 0)),
            ready=bool(d.get("ready", True)),
        )


class Node(ApiObject):
    KIND = "Node"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[NodeSpec] = None,
        status: Optional[NodeStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or NodeSpec()
        self.status = status or NodeStatus()

    def validate(self) -> None:
        pass
