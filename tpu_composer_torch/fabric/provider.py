"""FabricProvider interface — the seam between controllers and pool managers.

Reference analog: CdiProvider (internal/cdi/client.go:34-39):

    AddResource / RemoveResource / CheckResource / GetResources

with sentinel errors ErrWaitingDeviceAttaching / ErrWaitingDeviceDetaching
(client.go:41-44) meaning "operation in progress — requeue and call again".
The same contract is kept because it is what lets the per-resource state
machine treat slow fabric operations as level-triggered polling
(composableresource_controller.go:209-300).

TPU-first deltas:
- ``add_resource`` operates on a *chip group* (ComposableResource.spec
  carries chip_count/slice_name/worker_id/topology) and must program the ICI
  links joining the group to its slice, not just attach one device;
- ``reserve_slice``/``release_slice`` bracket multi-host groups so providers
  can allocate connected chips atomically with rollback (SURVEY.md §7
  hard-part #1 — the reference has no transaction concept);
- health is structured (DeviceHealth) instead of the reference's
  res_op_status digit convention (fti/cm/client.go:293-309).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_composer_torch.api.types import ComposableResource


class FabricError(Exception):
    """Terminal fabric failure — surfaces into status.error.

    Error taxonomy (the resilience layer's contract): raw ``FabricError``
    means the fabric answered and said NO — retrying the same call cannot
    succeed without operator/spec intervention (4xx, unknown model, pool
    exhausted). ``TransientFabricError`` means the fabric may well say yes
    next time (connection reset, timeout, 5xx, open breaker). Controllers
    budget and quarantine on transient failures; the circuit breaker counts
    only them toward tripping.
    """


class TransientFabricError(FabricError):
    """Retryable fabric failure — the endpoint was unreachable, timed out,
    or failed server-side (5xx). Safe to retry with backoff; consecutive
    occurrences count against breaker thresholds and attach budgets."""


def intent_nonce(resource: "ComposableResource") -> str:
    """The durable intent nonce riding the resource's ``status.pending_op``
    (the crash-consistency record) — the key that ties one fabric
    mutation/completion-event to one logical op. '' when no intent is
    recorded. The ONE extraction shared by every backend that forwards the
    nonce over the wire or stamps it into events."""
    po = resource.status.pending_op
    return po.nonce if po is not None else ""


def classify_fabric_error(cause: Exception, message: str) -> FabricError:
    """Re-wrap a fabric exception under a new message WITHOUT losing its
    transient/terminal classification (providers add call context like
    'attach r0: ...' — the class must survive that wrap)."""
    cls = TransientFabricError if isinstance(cause, TransientFabricError) else FabricError
    return cls(message)


class WaitingDeviceAttaching(FabricError):
    """Attach accepted but still in progress; requeue (client.go:41-42)."""


class UnsupportedResize(FabricError):
    """The provider cannot reshape a reservation in place; dissolve instead."""


class UnsupportedRepair(FabricError):
    """The provider cannot swap one worker's chip group in place
    (repair_slice_member). Like UnsupportedBatch/UnsupportedResize this is
    a capability probe, not a failure: the repair driver catches it and
    falls back to detach-and-re-solve (break-before-make)."""


class WaitingDeviceDetaching(FabricError):
    """Detach accepted but still in progress; requeue (client.go:43-44)."""


class UnsupportedBatch(FabricError):
    """The provider has no group attach/detach verb. The FabricDispatcher
    catches this once and falls back to transparent per-item calls — it is
    a capability probe, never an operational failure."""


class UnsupportedEvents(FabricError):
    """The provider has no server-push event stream (``poll_events``). The
    FabricSession probes once and goes dormant for the process lifetime;
    the dispatcher's poll timers remain the PRIMARY completion path — a
    capability probe like UnsupportedBatch, never a failure."""


class DispatchedAttaching(WaitingDeviceAttaching):
    """Attach queued in the FabricDispatcher; the FABRIC has not answered
    yet. Subclassed so the reconciler can tell 'the dispatcher holds your
    submission' apart from a real fabric wait sentinel: only the latter is
    evidence the endpoint answered for this node (and may reset
    attach-failure streaks); a synthetic queue acknowledgment is not."""


class DispatchedDetaching(WaitingDeviceDetaching):
    """Detach queued in the FabricDispatcher; see DispatchedAttaching."""


# Health states — replaces the reference's res_op_status first-digit scheme
# (0/1/2 = OK/Warning/Critical, fti/cm/client.go:293-309).
HEALTH_OK = "OK"
HEALTH_WARNING = "Warning"
HEALTH_CRITICAL = "Critical"


@dataclass
class DeviceHealth:
    state: str = HEALTH_OK
    detail: str = ""

    @property
    def healthy(self) -> bool:
        return self.state == HEALTH_OK


@dataclass
class AttachResult:
    """Outcome of a completed attach."""

    device_ids: List[str]  # chip UUIDs, slice-local worker order
    cdi_device_id: str  # CDI composite device name for the group


@dataclass
class FabricDevice:
    """One fabric-side attachment record, as reported by get_resources.

    Reference analog: the per-machine device lists walked by the
    UpstreamSyncer (upstreamsyncer_controller.go:79-138).
    """

    device_id: str
    node: str
    model: str
    slice_name: str = ""
    health: DeviceHealth = field(default_factory=DeviceHealth)
    # Explicit fabric device type ("tpu"/"gpu"/"cxlmemory"; "" when the
    # provider predates the field). The syncer's detach-CR creation uses
    # this instead of sniffing the model-name prefix.
    type: str = ""
    # Name of the ComposableResource whose attach produced this device
    # ("" for providers that do not track ownership, and for leaked
    # attachments with no owner). The cold-start adoption pass uses it to
    # recognize completed-but-unrecorded attaches exactly.
    resource_name: str = ""


class FabricProvider(abc.ABC):
    """All methods are thread-safe; controllers call them from worker threads."""

    @abc.abstractmethod
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        """Attach the chip group to resource.spec.target_node.

        Raises WaitingDeviceAttaching while in progress; idempotent — calling
        again after completion returns the same AttachResult (the reference's
        ADD_COMPLETE re-scan, fti/cm/client.go:445-472).
        """

    @abc.abstractmethod
    def remove_resource(self, resource: ComposableResource) -> None:
        """Detach the chip group. Raises WaitingDeviceDetaching while in
        progress; removing an unknown group is a no-op (idempotent)."""

    @abc.abstractmethod
    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        """Fabric-side health of an attached group (Online-state polling,
        composableresource_controller.go:317-330)."""

    @abc.abstractmethod
    def get_resources(self) -> List[FabricDevice]:
        """Every attachment the fabric currently knows about (drives the
        anti-drift syncer, upstreamsyncer_controller.go:85-97)."""

    # -- group verbs (fabric I/O pipeline; optional) --------------------
    def add_resources(
        self, resources: List[ComposableResource]
    ) -> List[object]:
        """Attach several chip groups bound for the SAME node in one
        provider call (the FabricDispatcher's per-node batch verb).

        Returns a list aligned with ``resources`` whose elements are each
        either an :class:`AttachResult` or a ``FabricError`` *instance*
        (including wait sentinels) describing that member's outcome — a
        partial failure must not raise, so one bad device cannot poison
        its group. Raising from this method means the WHOLE call failed
        (transport fault, dead endpoint): the dispatcher then splits the
        batch and retries member-by-member through ``add_resource``, so
        per-resource breaker/budget accounting is preserved.

        The default raises :class:`UnsupportedBatch`; providers without a
        native group verb get a transparent per-item fallback."""
        raise UnsupportedBatch(
            f"{type(self).__name__} has no group attach verb"
        )

    def remove_resources(
        self, resources: List[ComposableResource]
    ) -> List[object]:
        """Group detach twin of :meth:`add_resources`: per-member outcomes
        are ``None`` (detached / idempotent no-op) or a ``FabricError``
        instance; raising fails the whole call and triggers member-by-member
        split retry."""
        raise UnsupportedBatch(
            f"{type(self).__name__} has no group detach verb"
        )

    # -- event plane (server-push completions; optional) ----------------
    def poll_events(self, cursor: int, timeout: float = 5.0):
        """Long-poll the fabric's sequence-numbered event stream.

        Returns ``(events, next_cursor)`` where ``events`` is a list of
        :class:`tpu_composer_torch.fabric.events.FabricEvent` with ``seq >
        cursor`` (empty after ``timeout`` seconds of silence) and
        ``next_cursor`` is the highest sequence number the caller should
        resume from. ``cursor = -1`` tails: the provider returns no
        backlog, only its current head sequence number — a fresh session
        must not replay completions whose ops already settled by polling.

        Events carry op completions (keyed by the durable intent nonce the
        submitting controller wrote into ``status.pending_op``), device
        health transitions and inventory deltas. Consumers treat them as
        doorbells and re-read authoritative state through the idempotent
        verbs — a provider may therefore emit conservatively (extra events
        are one redundant wire call, missing events are caught by the
        safety-net polls).

        The default raises :class:`UnsupportedEvents`; providers without a
        stream keep today's poll-driven completion path bit-identically."""
        raise UnsupportedEvents(
            f"{type(self).__name__} has no event stream"
        )

    # -- slice transactions (TPU addition; default no-ops for gpu compat) --
    def reserve_slice(self, slice_name: str, model: str, topology: str, nodes: List[str]) -> None:
        """Atomically reserve ICI-adjacent chips for a whole slice across
        `nodes`. Raises FabricError (nothing reserved) on failure."""

    def release_slice(self, slice_name: str) -> None:
        """Tear down a slice reservation and any remaining attachments."""

    def resize_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        """Reprogram an existing reservation to a new topology while
        preserving the chip groups of hosts present in both the old and new
        node lists (live grow/shrink — the reference's closest analog is
        device reuse on spec drift, composabilityrequest_controller.go:
        254-305, which our atomic slice model otherwise forbids). Surviving
        hosts MUST form a stable prefix so worker_ids (and the TPU_* env
        already injected into running pods) stay valid.

        Providers without native ICI reprogramming MUST NOT emulate this
        with release+reserve — releasing tears down the survivors' chip
        reservations out from under running pods. The default refuses; the
        controller catches UnsupportedResize and falls back to its
        dissolve-and-rebuild path."""
        raise UnsupportedResize(
            f"{type(self).__name__} has no live slice resize"
        )

    def repair_slice_member(
        self, slice_name: str, worker_id: int, node: str
    ) -> None:
        """Re-carve ONE worker's chip group onto `node` from healthy free
        inventory, leaving every other worker's chips untouched (the
        make-before-break repair's fabric step). The retired chips stay
        attached to the failed member until it detaches; the provider must
        release them then (and must not hand known-dead chips back out).

        Raises FabricError when the pool cannot satisfy the re-carve
        (nothing changed). The default refuses with UnsupportedRepair; the
        repair driver then falls back to detach-and-re-solve, which never
        needs this verb."""
        raise UnsupportedRepair(
            f"{type(self).__name__} has no in-place member repair"
        )
