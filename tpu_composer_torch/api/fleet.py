"""FleetTelemetry — one replica's published observability snapshot (port
of ``tpu_composer/api/fleet.py``).

The sharded control plane has N replicas share one Store for
coordination state (shard Leases), but every observability layer is
per-process: N /metrics endpoints, N SLO engines each seeing 1/N of the
traffic. This kind is the carrier that closes the gap: each replica
periodically serializes its telemetry (full histogram bucket state, SLO
burn rates, per-subsystem GIL ratios, profiler top-N, owned shards) into
one ``FleetTelemetry`` object named after its identity, riding the SAME
store the shard leases already ride — so the fleet view works identically
for in-proc bench replicas and real OS processes, standalone or against a
kube-apiserver.

The payload is deliberately schema-free on the wire (the CRD uses
``x-kubernetes-preserve-unknown-fields``): its shape is owned by
``runtime/fleet.py`` and versioned by the ``seq``-advancing publisher, not
by the API layer — a telemetry format change must never need a CRD
migration. ``seq`` is the aggregator's observation clock: a snapshot whose
sequence number sits unchanged past the staleness window marks its replica
dead, exactly the RenewObservation discipline the shard leases use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from tpu_composer_torch.api.meta import ApiObject, ObjectMeta


@dataclass
class FleetTelemetrySpec:
    #: replica identity (the shard/member lease identity when sharded)
    identity: str = ""
    #: monotonically increasing per publish — the staleness clock
    seq: int = 0
    #: one token per OS process (pid + boot uuid): in-proc replicas share
    #: a metrics registry, so the aggregator merges histograms once per
    #: process, while per-replica fields (shards, identity) stay distinct
    process_token: str = ""
    #: the telemetry itself (runtime/fleet.py owns the shape)
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "identity": self.identity,
            "seq": self.seq,
            "processToken": self.process_token,
            "payload": self.payload,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetTelemetrySpec":
        return cls(
            identity=d.get("identity", "") or "",
            seq=int(d.get("seq", 0) or 0),
            process_token=d.get("processToken", "") or "",
            payload=dict(d.get("payload") or {}),
        )


@dataclass
class FleetTelemetryStatus:
    """Telemetry snapshots are spec-only (the publisher IS the source of
    truth); kept for ApiObject shape like LeaseStatus."""

    def to_dict(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FleetTelemetryStatus":
        return cls()


class FleetTelemetry(ApiObject):
    KIND = "FleetTelemetry"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[FleetTelemetrySpec] = None,
        status: Optional[FleetTelemetryStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or FleetTelemetrySpec()
        self.status = status or FleetTelemetryStatus()

    def validate(self) -> None:
        pass
