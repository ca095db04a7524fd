"""coordination.k8s.io/v1 Lease — the cluster-grade leader-election object
(port of ``tpu_composer/api/lease.py``).

Reference analog: controller-runtime's manager acquires a Lease named
``c5744f42.hpsys.ibm.ie.com`` before starting any controller (the
reference operator's cmd/main.go:142-155). A file lock is correct on one
host and meaningless across replicas on different nodes. This type
serializes to the real coordination.k8s.io wire form (holderIdentity,
leaseDurationSeconds, acquireTime, renewTime, leaseTransitions), and the
in-proc ``Store``'s resourceVersion conflicts give the compare-and-swap
guarantee an apiserver would.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from tpu_composer_torch.api.meta import ApiObject, ObjectMeta


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: int = 15
    acquire_time: str = ""
    renew_time: str = ""
    lease_transitions: int = 0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "holderIdentity": self.holder_identity,
            "leaseDurationSeconds": self.lease_duration_seconds,
            "leaseTransitions": self.lease_transitions,
        }
        if self.acquire_time:
            d["acquireTime"] = self.acquire_time
        if self.renew_time:
            d["renewTime"] = self.renew_time
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LeaseSpec":
        return cls(
            holder_identity=d.get("holderIdentity", "") or "",
            lease_duration_seconds=int(d.get("leaseDurationSeconds", 15) or 15),
            acquire_time=d.get("acquireTime", "") or "",
            renew_time=d.get("renewTime", "") or "",
            lease_transitions=int(d.get("leaseTransitions", 0) or 0),
        )


@dataclass
class LeaseStatus:
    """coordination.k8s.io Leases have no status; kept for ApiObject shape."""

    def to_dict(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LeaseStatus":
        return cls()


class Lease(ApiObject):
    KIND = "Lease"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[LeaseSpec] = None,
        status: Optional[LeaseStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or LeaseSpec()
        self.status = status or LeaseStatus()

    def validate(self) -> None:
        pass
