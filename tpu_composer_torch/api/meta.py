"""Object metadata and serde primitives (port of ``tpu_composer/api/meta.py``).

Reference analog: k8s.io/apimachinery ObjectMeta as used by
the reference's api/v1alpha1/*_types.go. We implement only the fields the
reference's controllers actually rely on: name, uid, labels, annotations,
finalizers, resourceVersion (optimistic concurrency), generation,
creationTimestamp, deletionTimestamp (finalizer-gated delete), and
ownerReferences (GC of children).
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def now_iso() -> str:
    """RFC3339 UTC timestamp, the serialization K8s uses for *Timestamp."""
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


def parse_iso(ts: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))


def new_uid() -> str:
    return str(uuid.uuid4())


@dataclass
class OwnerReference:
    """Parent pointer used for cascading GC.

    Reference analog: metav1.OwnerReference; the reference instead links
    children by the label ``app.kubernetes.io/managed-by=<request>``
    (composabilityrequest_controller.go:222-235). We support both — labels for
    list-selection parity and owner refs for robust GC.
    """

    kind: str
    name: str
    uid: str = ""
    controller: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OwnerReference":
        return cls(
            kind=d["kind"],
            name=d["name"],
            uid=d.get("uid", ""),
            controller=d.get("controller", True),
        )


@dataclass
class ObjectMeta:
    name: str = ""
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: str = ""
    deletion_timestamp: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "uid": self.uid,
            "resourceVersion": self.resource_version,
            "generation": self.generation,
            "creationTimestamp": self.creation_timestamp,
        }
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        if self.owner_references:
            d["ownerReferences"] = [o.to_dict() for o in self.owner_references]
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            uid=d.get("uid", ""),
            resource_version=int(d.get("resourceVersion", 0)),
            generation=int(d.get("generation", 0)),
            labels=dict(d.get("labels", {})),
            annotations=dict(d.get("annotations", {})),
            finalizers=list(d.get("finalizers", [])),
            owner_references=[
                OwnerReference.from_dict(o) for o in d.get("ownerReferences", [])
            ],
            creation_timestamp=d.get("creationTimestamp", ""),
            deletion_timestamp=d.get("deletionTimestamp"),
        )


class ApiObject:
    """Base for all typed API objects.

    Subclasses declare ``KIND`` and dataclass fields ``spec`` / ``status``
    (each a dataclass implementing to_dict/from_dict). Deepcopy plays the role
    of the reference's generated zz_generated.deepcopy.go.
    """

    KIND: str = ""

    metadata: ObjectMeta

    def deepcopy(self):
        return copy.deepcopy(self)

    # -- serde ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        from tpu_composer_torch import API_VERSION

        return {
            "apiVersion": API_VERSION,
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),  # type: ignore[attr-defined]
            "status": self.status.to_dict(),  # type: ignore[attr-defined]
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        obj = cls()  # type: ignore[call-arg]
        obj.metadata = ObjectMeta.from_dict(d.get("metadata", {}))
        spec_cls = type(obj.spec)  # type: ignore[attr-defined]
        status_cls = type(obj.status)  # type: ignore[attr-defined]
        obj.spec = spec_cls.from_dict(d.get("spec", {}))  # type: ignore[attr-defined]
        obj.status = status_cls.from_dict(d.get("status", {}))  # type: ignore[attr-defined]
        return obj

    # -- convenience used throughout the controllers ----------------------
    @property
    def name(self) -> str:
        return self.metadata.name

    def has_finalizer(self, fin: str) -> bool:
        return fin in self.metadata.finalizers

    def add_finalizer(self, fin: str) -> bool:
        if fin not in self.metadata.finalizers:
            self.metadata.finalizers.append(fin)
            return True
        return False

    def remove_finalizer(self, fin: str) -> bool:
        if fin in self.metadata.finalizers:
            self.metadata.finalizers.remove(fin)
            return True
        return False

    @property
    def being_deleted(self) -> bool:
        return self.metadata.deletion_timestamp is not None

    def owned_by(self, owner: "ApiObject") -> bool:
        return any(
            (o.uid and o.uid == owner.metadata.uid)
            or (o.kind == owner.KIND and o.name == owner.name)
            for o in self.metadata.owner_references
        )

    def set_owner(self, owner: "ApiObject") -> None:
        if not self.owned_by(owner):
            self.metadata.owner_references.append(
                OwnerReference(kind=owner.KIND, name=owner.name, uid=owner.metadata.uid)
            )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self.KIND} {self.metadata.name} rv={self.metadata.resource_version}>"
