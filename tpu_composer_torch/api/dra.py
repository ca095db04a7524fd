"""DRA-facing API objects: ResourceSlice publication + DeviceTaintRule.

Reference analog (the DRA path of the reference operator):

- attached devices become visible to the scheduler through ``ResourceSlice``
  objects the DRA kubelet plugin publishes; the operator confirms
  attachment by scanning slices for the device uuid
  (internal/utils/gpus.go:207-239);
- during detach the device is quarantined cluster-wide with a
  ``DeviceTaintRule`` (NoSchedule on the device uuid) before draining
  (gpus.go:894-975), deleted again once the device is gone (:959-975).

Taints kept as node-agent-local JSON would be invisible to any
scheduler. These objects make both publication and quarantine
first-class cluster state: the node agent's publisher maintains one
ResourceSlice per node (pool = node name, one entry per composed chip with
uuid/model/slice attributes), and the resource controller creates/deletes
DeviceTaintRules around the drain sequence.

Wire shapes follow resource.k8s.io/v1beta1 closely enough that KubeStore can
route them to a real apiserver group.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch.api.meta import ApiObject, ObjectMeta


@dataclass
class SliceDevice:
    """One schedulable device inside a ResourceSlice."""

    name: str = ""  # scheduler-visible device name, e.g. "chip-0"
    uuid: str = ""  # fabric device id (the reference scans for this, gpus.go:215-223)
    model: str = ""
    slice_name: str = ""  # owning tpu slice (ICI group)
    cdi_device_id: str = ""
    dev_path: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "basic": {
                "attributes": {
                    "uuid": {"string": self.uuid},
                    "model": {"string": self.model},
                    "slice": {"string": self.slice_name},
                    "cdiDeviceID": {"string": self.cdi_device_id},
                    "devPath": {"string": self.dev_path},
                }
            },
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SliceDevice":
        attrs = (d.get("basic") or {}).get("attributes") or {}

        def s(key: str) -> str:
            return (attrs.get(key) or {}).get("string", "")

        return cls(
            name=d.get("name", ""),
            uuid=s("uuid"),
            model=s("model"),
            slice_name=s("slice"),
            cdi_device_id=s("cdiDeviceID"),
            dev_path=s("devPath"),
        )


@dataclass
class ResourceSliceSpec:
    driver: str = "tpu.composer.dev"
    node_name: str = ""
    pool: str = ""
    devices: List[SliceDevice] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "driver": self.driver,
            "nodeName": self.node_name,
            "pool": {"name": self.pool or self.node_name,
                     "resourceSliceCount": 1},
            "devices": [d.to_dict() for d in self.devices],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceSliceSpec":
        return cls(
            driver=d.get("driver", "tpu.composer.dev"),
            node_name=d.get("nodeName", ""),
            pool=(d.get("pool") or {}).get("name", ""),
            devices=[SliceDevice.from_dict(x) for x in d.get("devices", [])],
        )

    def uuids_for_group(self, group: str) -> List[str]:
        """Chip uuids this slice publishes for one composed group
        (``SliceDevice.slice_name``). The publisher's group-scoped
        mutate/repair paths key on this — one membership definition, so
        publication and drift-repair can't disagree on what 'the group's
        devices' means."""
        return [d.uuid for d in self.devices if d.slice_name == group]

    def validate(self) -> None:
        pass


@dataclass
class ResourceSliceStatus:
    def to_dict(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceSliceStatus":
        return cls()


class ResourceSlice(ApiObject):
    KIND = "ResourceSlice"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[ResourceSliceSpec] = None,
        status: Optional[ResourceSliceStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or ResourceSliceSpec()
        self.status = status or ResourceSliceStatus()

    def validate(self) -> None:
        pass


@dataclass
class DeviceTaintRuleSpec:
    """NoSchedule quarantine on one device (by uuid) or a whole node."""

    device_uuid: str = ""
    node_name: str = ""
    effect: str = "NoSchedule"
    reason: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "deviceSelector": {
                "device": self.device_uuid,
                "pool": self.node_name,
                "driver": "tpu.composer.dev",
            },
            "taint": {"effect": self.effect,
                      "key": "tpu.composer.dev/quarantine",
                      "value": self.reason},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeviceTaintRuleSpec":
        sel = d.get("deviceSelector") or {}
        taint = d.get("taint") or {}
        return cls(
            device_uuid=sel.get("device", ""),
            node_name=sel.get("pool", ""),
            effect=taint.get("effect", "NoSchedule"),
            reason=taint.get("value", ""),
        )

    def validate(self) -> None:
        pass


@dataclass
class DeviceTaintRuleStatus:
    def to_dict(self) -> Dict[str, Any]:
        return {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeviceTaintRuleStatus":
        return cls()


class DeviceTaintRule(ApiObject):
    KIND = "DeviceTaintRule"

    def __init__(
        self,
        metadata: Optional[ObjectMeta] = None,
        spec: Optional[DeviceTaintRuleSpec] = None,
        status: Optional[DeviceTaintRuleStatus] = None,
    ):
        self.metadata = metadata or ObjectMeta()
        self.spec = spec or DeviceTaintRuleSpec()
        self.status = status or DeviceTaintRuleStatus()

    def validate(self) -> None:
        pass


def taint_rule_name(device_uuid: str) -> str:
    """Deterministic rule name per device (reference: one rule per uuid,
    gpus.go:894-957)."""
    return "quarantine-" + device_uuid.replace("/", "-").replace(":", "-").lower()
