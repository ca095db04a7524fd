"""Kind registry + serde entry point (port of ``tpu_composer/api/scheme.py``).

Registers the kinds the port has: ComposabilityRequest,
ComposableResource, Node, NodeMaintenance, ResourceSlice and
DeviceTaintRule (Lease and FleetTelemetry join with the HA sub-slice).

Reference analog: api/v1alpha1/groupversion_info.go:25-36 (SchemeBuilder /
AddToScheme) — maps kind strings to Go types so clients can decode. Ours maps
kind strings to Python classes for the store's persistence and any wire
encoding.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Type

from tpu_composer_torch.api.dra import DeviceTaintRule, ResourceSlice
from tpu_composer_torch.api.maintenance import NodeMaintenance
from tpu_composer_torch.api.meta import ApiObject
from tpu_composer_torch.api.types import ComposabilityRequest, ComposableResource, Node


class SchemeError(KeyError):
    pass


class Scheme:
    def __init__(self) -> None:
        self._kinds: Dict[str, Type[ApiObject]] = {}

    def register(self, cls: Type[ApiObject]) -> None:
        if not cls.KIND:
            raise SchemeError("cannot register a class without KIND")
        self._kinds[cls.KIND] = cls

    def lookup(self, kind: str) -> Type[ApiObject]:
        try:
            return self._kinds[kind]
        except KeyError:
            raise SchemeError(f"kind {kind!r} not registered") from None

    def kinds(self):
        return sorted(self._kinds)

    def decode(self, d: Dict[str, Any]) -> ApiObject:
        kind = d.get("kind", "")
        return self.lookup(kind).from_dict(d)

    def decode_json(self, raw: str) -> ApiObject:
        return self.decode(json.loads(raw))

    @staticmethod
    def encode(obj: ApiObject) -> Dict[str, Any]:
        return obj.to_dict()

    @staticmethod
    def encode_json(obj: ApiObject) -> str:
        return json.dumps(obj.to_dict(), sort_keys=True)


def default_scheme() -> Scheme:
    s = Scheme()
    s.register(ComposabilityRequest)
    s.register(ComposableResource)
    s.register(Node)
    s.register(NodeMaintenance)
    s.register(ResourceSlice)
    s.register(DeviceTaintRule)
    return s
