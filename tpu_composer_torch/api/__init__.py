"""API object model (port of ``tpu_composer/api/``): typed objects,
metadata, the scheme registry and validation.

The kinds the port has are ComposabilityRequest, ComposableResource, Node,
NodeMaintenance, the DRA pair ResourceSlice and DeviceTaintRule, and the
coordination Lease (``api/lease.py``) and the fleet plane's
FleetTelemetry (``api/fleet.py``)."""

from tpu_composer_torch.api.meta import ObjectMeta, OwnerReference, now_iso
from tpu_composer_torch.api.scheme import Scheme, default_scheme
from tpu_composer_torch.api.types import (
    ComposabilityRequest,
    ComposabilityRequestSpec,
    ComposabilityRequestStatus,
    ComposableResource,
    ComposableResourceSpec,
    ComposableResourceStatus,
    Node,
    NodeSpec,
    NodeStatus,
    ResourceDetails,
    ResourceStatus,
    OtherSpec,
    SliceStatus,
)

__all__ = [
    "ObjectMeta",
    "OwnerReference",
    "now_iso",
    "Scheme",
    "default_scheme",
    "ComposabilityRequest",
    "ComposabilityRequestSpec",
    "ComposabilityRequestStatus",
    "ComposableResource",
    "ComposableResourceSpec",
    "ComposableResourceStatus",
    "Node",
    "NodeSpec",
    "NodeStatus",
    "ResourceDetails",
    "ResourceStatus",
    "OtherSpec",
    "SliceStatus",
]
