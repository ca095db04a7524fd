"""Fabric/pool provider abstraction (port of ``tpu_composer/fabric/``):
the provider interface, its events, the in-memory pool and the factory.

Reference analog: internal/cdi — the ``CdiProvider`` interface
(internal/cdi/client.go:34-39) with its wait sentinels (client.go:41-44).
The remote backends, the dispatcher, the circuit breaker, chaos injection
and the persistent event session arrive with the fabric I/O sub-slice.
"""

from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    FabricDevice,
    FabricError,
    FabricProvider,
    TransientFabricError,
    UnsupportedEvents,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
)
from tpu_composer_torch.fabric.events import FabricEvent
from tpu_composer_torch.fabric.inmem import InMemoryPool
from tpu_composer_torch.fabric.adapter import new_fabric_provider

__all__ = [
    "AttachResult",
    "DeviceHealth",
    "FabricDevice",
    "FabricError",
    "FabricEvent",
    "FabricProvider",
    "TransientFabricError",
    "UnsupportedEvents",
    "WaitingDeviceAttaching",
    "WaitingDeviceDetaching",
    "InMemoryPool",
    "new_fabric_provider",
]
