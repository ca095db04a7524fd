"""Fabric/pool provider abstraction (port of ``tpu_composer/fabric/``).

Reference analog: internal/cdi — the ``CdiProvider`` interface
(internal/cdi/client.go:34-39) with its wait sentinels (client.go:41-44) and
four HTTPS backends. Ours reserves TPU chips from a disaggregated pool and
programs ICI links into slice topologies instead of attaching PCIe GPUs.
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
from tpu_composer_torch.fabric.events import FabricEvent, FabricSession
from tpu_composer_torch.fabric.breaker import (
    BreakerConfig,
    BreakerFabricProvider,
    BreakerOpenError,
    CircuitBreaker,
)
from tpu_composer_torch.fabric.chaos import ChaosFabricProvider
from tpu_composer_torch.fabric.dispatcher import FabricDispatcher
from tpu_composer_torch.fabric.inmem import InMemoryPool
from tpu_composer_torch.fabric.adapter import new_fabric_provider

__all__ = [
    "AttachResult",
    "FabricDispatcher",
    "BreakerConfig",
    "BreakerFabricProvider",
    "BreakerOpenError",
    "ChaosFabricProvider",
    "CircuitBreaker",
    "DeviceHealth",
    "FabricDevice",
    "FabricError",
    "FabricEvent",
    "FabricProvider",
    "FabricSession",
    "TransientFabricError",
    "UnsupportedEvents",
    "WaitingDeviceAttaching",
    "WaitingDeviceDetaching",
    "InMemoryPool",
    "new_fabric_provider",
]
