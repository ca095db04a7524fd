"""Orchestration controllers (port of ``tpu_composer/controllers/``).

Reference analog: internal/controller — ComposabilityRequest reconciler
(request → slice → per-host children), ComposableResource reconciler
(per chip-group lifecycle), UpstreamSyncer (fabric↔local anti-drift),
and the NodeMaintenance drain; ``adoption.adopt_pending_ops`` is the
Manager's cold-start hook.
"""

from tpu_composer_torch.controllers.maintenance import (
    MaintenanceTiming,
    NodeMaintenanceReconciler,
)
from tpu_composer_torch.controllers.resource_controller import (
    ComposableResourceReconciler,
    ResourceTiming,
)
from tpu_composer_torch.controllers.request_controller import (
    ComposabilityRequestReconciler,
    MigrateConfig,
    RequestTiming,
)
from tpu_composer_torch.controllers.syncer import UpstreamSyncer

__all__ = [
    "ComposableResourceReconciler",
    "ResourceTiming",
    "ComposabilityRequestReconciler",
    "MigrateConfig",
    "RequestTiming",
    "MaintenanceTiming",
    "NodeMaintenanceReconciler",
    "UpstreamSyncer",
]
