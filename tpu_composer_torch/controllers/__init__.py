"""Orchestration controllers (port of ``tpu_composer/controllers/``): the
ComposableResource reconciler, per chip-group attach/online/detach. The
request controller, the syncer, adoption and maintenance arrive with the
request side."""

from tpu_composer_torch.controllers.resource_controller import (
    ComposableResourceReconciler,
    ResourceTiming,
)

__all__ = [
    "ComposableResourceReconciler",
    "ResourceTiming",
]
