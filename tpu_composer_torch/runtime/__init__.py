"""Controller runtime (port of ``tpu_composer/runtime/``): object store,
work queues, controllers, manager, metrics, tracing and the lifecycle
recorder.

Reference analog: sigs.k8s.io/controller-runtime as consumed by the
reference operator's cmd/main.go and internal/controller/*. The runtime is
an in-process equivalent with the same semantics (optimistic concurrency,
status subresource, finalizer-gated deletion, watches, rate-limited
requeue), so the operator runs standalone and tests drive single reconcile
steps. Its globals (the metrics registry, the trace ring, the lifecycle
recorder and its crash hooks) are this package's own, apart from the JAX
package's.
"""

from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    AlreadyExistsError,
    Store,
    WatchEvent,
)
from tpu_composer_torch.runtime.queue import RateLimitingQueue
from tpu_composer_torch.runtime.controller import Controller, Result
from tpu_composer_torch.runtime.manager import Manager

__all__ = [
    "ConflictError",
    "NotFoundError",
    "AlreadyExistsError",
    "Store",
    "WatchEvent",
    "RateLimitingQueue",
    "Controller",
    "Result",
    "Manager",
]
