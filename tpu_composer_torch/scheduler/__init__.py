"""Cluster scheduler: priority, gang admission, preemption, defrag.
(Port of ``tpu_composer/scheduler/__init__.py``.)

The placement subsystem the request controller delegates to instead of
picking nodes inline — see scheduler/core.py for the facade and
docs/ARCHITECTURE.md (Scheduler section) for the data flow.
"""

from tpu_composer_torch.scheduler.core import ClusterScheduler, Placement
from tpu_composer_torch.scheduler.defrag import (
    DefragLoop,
    DefragPlan,
    DefragPlanner,
    Migration,
)
from tpu_composer_torch.scheduler.ledger import DecisionLedger, DecisionRecord
from tpu_composer_torch.scheduler.placement import (
    AllocationError,
    PlacementEngine,
    host_index,
)
from tpu_composer_torch.scheduler.preemption import Preemptor
from tpu_composer_torch.scheduler.queue import PendingEntry, SchedulerQueue

__all__ = [
    "AllocationError",
    "ClusterScheduler",
    "DecisionLedger",
    "DecisionRecord",
    "DefragLoop",
    "DefragPlan",
    "DefragPlanner",
    "Migration",
    "PendingEntry",
    "Placement",
    "PlacementEngine",
    "Preemptor",
    "SchedulerQueue",
    "host_index",
]
