"""Event recorder — a bounded audit trail of controller decisions.

Reference analog: K8s Events (the reference relies on zap logs only; we keep
structured events queryable for tests, the CLI, and the syncer's audit)."""

from __future__ import annotations

import collections
import logging
import threading
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.runtime import lifecycle

NORMAL = "Normal"
WARNING = "Warning"


@dataclass
class Event:
    kind: str
    name: str
    type: str
    reason: str
    message: str
    timestamp: str = field(default_factory=now_iso)


class EventRecorder:
    def __init__(self, capacity: int = 4096) -> None:
        self._lock = threading.Lock()
        self._events: Deque[Event] = collections.deque(maxlen=capacity)
        self.log = logging.getLogger("events")

    def event(self, obj, type_: str, reason: str, message: str) -> None:
        ev = Event(kind=obj.KIND, name=obj.metadata.name, type=type_, reason=reason, message=message)
        with self._lock:
            self._events.append(ev)
        self.log.debug("%s %s/%s %s: %s", type_, ev.kind, ev.name, reason, message)
        # Mirror into the per-CR flight ledger: a crash dump should carry
        # the controller's own narration (Quarantined, Preempted, NodeGone)
        # next to the phase transitions it explains.
        lifecycle.recorder.note_event(ev.kind, ev.name, type_, reason, message)

    def for_object(self, obj=None, kind: Optional[str] = None, name: Optional[str] = None) -> List[Event]:
        if obj is not None:
            kind, name = obj.KIND, obj.metadata.name
        with self._lock:
            return [e for e in self._events if e.kind == kind and e.name == name]

    def all(self) -> List[Event]:
        with self._lock:
            return list(self._events)
