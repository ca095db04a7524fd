"""Pending-request priority queue + conservative backfill gate.
(Port of ``tpu_composer/scheduler/queue.py``.)

Requests that cannot place right now register here (the scheduler facade
does it on every failed placement). The queue is the cross-request memory
the inline allocator never had: with it, a placement decision can consult
*who else is waiting* instead of handing capacity to whoever reconciles
first.

Admission discipline:

- **Gang admission** is structural — a multi-host slice's hosts are picked
  and reserved in one atomic decision (``PlacementEngine.pick_hosts`` +
  ``reserve_slice``), so a 2-host slice can never hold one host while
  waiting for the other and deadlock against a peer doing the same. The
  queue adds the cross-request half: whole-gang demands are recorded here
  so peers can see them.
- **Conservative backfill**: a lower-priority request may place only if the
  placement leaves every *currently-placeable* higher-priority pending
  request still placeable. A higher-priority request that cannot place
  either way (e.g. its only candidate hosts are quarantined) does NOT block
  the queue — that is exactly the priority-inversion case: holding everyone
  behind an unsatisfiable head-of-line demand would starve the cluster for
  nothing.

State is in-memory and rebuilt organically: every unplaced request
re-registers on each reconcile attempt, so a controller restart repopulates
the queue within one reconcile wave (the store's initial-list replay).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from tpu_composer_torch.api.types import (
    ComposabilityRequest,
    REQUEST_STATE_EMPTY,
    REQUEST_STATE_NODE_ALLOCATING,
)


@dataclass
class PendingEntry:
    name: str
    priority: int
    num_hosts: int
    chips_per_host: int
    enqueued_at: float  # monotonic; survives re-registration
    # Host the demand is pinned to beyond the spec (a samenode request
    # with placed devices can only grow on its anchor) — "" = unpinned.
    anchor: str = ""
    # Hosts the demand can NOT use (a differentnode request's devices
    # exclude their own hosts from its growth) — feasibility probes that
    # counted them would overreport and drop the gate's protection.
    exclude_nodes: tuple = ()


class SchedulerQueue:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, PendingEntry] = {}

    def note_pending(
        self,
        req: ComposabilityRequest,
        num_hosts: int,
        chips_per_host: int,
        anchor: str = "",
        exclude_nodes: tuple = (),
    ) -> PendingEntry:
        """Record (or refresh) a request that failed to place, with its
        demand as (hosts × chips-per-host) — a slice shape, or a scalar
        request's device spread — plus the anchor host a samenode grow is
        pinned to. The original enqueue time is kept across
        re-registrations so time-to-placement measures the full wait, but
        priority/demand track the live spec."""
        with self._lock:
            prev = self._entries.get(req.name)
            entry = PendingEntry(
                name=req.name,
                priority=req.spec.priority,
                num_hosts=num_hosts,
                chips_per_host=chips_per_host,
                enqueued_at=prev.enqueued_at if prev else time.monotonic(),
                anchor=anchor,
                exclude_nodes=tuple(exclude_nodes),
            )
            self._entries[req.name] = entry
            return entry

    def note_placed(self, name: str) -> Optional[float]:
        """Dequeue after a successful placement; returns the seconds the
        request waited, or None if it was never pending (first-try place)."""
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is None:
            return None
        return max(0.0, time.monotonic() - entry.enqueued_at)

    def forget(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    def prune(self, store) -> None:
        """Drop entries whose request is gone, deleting, or no longer
        waiting for placement (it progressed past NodeAllocating)."""
        with self._lock:
            names = list(self._entries)
        for name in names:
            req = store.try_get(ComposabilityRequest, name)
            if (
                req is None
                or req.being_deleted
                or req.status.state
                not in (REQUEST_STATE_EMPTY, REQUEST_STATE_NODE_ALLOCATING)
            ):
                self.forget(name)

    def entries_above(self, priority: int) -> List[PendingEntry]:
        """Pending entries with strictly higher priority, highest first."""
        with self._lock:
            entries = [
                e for e in self._entries.values() if e.priority > priority
            ]
        entries.sort(key=lambda e: (-e.priority, e.enqueued_at, e.name))
        return entries

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> List[PendingEntry]:
        with self._lock:
            entries = list(self._entries.values())
        entries.sort(key=lambda e: (-e.priority, e.enqueued_at, e.name))
        return entries
