"""Capacity observatory — the supply curve the scheduler's decisions are
judged against.
(Port of ``tpu_composer/runtime/capacity.py``.)

The decision ledger explains each placement against the capacity it saw at
that instant; this module keeps the *timeline*: a Manager runnable samples
the cluster's free-capacity shape on a fixed cadence into a bounded ring
and level-sets the ``tpuc_capacity_*`` gauges, so "could my 2x4 gang have
placed an hour ago" and "is fragmentation eating our headroom" read off a
curve instead of a point (the evaluation discipline of the 32-GPU
composable-system study, arXiv:2404.06467).

Each sample records:

- ``free_chips``: free TPU ports across schedulable (ready, uncordoned,
  unquarantined) hosts;
- ``largest_slice_chips``: the largest hosts × chips-per-host rectangle
  composable right now — max over c of ``c * |{hosts: free >= c}|`` — the
  headroom number a pending gang compares its demand against;
- ``hosts_by_free``: the free-chip distribution (hosts per exact free-port
  count), whose shape distinguishes fragmentation (many hosts with a
  little free) from exhaustion (nothing free anywhere);
- the fragmentation score and, when a goodput tracker is wired, the
  current goodput ratio — capacity supplied next to capacity usefully
  consumed.

``/debug/scheduler/capacity`` serves the ring; the same tick refreshes the
goodput gauge so in-progress serving time stays current between lifecycle
transitions. Constructed only with the decision observatory
(``--decisions`` / TPUC_DECISIONS; ``TPUC_CAPACITY_SAMPLE_PERIOD`` sets
the cadence).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.api.types import Node
from tpu_composer_torch.runtime.metrics import (
    capacity_free_chips,
    capacity_hosts_by_free,
    capacity_largest_slice_chips,
    scheduler_fragmentation_score,
)


def largest_placeable_slice(free_by_host: Dict[str, int]) -> int:
    """Largest hosts × chips-per-host rectangle composable from the free
    map: ``max over c of c * |{hosts with free >= c}|``. 0 when nothing is
    free. Pure — the capacity sampler's core arithmetic, unit-testable
    without a store."""
    frees = sorted((f for f in free_by_host.values() if f > 0), reverse=True)
    best = 0
    for i, free in enumerate(frees):
        # `free` as chips-per-host: every host ranked 0..i fits it.
        best = max(best, free * (i + 1))
    return best


class CapacityObservatory:
    """Sampler + bounded timeline ring (a Manager runnable)."""

    def __init__(
        self,
        store,
        engine,  # scheduler.PlacementEngine (capacity maps + frag score)
        goodput=None,  # runtime.goodput.GoodputTracker, optional
        period: float = 5.0,
        ring: int = 720,  # one hour at the 5s default
    ) -> None:
        self.store = store
        self.engine = engine
        self.goodput = goodput
        self.period = max(0.1, period)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._exported_free: set = set()

    # ------------------------------------------------------------------
    def sample(self) -> Dict[str, Any]:
        """One capacity sample: read the cluster, set the gauges, append
        to the ring."""
        from tpu_composer_torch.agent.publisher import quarantined_nodes

        quarantined = quarantined_nodes(self.store)
        used = self.engine.used_slots_map()
        free_by_host: Dict[str, int] = {}
        total_chips = 0
        for n in self.store.list(Node):
            if (
                not n.status.ready
                or n.spec.unschedulable
                or n.metadata.name in quarantined
            ):
                continue
            total_chips += n.status.tpu_slots
            free_by_host[n.metadata.name] = max(
                0, n.status.tpu_slots - used.get(n.metadata.name, 0)
            )
        free = sum(free_by_host.values())
        largest = largest_placeable_slice(free_by_host)
        frag = self.engine.fragmentation(quarantined, used)
        hosts_by_free: Dict[str, int] = {}
        for f in free_by_host.values():
            hosts_by_free[str(f)] = hosts_by_free.get(str(f), 0) + 1

        capacity_free_chips.set(float(free))
        capacity_largest_slice_chips.set(float(largest))
        scheduler_fragmentation_score.set(frag)
        with self._lock:
            # Level-set the distribution: stale free-count label sets are
            # removed, not frozen at their last value.
            for label in self._exported_free - set(hosts_by_free):
                capacity_hosts_by_free.remove(free=label)
            self._exported_free = set(hosts_by_free)
        for label, count in hosts_by_free.items():
            capacity_hosts_by_free.set(float(count), free=label)

        sample: Dict[str, Any] = {
            "at": now_iso(),
            "mono": time.monotonic(),
            "schedulable_hosts": len(free_by_host),
            "total_chips": total_chips,
            "free_chips": free,
            "largest_slice_chips": largest,
            "fragmentation": round(frag, 4),
            "hosts_by_free": hosts_by_free,
        }
        if self.goodput is not None:
            self.goodput.set_gauges()
            r = self.goodput.ratio()
            if r is not None:
                sample["goodput_ratio"] = round(r, 6)
        with self._lock:
            self._ring.append(sample)
        return sample

    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable (first sample immediately — a young operator's
        /debug/scheduler/capacity must not 404 for a whole period)."""
        while True:
            try:
                self.sample()
            except Exception:
                # Store blips must not kill the sampler; next tick retries.
                logging.getLogger("capacity").exception(
                    "capacity sample failed"
                )
            if stop_event.wait(self.period):
                return

    # ------------------------------------------------------------------
    def timeline(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            samples = list(self._ring)
        if limit is not None and limit > 0:
            samples = samples[-limit:]
        return samples

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/scheduler/capacity payload: latest sample + the
        ring (newest last)."""
        samples = self.timeline()
        return {
            "period_s": self.period,
            "samples": len(samples),
            "latest": samples[-1] if samples else None,
            "timeline": samples,
        }
