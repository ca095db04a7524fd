"""Per-request goodput accounting on the lifecycle tracker.
(Port of ``tpu_composer/runtime/goodput.py``.)

The lifecycle timelines already observe every state transition a
ComposabilityRequest and its members make — but they answer "how long did
each phase take", not "what fraction of this request's life was actually
SERVING". That ratio is goodput, the quantity the 32-GPU composable-system
study (arXiv:2404.06467) publishes as curves and multi-tenant accounting
(Funky, arXiv:2510.15755) builds quota fairness on.

The :class:`GoodputTracker` subscribes to the lifecycle watch feed
(:func:`tpu_composer_torch.runtime.lifecycle.add_transition_sink`) and keeps one
clock per request, split into categories:

- ``ready`` — the request is Running and every attached member is healthy
  (the only serving category; the goodput numerator);
- ``queued`` — waiting for placement (Pending / NodeAllocating);
- ``provisioning`` — placed, attaching (Updating);
- ``degraded`` / ``repairing`` / ``migrating`` — the request is nominally
  Running but a member is impaired, so the workload is (at best) degraded:
  the member's state transitions flip the request's clock between these
  categories and back to ``ready`` on recovery.

Terminating/deleted time is excluded from the denominator — teardown is
not lost goodput. Ratios:

- per request: ``ready / (ready + queued + provisioning + degraded +
  repairing + migrating)``, served in /debug/goodput and the capacity
  observatory's timeline;
- process-wide: the same ratio over every tracked request's summed clocks,
  level-set into ``tpuc_goodput_ratio`` and settled (on transitions) into
  ``tpuc_goodput_seconds_total{category}``;
- fleet-wide: each replica publishes its (total, lost) second counters in
  its FleetTelemetry snapshot; the aggregator sums per process and sets
  ``tpuc_fleet_goodput_ratio``.

:meth:`counts` exposes cumulative (total, lost) seconds INCLUDING the
in-progress accrual — monotonic, which is exactly the shape the SLO
engine diffs over its burn windows: its ``goodput`` objective treats
lost seconds as bad events against a ``1 - target`` budget
(``runtime/slo.GoodputObjective``), and the fleet plane publishes them
(``runtime/fleet.py``).

Constructed only when the decision observatory is on (the caller's
``--decisions`` / TPUC_DECISIONS); tests drive :meth:`observe` directly
with injected clocks for deterministic phase arithmetic.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_composer_torch.runtime.metrics import goodput_ratio, goodput_seconds_total

#: Accounting categories (the goodput clock's vocabulary). ``ready`` is
#: the sole serving category; everything else but the excluded terminal
#: states counts as lost.
CATEGORIES = (
    "ready", "queued", "provisioning", "degraded", "repairing", "migrating",
)

#: Request states -> category while no member is impaired.
_REQUEST_CATEGORY = {
    "": "queued",
    "NodeAllocating": "queued",
    "Updating": "provisioning",
    "Running": "ready",
}

#: Member (ComposableResource) states that impair their owner, by
#: precedence (worst first — one repairing member outranks two degraded).
_IMPAIRED_PRECEDENCE = ("Repairing", "Migrating", "Degraded")

_TERMINAL = ("Cleaning", "Deleting", "(deleted)")


class _ReqClock:
    __slots__ = ("category", "since", "acc", "state", "impaired")

    def __init__(self, category: str, now: float) -> None:
        self.category = category  # None once terminal
        self.since = now
        self.acc = {c: 0.0 for c in CATEGORIES}
        self.state = ""
        # member name -> impairing state (Degraded/Repairing/Migrating)
        self.impaired: Dict[str, str] = {}


class GoodputTracker:
    """One clock per live request, fed by lifecycle transitions."""

    def __init__(self, now: Callable[[], float] = time.monotonic) -> None:
        self._now = now
        self._lock = threading.Lock()
        self._reqs: Dict[str, _ReqClock] = {}
        # Settled seconds of requests that finished (deleted) — cumulative
        # process totals must not shrink when a request leaves the map.
        self._retired = {c: 0.0 for c in CATEGORIES}

    # ------------------------------------------------------------------
    # feed
    # ------------------------------------------------------------------
    def observe(
        self, kind: str, name: str, state: str, owner: str = "",
        now: Optional[float] = None,
    ) -> None:
        """One observed state transition (the lifecycle sink signature).
        Requests re-categorize on their own state; member transitions flip
        the owner's impaired set."""
        now = self._now() if now is None else now
        with self._lock:
            if kind == "ComposabilityRequest":
                self._observe_request(name, state, now)
            elif owner:
                self._observe_member(owner, name, state, now)
        # NB: the ratio gauge is NOT refreshed here — recomputing the
        # all-request totals on every watch transition would be O(fleet)
        # work per event on the lifecycle hot path. The capacity
        # observatory's sample tick calls set_gauges() on its cadence.

    def _observe_request(self, name: str, state: str, now: float) -> None:
        clock = self._reqs.get(name)
        if state in _TERMINAL:
            if clock is not None:
                self._settle(clock, now)
                clock.category = None  # type: ignore[assignment]
                clock.state = state
                if state == "(deleted)":
                    for c in CATEGORIES:
                        self._retired[c] += clock.acc[c]
                    del self._reqs[name]
            return
        if clock is None:
            clock = _ReqClock(_REQUEST_CATEGORY.get(state, "queued"), now)
            self._reqs[name] = clock
        clock.state = state
        self._recategorize(clock, now)

    def _observe_member(
        self, owner: str, member: str, state: str, now: float
    ) -> None:
        clock = self._reqs.get(owner)
        if clock is None:
            return  # member event before the owner was ever seen
        if state in _IMPAIRED_PRECEDENCE:
            clock.impaired[member] = state
        else:
            clock.impaired.pop(member, None)
        self._recategorize(clock, now)

    def _recategorize(self, clock: _ReqClock, now: float) -> None:
        if clock.category is None:
            return  # terminal — teardown member flaps don't resurrect it
        cat = _REQUEST_CATEGORY.get(clock.state, "queued")
        if cat == "ready" and clock.impaired:
            worst = min(
                clock.impaired.values(),
                key=_IMPAIRED_PRECEDENCE.index,
            )
            cat = worst.lower()
        if cat != clock.category:
            self._settle(clock, now)
            clock.category = cat

    def _settle(self, clock: _ReqClock, now: float) -> None:
        """Bank the in-progress interval into the clock's accumulator and
        the settled counter series."""
        if clock.category is None:
            return
        dt = max(0.0, now - clock.since)
        clock.since = now
        if dt > 0:
            clock.acc[clock.category] += dt
            goodput_seconds_total.inc(dt, category=clock.category)

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def _totals_locked(self, now: float) -> Dict[str, float]:
        totals = dict(self._retired)
        for clock in self._reqs.values():
            for c in CATEGORIES:
                totals[c] += clock.acc[c]
            if clock.category is not None:
                totals[clock.category] += max(0.0, now - clock.since)
        return totals

    def counts(self, now: Optional[float] = None) -> Tuple[float, float]:
        """Cumulative (total_wall_s, lost_s) including in-progress accrual
        — monotonic, the SLO engine's diffable shape."""
        now = self._now() if now is None else now
        with self._lock:
            totals = self._totals_locked(now)
        total = sum(totals.values())
        return total, total - totals["ready"]

    def ratio(self, now: Optional[float] = None) -> Optional[float]:
        """Process-wide goodput ratio, or None before any traffic."""
        total, lost = self.counts(now)
        if total <= 0:
            return None
        return (total - lost) / total

    def request_view(
        self, name: str, now: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        now = self._now() if now is None else now
        with self._lock:
            clock = self._reqs.get(name)
            if clock is None:
                return None
            acc = dict(clock.acc)
            if clock.category is not None:
                acc[clock.category] += max(0.0, now - clock.since)
            state, category = clock.state, clock.category
            impaired = dict(clock.impaired)
        total = sum(acc.values())
        return {
            "state": state,
            "category": category,
            "impaired_members": impaired,
            "seconds": {c: round(v, 6) for c, v in acc.items() if v > 0},
            "goodput_ratio": (
                round(acc["ready"] / total, 6) if total > 0 else None
            ),
        }

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /debug/goodput payload: fleet-local totals + per-request
        ratios for every live request."""
        now = self._now() if now is None else now
        with self._lock:
            names = list(self._reqs)
            totals = self._totals_locked(now)
        total = sum(totals.values())
        return {
            "ratio": round((totals["ready"] / total), 6) if total > 0 else None,
            "seconds": {c: round(v, 6) for c, v in totals.items()},
            "requests": {
                name: view for name in sorted(names)
                if (view := self.request_view(name, now)) is not None
            },
        }

    def set_gauges(self, now: Optional[float] = None) -> None:
        """Level-set ``tpuc_goodput_ratio`` (the capacity observatory also
        calls this each sample tick so in-progress serving time keeps the
        gauge fresh between transitions)."""
        r = self.ratio(now)
        if r is not None:
            goodput_ratio.set(round(r, 6))

    def names(self) -> List[str]:
        with self._lock:
            return list(self._reqs)

    def reset(self) -> None:
        with self._lock:
            self._reqs.clear()
            self._retired = {c: 0.0 for c in CATEGORIES}
