"""SLO engine: declarative objectives over existing histograms, with
rolling multi-window burn-rate alerts (port of
``tpu_composer/runtime/slo.py``).

The metrics layer measures attach-to-ready latency, completion-
notification latency, queue wait and repair time-to-replace as passive
histograms. This module turns them into ENFORCED objectives, SRE-style:

- An :class:`Objective` is (histogram, threshold, target): "at least
  ``target`` of observations must land at or under ``threshold`` seconds"
  — e.g. attach-to-ready p99 <= 5s is ``target=0.99, threshold_s=5.0``.
  The error budget is ``1 - target``.
- The engine snapshots each histogram's cumulative (total, bad) counts on
  every evaluation tick (bad = observations over the threshold, taken
  from the bucket counts with in-bucket interpolation — no per-sample
  timestamps needed, the Prometheus recipe) and diffs them over two
  rolling windows: a FAST window (reactivity + recovery) and a SLOW
  window (blip filtering).
- Burn rate per window = (bad/total)/budget: 1.0 means consuming exactly
  the error budget. The alert FIRES when both windows exceed
  ``burn_threshold`` (the classic multi-window AND — a blip can spike the
  fast window alone; a real regression saturates both) and CLEARS when
  the fast window drops back under it (the slow window decays too slowly
  to gate recovery). Edges emit a controller Event (SloBreached /
  SloRecovered), level-set ``tpuc_slo_breached{slo}``, and both windows
  continuously export ``tpuc_slo_burn_rate{slo,window}``.
- ``/debug/slo`` (manager health port) serves the whole state as JSON;
  the crash hooks dump the same snapshot to $TPUC_SLO_FILE so soak
  failure artifacts carry it.

No traffic in a window means burn 0 for that window — an idle control
plane is not violating a latency objective. The Manager builds a default
engine unless given one (``slo_engine=``); ``TPUC_PROFILE=0`` disables
evaluation along with the rest of the observatory.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from tpu_composer_torch.runtime.metrics import (
    Histogram,
    slo_breached,
    slo_burn_rate,
)

log = logging.getLogger("slo")

#: The most recently started engine (crash-hook dump target), like the
#: profiler's active instance.
_active: Optional["SloEngine"] = None


@dataclass
class Objective:
    """One latency objective over an existing histogram (all label sets
    aggregated — an objective spans every type/verb/phase)."""

    name: str
    histogram: Histogram
    threshold_s: float
    target: float  # fraction of observations that must be <= threshold_s
    description: str = ""

    @property
    def budget(self) -> float:
        return max(1e-6, 1.0 - self.target)

    def counts(self) -> Tuple[float, float]:
        """(total, bad) cumulative observation counts right now."""
        total = float(self.histogram.total_count())
        good = self.histogram.total_count_le(self.threshold_s)
        return total, max(0.0, total - good)


class GoodputObjective(Objective):
    """A goodput objective over the :class:`~tpu_composer_torch.runtime.goodput.
    GoodputTracker`'s cumulative second counters instead of a histogram:
    total wall seconds are the event stream, lost (non-serving) seconds
    are the bad events, and ``target`` is the serving fraction promised
    (0.95 -> a 5% lost-time budget). Both counters are monotonic including
    in-progress accrual, so the burn-window diffing works unchanged —
    burn 1.0 means the fleet is losing wall time exactly at budget."""

    def __init__(
        self, tracker: Any, target: float = 0.95, name: str = "goodput"
    ) -> None:
        super().__init__(
            name=name,
            histogram=None,  # type: ignore[arg-type]
            threshold_s=0.0,  # not a latency objective
            target=target,
            description=(
                "goodput: Ready-serving share of accounted request wall"
                " time (queued/provisioning/degraded/repairing/migrating"
                " time is the lost share)"
            ),
        )
        self.tracker = tracker

    def counts(self) -> Tuple[float, float]:
        return self.tracker.counts()


class _SloRef:
    """Event-recorder shim: breaches are cluster-scoped, not per-CR."""

    KIND = "SLO"

    def __init__(self, name: str) -> None:
        self.metadata = SimpleNamespace(name=name)


@dataclass
class _State:
    # ring of (t, total, bad) snapshots, oldest first; pruned to one entry
    # past the slow window so every window always has a baseline anchor.
    snaps: Deque[Tuple[float, float, float]] = field(
        default_factory=collections.deque
    )
    breached: bool = False
    since: Optional[float] = None  # monotonic t of the last edge
    fast_burn: float = 0.0
    slow_burn: float = 0.0


class SloEngine:
    def __init__(
        self,
        objectives: Optional[List[Objective]] = None,
        # Duck-typed events recorder (runtime/events.py): only .event()
        # is used, for the SloBreached/SloRecovered edges.
        recorder: Optional[Any] = None,
        fast_window: float = 60.0,
        slow_window: float = 600.0,
        burn_threshold: float = 2.0,
        eval_period: float = 5.0,
    ) -> None:
        self.objectives = (
            objectives if objectives is not None else default_objectives()
        )
        self.recorder = recorder
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.burn_threshold = burn_threshold
        self.eval_period = eval_period
        self._lock = threading.Lock()
        self._state: Dict[str, _State] = {
            o.name: _State() for o in self.objectives
        }
        # Breach-Event annotators: objective name -> zero-arg callable
        # returning extra context for the alert message ("" = nothing).
        # The JAX command line wires the queue-wait objective to the
        # decision ledger's dominant hold-back reason, so the alert names its probable cause
        # instead of just its symptom.
        self.annotators: Dict[str, Callable[[], str]] = {}

    # ------------------------------------------------------------------
    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable: evaluate on a fixed cadence. The first pass
        runs immediately — it is the t=0 baseline snapshot; without it,
        observations landing inside the first eval period would be
        swallowed into the first snapshot's cumulative counts and never
        show up as a delta (a breach in the process's first seconds would
        be invisible)."""
        global _active
        _active = self
        while True:
            try:
                self.evaluate()
            except Exception:  # pragma: no cover - must never die
                log.exception("slo evaluation failed")
            if stop_event.wait(self.eval_period):
                return

    @staticmethod
    def _burn(
        snaps: Deque[Tuple[float, float, float]],
        now: float,
        window: float,
        budget: float,
    ) -> Tuple[float, float, float]:
        """Burn rate over [now-window, now]: diff the newest snapshot
        against the latest one at or before the window start (falling back
        to the oldest — a young process's window is its whole life)."""
        if not snaps:
            return 0.0, 0.0, 0.0
        t_now, total_now, bad_now = snaps[-1]
        base = snaps[0]
        for s in snaps:
            if s[0] <= now - window:
                base = s
            else:
                break
        d_total = total_now - base[1]
        d_bad = bad_now - base[2]
        if d_total <= 0:
            return 0.0, 0.0, 0.0
        # Clamp, don't trust, a shrinking bad count: a FLEET series can go
        # backwards when a dead replica's snapshot ages out of the merge
        # mid-window — a negative burn rate would read as "earning budget
        # back", which no objective ever does.
        d_bad = max(0.0, d_bad)
        return (d_bad / d_total) / budget, d_total, d_bad

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass; ``now`` is injectable for deterministic
        tests (monotonic seconds). Returns the /debug/slo snapshot."""
        now = time.monotonic() if now is None else now
        out: Dict[str, Any] = {
            "fast_window_s": self.fast_window,
            "slow_window_s": self.slow_window,
            "burn_threshold": self.burn_threshold,
            "objectives": {},
        }
        for obj in self.objectives:
            total, bad = obj.counts()
            with self._lock:
                st = self._state[obj.name]
                st.snaps.append((now, total, bad))
                horizon = now - self.slow_window
                while len(st.snaps) > 2 and st.snaps[1][0] <= horizon:
                    st.snaps.popleft()
                fast, f_total, f_bad = self._burn(
                    st.snaps, now, self.fast_window, obj.budget
                )
                slow, s_total, s_bad = self._burn(
                    st.snaps, now, self.slow_window, obj.budget
                )
                st.fast_burn, st.slow_burn = fast, slow
                was = st.breached
                if not was and (
                    fast >= self.burn_threshold and slow >= self.burn_threshold
                ):
                    st.breached = True
                    st.since = now
                elif was and fast < self.burn_threshold:
                    st.breached = False
                    st.since = now
                breached = st.breached
                edge = breached != was
                since = st.since
            slo_burn_rate.set(round(fast, 4), slo=obj.name, window="fast")
            slo_burn_rate.set(round(slow, 4), slo=obj.name, window="slow")
            slo_breached.set(1.0 if breached else 0.0, slo=obj.name)
            if edge:
                self._emit_edge(obj, breached, fast, slow)
            out["objectives"][obj.name] = {
                "description": obj.description,
                "threshold_s": obj.threshold_s,
                "target": obj.target,
                "budget": round(obj.budget, 6),
                "breached": breached,
                "since_s_ago": round(now - since, 3) if since is not None else None,
                "windows": {
                    "fast": {"burn_rate": round(fast, 4),
                             "events": f_total, "bad": f_bad},
                    "slow": {"burn_rate": round(slow, 4),
                             "events": s_total, "bad": s_bad},
                },
            }
        return out

    def _emit_edge(
        self, obj: Objective, breached: bool, fast: float, slow: float
    ) -> None:
        if breached:
            # Latency objectives render the percentile promise; ratio
            # objectives (threshold_s <= 0, e.g. goodput) render the
            # fraction promise — "(p95 <= 0s)" would read as nonsense.
            promise = (
                f"(p{obj.target * 100:g} <= {obj.threshold_s:g}s)"
                if obj.threshold_s > 0
                else f"(>= {obj.target * 100:g}% good)"
            )
            msg = (
                f"{obj.name}: error budget burning at {fast:.1f}x (fast)"
                f" / {slow:.1f}x (slow) — {obj.description or 'objective'}"
                f" {promise} violated"
            )
            annotate = self.annotators.get(obj.name)
            if annotate is not None:
                try:
                    extra = annotate()
                except Exception:  # pragma: no cover - defensive
                    extra = ""
                if extra:
                    msg += f"; probable cause: {extra}"
            log.warning("SLO BREACH %s", msg)
        else:
            msg = (
                f"{obj.name}: fast-window burn back under"
                f" {self.burn_threshold:g}x — alert cleared"
            )
            log.info("SLO recovered: %s", msg)
        if self.recorder is not None:
            try:
                self.recorder.event(
                    _SloRef(obj.name),
                    "Warning" if breached else "Normal",
                    "SloBreached" if breached else "SloRecovered",
                    msg,
                )
            except Exception:  # pragma: no cover
                log.exception("slo event emission failed")

    # ------------------------------------------------------------------
    def breached(self, name: str) -> bool:
        with self._lock:
            st = self._state.get(name)
            return bool(st and st.breached)

    def burn_rates(self, name: str) -> Tuple[float, float]:
        with self._lock:
            st = self._state.get(name)
            return (st.fast_burn, st.slow_burn) if st else (0.0, 0.0)

    def snapshot(self) -> Dict[str, Any]:
        """Current state WITHOUT advancing the rings (read-only: what
        /debug/slo serves between evaluation ticks)."""
        now = time.monotonic()
        out: Dict[str, Any] = {
            "fast_window_s": self.fast_window,
            "slow_window_s": self.slow_window,
            "burn_threshold": self.burn_threshold,
            "eval_period_s": self.eval_period,
            "objectives": {},
        }
        for obj in self.objectives:
            with self._lock:
                st = self._state[obj.name]
                out["objectives"][obj.name] = {
                    "description": obj.description,
                    "threshold_s": obj.threshold_s,
                    "target": obj.target,
                    "breached": st.breached,
                    "since_s_ago": (
                        round(now - st.since, 3) if st.since is not None else None
                    ),
                    "fast_burn": round(st.fast_burn, 4),
                    "slow_burn": round(st.slow_burn, 4),
                }
        return out


def default_objectives(
    attach_p99_s: float = 5.0,
    completion_p50_s: float = 1.0,
    queue_p99_s: float = 1.0,
    repair_p99_s: float = 120.0,
) -> List[Objective]:
    """The stock objectives over the histograms the repo already emits.
    A threshold <= 0 drops that objective (the per-objective off
    switch). Defaults sit on bucket boundaries of
    their histograms: ``total_count_le`` interpolates inside a bucket, so
    a mid-bucket threshold would count borderline observations
    fractionally — boundary-aligned thresholds keep bad counts integral."""
    from tpu_composer_torch.runtime import metrics

    out: List[Objective] = []
    if attach_p99_s > 0:
        out.append(Objective(
            "attach_p99", metrics.attach_to_ready_seconds, attach_p99_s, 0.99,
            "attach-to-ready latency (CR creation to Running)",
        ))
    if completion_p50_s > 0:
        out.append(Objective(
            "completion_p50", metrics.fabric_completion_latency,
            completion_p50_s, 0.50,
            "fabric op completion notification (dispatcher submit to settle)",
        ))
    if queue_p99_s > 0:
        out.append(Objective(
            "queue_wait_p99", metrics.queue_wait_seconds, queue_p99_s, 0.99,
            "work-queue wait (enqueue to dequeue)",
        ))
    if repair_p99_s > 0:
        out.append(Objective(
            "repair_p99", metrics.repair_time_to_replace_seconds,
            repair_p99_s, 0.99,
            "self-healing time-to-replace (Degraded to replaced)",
        ))
    return out


def active() -> Optional["SloEngine"]:
    return _active


def dump_file(path: Optional[str] = None) -> Optional[str]:
    """Write the active engine's snapshot to ``path`` (default
    $TPUC_SLO_FILE) — the soak failure artifact twin of the profiler's
    ring dump. Never raises."""
    path = path or os.environ.get("TPUC_SLO_FILE")
    eng = _active
    if not path or eng is None:
        return None
    try:
        with open(path, "w") as f:
            json.dump(eng.snapshot(), f, indent=1)
    except (OSError, ValueError):
        return None
    return path
