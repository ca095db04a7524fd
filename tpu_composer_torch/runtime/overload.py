"""Overload governor: the control plane degrades by POLICY, not collapse
(port of ``tpu_composer/runtime/overload.py``).

Without it, under reconcile overload every priority class degrades
together — much of a multi-replica collapse is self-inflicted queue
pressure — and a store outage is ridden only by per-key backoff. The governor folds the
signals the observatory already publishes into one Ok/Warn/Shed state
with hysteresis, and attaches policy to each level:

- **Ok (0)**: nothing.
- **Warn (1)**: non-critical cadences stretch by ``stretch_factor`` —
  defrag passes, the capacity sampler, fleet telemetry publishes, and the
  decision ledger's full hold-back rescans all slow down so the tight
  path (reconciles, health probes, dispatch) keeps the workers.
- **Shed (2)**: additionally, LOW-priority ComposabilityRequest
  reconciles (``spec.priority < priority_cutoff``, not being deleted) are
  deferred to a jittered ``shed_quantum`` instead of reconciling — health
  probes, detaches, repairs and high-priority requests keep the tight
  path. Every deferred pass counts ``tpuc_overload_sheds_total{class}``
  and lands in the decision ledger as a hold-back with
  ``binding.resource = "overload"`` / ``reason=overload``, so
  the explain record answers "why is my request slow" during
  the storm.

Signals per evaluation tick (period ``period`` seconds):

- summed controller queue depth ≥ ``depth_shed`` → shed; ≥ ``depth_warn``
  → warn;
- the store breaker open → shed (the control plane cannot commit writes;
  deferring low-priority churn is exactly the drain discipline the heal
  needs); the fabric breaker open → warn;
- max ``tpuc_worker_busy_ratio`` ≥ ``busy_warn`` → warn;
- windowed queue-wait p99 (bucket-count delta since the last tick, the
  SLO engine's diff trick) ≥ ``wait_warn_s`` → warn;
- any SLO burn alert firing → warn.

Hysteresis: escalation needs ``enter_ticks`` consecutive ticks at the
higher level, de-escalation ``exit_ticks`` consecutive ticks below the
current one — a one-tick blip neither sheds nor un-sheds.

``tpuc_overload_state`` publishes the state; ``/debug/overload`` serves
:meth:`snapshot`. A caller passes it to the Manager (``Manager(overload=
...)``) and installs :func:`request_shed_gate`; without one there is no
governor thread, no shed gate on the request controller and no cadence
stretching.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_composer_torch.runtime.metrics import (
    overload_sheds_total,
    overload_state,
    queue_wait_seconds,
    worker_busy_ratio,
)

log = logging.getLogger("tpuc.overload")

OK = 0
WARN = 1
SHED = 2

_STATE_NAMES = {OK: "ok", WARN: "warn", SHED: "shed"}


class OverloadGovernor:
    def __init__(
        self,
        period: float = 1.0,
        depth_warn: int = 256,
        depth_shed: int = 1024,
        busy_warn: float = 0.95,
        wait_warn_s: float = 1.0,
        stretch_factor: float = 4.0,
        shed_quantum: float = 5.0,
        priority_cutoff: int = 50,
        enter_ticks: int = 2,
        exit_ticks: int = 3,
        ledger=None,          # duck-typed DecisionLedger; None = no records
        store_breaker=None,   # duck-typed BreakingStore (.is_open)
        fabric_open: Optional[Callable[[], bool]] = None,
        slo_breached: Optional[Callable[[], bool]] = None,
        recorder=None,        # duck-typed EventRecorder (.event)
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.period = max(0.05, period)
        self.depth_warn = depth_warn
        self.depth_shed = depth_shed
        self.busy_warn = busy_warn
        self.wait_warn_s = wait_warn_s
        self.stretch_factor = max(1.0, stretch_factor)
        self.shed_quantum = shed_quantum
        self.priority_cutoff = priority_cutoff
        self.enter_ticks = max(1, enter_ticks)
        self.exit_ticks = max(1, exit_ticks)
        self.ledger = ledger
        self.store_breaker = store_breaker
        self.fabric_open = fabric_open
        self.slo_breached = slo_breached
        self.recorder = recorder
        self.watchdog = None  # set by cmd wiring; the governor beats
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.state = OK
        self._above = 0   # consecutive ticks at a level above state
        self._below = 0   # consecutive ticks at a level below state
        self._queues: List[Callable[[], int]] = []
        #: (obj, attr, base) cadences stretched in Warn/Shed.
        self._stretched: List[Tuple[Any, str, float]] = []
        #: previous aggregated queue-wait bucket counts (windowed p99).
        self._prev_wait: Optional[List[int]] = None
        self._last_signals: Dict[str, Any] = {}
        self.sheds = 0
        self.transitions = 0
        overload_state.set(OK)

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def add_queue(self, depth_fn: Callable[[], int]) -> None:
        """Register one controller's live queue-depth callable."""
        self._queues.append(depth_fn)

    def stretch(self, obj: Any, attr: str) -> None:
        """Register ``obj.attr`` as a non-critical cadence: multiplied by
        ``stretch_factor`` while in Warn/Shed, restored on Ok. The base
        is captured at registration."""
        self._stretched.append((obj, attr, float(getattr(obj, attr))))

    # ------------------------------------------------------------------
    # signal evaluation
    # ------------------------------------------------------------------
    def _windowed_wait_p99(self) -> Optional[float]:
        """Queue-wait p99 over observations landed SINCE THE LAST TICK
        (cumulative bucket counts are useless for "now": a week of calm
        buries a one-minute storm). Aggregates across queues."""
        state = queue_wait_seconds.state()
        buckets = state["buckets"]
        agg = [0] * (len(buckets) + 1)
        for _, counts, _ in state["series"]:
            for i, c in enumerate(counts):
                agg[i] += c
        prev, self._prev_wait = self._prev_wait, agg
        if prev is None or len(prev) != len(agg):
            return None
        delta = [max(0, a - p) for a, p in zip(agg, prev)]
        total = sum(delta)
        if total == 0:
            return None
        rank = 0.99 * total
        cum = 0.0
        prev_b = 0.0
        for i, b in enumerate(buckets):
            c = delta[i]
            if cum + c >= rank and c > 0:
                return prev_b + ((rank - cum) / c) * (b - prev_b)
            cum += c
            prev_b = b
        return buckets[-1] if buckets else None

    def _target_level(self) -> int:
        depth = 0
        for fn in self._queues:
            try:
                depth += fn()
            except Exception:
                pass
        store_open = bool(
            self.store_breaker is not None and self.store_breaker.is_open()
        )
        fabric_open = bool(self.fabric_open is not None and self.fabric_open())
        busy = 0.0
        for _, v in worker_busy_ratio.state():
            busy = max(busy, float(v))
        wait_p99 = self._windowed_wait_p99()
        slo = bool(self.slo_breached is not None and self.slo_breached())
        self._last_signals = {
            "queue_depth": depth,
            "store_breaker_open": store_open,
            "fabric_breaker_open": fabric_open,
            "max_worker_busy_ratio": round(busy, 3),
            "queue_wait_p99_s": (
                round(wait_p99, 4) if wait_p99 is not None else None
            ),
            "slo_breached": slo,
        }
        if store_open or depth >= self.depth_shed:
            return SHED
        if (
            fabric_open
            or slo
            or depth >= self.depth_warn
            or busy >= self.busy_warn
            or (wait_p99 is not None and wait_p99 >= self.wait_warn_s)
        ):
            return WARN
        return OK

    def tick(self) -> int:
        """One evaluation pass; returns the (possibly new) state."""
        brk = self.store_breaker
        if brk is not None and hasattr(brk, "probe"):
            # Active ride-through: while Shed defers low-priority work,
            # nothing else may touch the wire — probe the open breaker
            # here so an idle plane still notices the store healing
            # (fail-fast no-op until the breaker's retry window passes).
            try:
                if brk.is_open():
                    brk.probe()
            except Exception:
                log.exception("overload: store breaker probe failed")
        target = self._target_level()
        with self._lock:
            if target > self.state:
                self._above += 1
                self._below = 0
                if self._above >= self.enter_ticks:
                    self._transition(target)
            elif target < self.state:
                self._below += 1
                self._above = 0
                if self._below >= self.exit_ticks:
                    # Step DOWN one level at a time: shed→warn→ok, so a
                    # recovering storm re-enters the stretched regime
                    # before the tight one.
                    self._transition(self.state - 1)
            else:
                self._above = self._below = 0
            return self.state

    def _transition(self, new_state: int) -> None:
        # caller holds the lock
        old, self.state = self.state, new_state
        self._above = self._below = 0
        self.transitions += 1
        overload_state.set(new_state)
        if new_state > OK and old == OK:
            for obj, attr, base in self._stretched:
                try:
                    setattr(obj, attr, base * self.stretch_factor)
                except Exception:
                    pass
        elif new_state == OK:
            for obj, attr, base in self._stretched:
                try:
                    setattr(obj, attr, base)
                except Exception:
                    pass
        log.warning(
            "overload governor: %s -> %s (%s)",
            _STATE_NAMES[old], _STATE_NAMES[new_state], self._last_signals,
        )
        if self.recorder is not None:
            try:
                self.recorder.event(
                    _GovernorRef(), "Warning" if new_state > OK else "Normal",
                    "OverloadState",
                    f"control-plane overload state {_STATE_NAMES[old]} ->"
                    f" {_STATE_NAMES[new_state]}: {self._last_signals}",
                )
            except Exception:
                log.exception("overload: transition event failed")

    # ------------------------------------------------------------------
    # shed policy (consulted by the request controller's worker loop)
    # ------------------------------------------------------------------
    def shed_delay(self, priority: int, deleting: bool = False
                   ) -> Optional[float]:
        """Defer-this-reconcile delay, or None to run it now. Only sheds
        while in Shed state, only below the priority cutoff, never a
        deletion (detaches always keep the tight path)."""
        if self.state != SHED or deleting or priority >= self.priority_cutoff:
            return None
        # Jittered stretched quantum: U(0.5, 1.0) x shed_quantum, so held
        # keys do not re-arrive as one synchronized wave either.
        return self.shed_quantum * self._rng.uniform(0.5, 1.0)

    def note_shed(self, name: str, priority: int) -> None:
        """Account one deferred reconcile: metric + ledger hold-back with
        reason=overload (bump_if_recent keeps repeat sheds at one record)."""
        self.sheds += 1
        overload_sheds_total.inc(**{"class": "request"})
        led = self.ledger
        if led is None:
            return
        try:
            from tpu_composer_torch.scheduler.ledger import (
                OUTCOME_HELD_BACK,
                DecisionRecord,
            )

            if led.bump_if_recent(
                name, kind="shed", outcome=OUTCOME_HELD_BACK,
                within_s=max(self.shed_quantum * 2.0, led.hold_rescan_s),
                resource="overload",
            ) is not None:
                return
            led.record(DecisionRecord(
                request=name,
                kind="shed",
                outcome=OUTCOME_HELD_BACK,
                summary=(
                    f"held back: control-plane overload shed"
                    f" (reason=overload, priority {priority} <"
                    f" cutoff {self.priority_cutoff}; deferred"
                    f" ~{self.shed_quantum:.1f}s)"
                ),
                priority=priority,
                binding={
                    "resource": "overload",
                    "reason": "overload",
                    "state": _STATE_NAMES[SHED],
                    "shed_quantum_s": self.shed_quantum,
                },
            ))
        except Exception:
            log.exception("overload: ledger shed record failed")

    # ------------------------------------------------------------------
    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable: evaluate on a fixed cadence; must never die."""
        while not stop_event.wait(self.period):
            wd = self.watchdog
            if wd is not None:
                wd.beat("OverloadGovernor")
            try:
                self.tick()
            except Exception:  # pragma: no cover - must never die
                log.exception("overload governor tick failed")

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The /debug/overload payload."""
        with self._lock:
            return {
                "state": self.state,
                "state_name": _STATE_NAMES[self.state],
                "period_s": self.period,
                "signals": dict(self._last_signals),
                "thresholds": {
                    "depth_warn": self.depth_warn,
                    "depth_shed": self.depth_shed,
                    "busy_warn": self.busy_warn,
                    "wait_warn_s": self.wait_warn_s,
                },
                "hysteresis": {
                    "enter_ticks": self.enter_ticks,
                    "exit_ticks": self.exit_ticks,
                },
                "priority_cutoff": self.priority_cutoff,
                "shed_quantum_s": self.shed_quantum,
                "stretch_factor": self.stretch_factor,
                "stretched": [
                    {"attr": attr, "base_s": base,
                     "current_s": float(getattr(obj, attr, base))}
                    for obj, attr, base in self._stretched
                ],
                "sheds": self.sheds,
                "transitions": self.transitions,
            }


class _GovernorRef:
    """Recorder shim: events against the governor pseudo-object."""

    KIND = "OverloadGovernor"

    def __init__(self) -> None:
        from types import SimpleNamespace

        self.metadata = SimpleNamespace(name="overload-governor")


def request_shed_gate(governor: OverloadGovernor, client):
    """Build the request controller's shed gate: a ``key -> Optional[delay]``
    callable consulted before each reconcile. Reads ride the informer
    cache (zero RTT — and, during a store outage, the only read that
    works); any read failure fails OPEN (reconcile runs) so the gate can
    never wedge the controller it is protecting."""
    from tpu_composer_torch.api import ComposabilityRequest

    def gate(key) -> Optional[float]:
        if governor.state != SHED:
            return None
        try:
            req = client.try_get(ComposabilityRequest, key)
        except Exception:
            return None
        if req is None or req.metadata.deletion_timestamp is not None:
            return None
        delay = governor.shed_delay(int(req.spec.priority or 0))
        if delay is not None:
            governor.note_shed(key, int(req.spec.priority or 0))
        return delay

    return gate
