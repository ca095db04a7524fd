"""Subsystem watchdog: heartbeat registry + stall detection + restarts
(port of ``tpu_composer/runtime/watchdog.py``).

The control plane runs as named daemon threads (manager runnables,
controller workers, dispatcher lanes — each named so it is attributable),
and a wedged one would otherwise stall SILENTLY until an SLO burned
minutes later. The watchdog closes that gap:

- subsystems ``beat(name)`` from inside their loops (controller workers
  beat every queue.get() wake, ≥5x/s healthy; dispatcher lanes every cond
  wake; the overload governor every tick). First beat auto-registers with
  the default stall threshold; loops that legitimately run slower
  register explicitly with their own ``stall_after``.
- the scan loop (a Manager runnable) flags a subsystem whose last beat is
  older than its threshold ONCE per stall edge (the flag re-arms when a
  fresh beat lands): ``tpuc_watchdog_stalls_total{subsystem}``, a
  ``WatchdogStall`` Event, a flight-recorder entry, and an on-demand
  profiler burst capturing the wedged stack (``profile_burst`` works even
  with TPUC_PROFILE=0 — the one-shot sampler needs no resident thread).
- a subsystem registered ``restartable`` is restarted through the
  Manager's respawn hook, bounded by ``restart_budget`` per subsystem
  (``tpuc_watchdog_restarts_total{subsystem}``); a stall past the budget
  — or the third stall of any subsystem — dumps the black boxes
  (flight/trace/profile, and whatever else ``lifecycle.dump_crash`` keeps)
  so the evidence survives even if the process is later killed.

False-positive discipline: the threshold is per-subsystem and the beat
sits at the top of each loop iteration, so a slow-but-progressing loop (a
GC pause, a long store RTT inside one reconcile) never trips as long as
one iteration completes per window. Exiting loops ``unregister`` so a
clean shutdown can't race the final scan into a phantom stall.

A caller passes it to the Manager (``Manager(watchdog=...)``); without
one nothing of this runs. ``/debug/watchdog`` serves :meth:`snapshot`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from tpu_composer_torch.runtime import lifecycle
from tpu_composer_torch.runtime.metrics import (
    watchdog_restarts_total,
    watchdog_stalls_total,
)

log = logging.getLogger("tpuc.watchdog")

#: Stalls of one subsystem after which the black boxes are dumped even if
#: restarts are still inside the budget — repeated stalls mean the restart
#: is not fixing it and the evidence should hit disk now.
_DUMP_AFTER_STALLS = 3


class _Subsystem:
    __slots__ = (
        "name", "stall_after", "restartable", "restart",
        "last_beat", "stalled", "stalls", "restarts", "beats",
    )

    def __init__(self, name: str, stall_after: float, now: float,
                 restartable: bool, restart: Optional[Callable[[], bool]]):
        self.name = name
        self.stall_after = stall_after
        self.restartable = restartable
        self.restart = restart
        self.last_beat = now
        self.stalled = False
        self.stalls = 0
        self.restarts = 0
        self.beats = 0


class Watchdog:
    def __init__(
        self,
        stall_after: float = 30.0,
        restart_budget: int = 3,
        scan_period: Optional[float] = None,
        capture_burst: bool = True,
        recorder=None,   # duck-typed EventRecorder (.event)
        clock: Callable[[], float] = time.monotonic,
        burst_seconds: float = 0.5,
    ) -> None:
        self.stall_after = stall_after
        self.restart_budget = max(0, restart_budget)
        self.scan_period = scan_period or max(0.2, stall_after / 4.0)
        self.capture_burst = capture_burst
        self.recorder = recorder
        self.burst_seconds = burst_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._subsystems: Dict[str, _Subsystem] = {}
        #: Manager's respawn hook for restartable runnables without their
        #: own restart callable (set by Manager.start()).
        self.restarter: Optional[Callable[[str], bool]] = None
        #: last stall's profiler-burst top frames, for /debug/watchdog.
        self._last_burst: Optional[Dict[str, Any]] = None
        self._dumped: set = set()

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------
    def register(
        self,
        name: str,
        stall_after: Optional[float] = None,
        restartable: bool = False,
        restart: Optional[Callable[[], bool]] = None,
    ) -> None:
        """Start monitoring ``name``. ``restart`` (or, for a Manager
        runnable, the Manager's respawn hook) is invoked on stall while
        the restart budget lasts."""
        now = self._clock()
        with self._lock:
            self._subsystems[name] = _Subsystem(
                name, stall_after or self.stall_after, now,
                restartable or restart is not None, restart,
            )

    def unregister(self, name: str) -> None:
        with self._lock:
            self._subsystems.pop(name, None)

    def beat(self, name: str) -> None:
        """Record liveness. Unknown names auto-register with defaults so
        worker loops need no setup call."""
        now = self._clock()
        with self._lock:
            sub = self._subsystems.get(name)
            if sub is None:
                sub = _Subsystem(name, self.stall_after, now, False, None)
                self._subsystems[name] = sub
            sub.last_beat = now
            sub.beats += 1
            if sub.stalled:
                sub.stalled = False  # recovered — re-arm the edge
                log.info("watchdog: %s recovered (beat after stall)", name)

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------
    def scan(self, now: Optional[float] = None) -> int:
        """One detection pass; returns the number of NEW stalls flagged.
        ``now`` is injectable for deterministic tests."""
        now = self._clock() if now is None else now
        stalled: list = []
        with self._lock:
            for sub in self._subsystems.values():
                if sub.stalled:
                    continue
                if now - sub.last_beat > sub.stall_after:
                    sub.stalled = True
                    sub.stalls += 1
                    stalled.append(sub)
        for sub in stalled:
            self._handle_stall(sub, now)
        return len(stalled)

    def _handle_stall(self, sub: _Subsystem, now: float) -> None:
        age = now - sub.last_beat
        msg = (
            f"subsystem {sub.name} stalled: no heartbeat for {age:.1f}s"
            f" (threshold {sub.stall_after:.1f}s, stall #{sub.stalls})"
        )
        log.error("watchdog: %s", msg)
        watchdog_stalls_total.inc(subsystem=sub.name)
        lifecycle.recorder.note_event(
            "Watchdog", sub.name, "Warning", "WatchdogStall", msg
        )
        if self.recorder is not None:
            try:
                self.recorder.event(
                    _WatchdogRef(sub.name), "Warning", "WatchdogStall", msg
                )
            except Exception:
                log.exception("watchdog: stall event failed")
        # Capture the wedged stack NOW: a one-shot burst on this thread,
        # independent of the always-on sampler (works under TPUC_PROFILE=0).
        if self.capture_burst:
            try:
                from tpu_composer_torch.runtime import profiler as profiler_mod

                burst = profiler_mod.profile_burst(
                    seconds=self.burst_seconds, interval=0.02
                )
                self._last_burst = {
                    "subsystem": sub.name,
                    "at_mono": round(now, 3),
                    "top": burst.top(10),
                }
            except Exception:
                log.exception("watchdog: profiler burst failed")
        restarted = False
        if sub.restartable and sub.restarts < self.restart_budget:
            restarted = self._restart(sub)
        if (not restarted and sub.restartable) or sub.stalls >= _DUMP_AFTER_STALLS:
            # Budget exhausted or chronically stalling: evidence to disk.
            if sub.name not in self._dumped:
                self._dumped.add(sub.name)
                lifecycle.dump_crash(f"watchdog-stall:{sub.name}")

    def _restart(self, sub: _Subsystem) -> bool:
        fn = sub.restart
        try:
            if fn is not None:
                ok = fn() is not False
            elif self.restarter is not None:
                ok = self.restarter(sub.name) is not False
            else:
                return False
        except Exception:
            log.exception("watchdog: restart of %s failed", sub.name)
            return False
        if ok:
            sub.restarts += 1
            watchdog_restarts_total.inc(subsystem=sub.name)
            # Fresh grace window for the restarted thread, and re-arm the
            # stall edge so a restart that does not take is re-detected.
            with self._lock:
                sub.last_beat = self._clock()
                sub.stalled = False
            log.warning(
                "watchdog: restarted %s (restart %d/%d)",
                sub.name, sub.restarts, self.restart_budget,
            )
        return ok

    # ------------------------------------------------------------------
    def run(self, stop_event: threading.Event) -> None:
        """Manager runnable: scan on a fixed cadence; must never die."""
        while not stop_event.wait(self.scan_period):
            try:
                self.scan()
            except Exception:  # pragma: no cover - must never die
                log.exception("watchdog scan failed")

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The /debug/watchdog payload."""
        now = self._clock()
        with self._lock:
            subs = {
                s.name: {
                    "last_beat_age_s": round(now - s.last_beat, 3),
                    "stall_after_s": s.stall_after,
                    "stalled": s.stalled,
                    "stalls": s.stalls,
                    "restarts": s.restarts,
                    "restartable": s.restartable,
                    "beats": s.beats,
                }
                for s in self._subsystems.values()
            }
        return {
            "scan_period_s": self.scan_period,
            "restart_budget": self.restart_budget,
            "subsystems": subs,
            "last_stall_burst": self._last_burst,
        }


class _WatchdogRef:
    """Recorder shim: event against a subsystem by name without an object."""

    KIND = "Watchdog"

    def __init__(self, name: str) -> None:
        from types import SimpleNamespace

        self.metadata = SimpleNamespace(name=name)
