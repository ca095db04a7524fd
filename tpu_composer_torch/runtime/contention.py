"""Lock-contention telemetry: ObservedLock + worker busy-ratio tracking
(port of ``tpu_composer/runtime/contention.py``).

This module says which *locks* threads queue on —
``ObservedLock`` wraps a hot lock and measures acquire-wait and hold time
into ``tpuc_lock_wait_seconds{lock}`` / ``tpuc_lock_hold_seconds{lock}``.
Wired onto the Store lock, the InMemoryPool lock, the per-kind informer
locks, the FabricDispatcher condition lock and the resource controller's
chip-index lock. Reading the pair: wait climbing while hold stays flat is
contention (more threads than the critical section can feed); both
climbing means the section itself got slower.

Semantics kept exact:

- **Reentrancy**: ``reentrant=True`` wraps an RLock; only the OUTERMOST
  acquire/release pair is timed (inner re-acquires are free and
  uncontended by definition).
- **Condition parks are not contention**: the wrapper implements the
  private lock protocol ``threading.Condition`` looks for
  (``_release_save`` / ``_acquire_restore`` / ``_is_owned``), so a
  ``cond.wait()`` closes the hold observation at park time (the lock IS
  released) and restarts the hold clock at wakeup WITHOUT counting the
  park — a dispatcher worker idling in ``wait()`` for seconds must not
  read as a multi-second lock wait.
- ``TPUC_PROFILE=0`` (or ``set_enabled(False)``) skips every histogram
  observation; the wrapper then only pays the thread-local depth
  bookkeeping. The perf-smoke observatory gate holds the enabled path
  within 5% of this on the 32-chip wave.

``ObservedLock`` also feeds the lockdep witness
(tpu_composer_torch/analysis/lockdep.py) when one is enabled
(``TPUC_LOCKDEP=1``, or the port's operator twins): every
outermost acquire/release updates a per-thread held-lock stack and the
global acquisition-order graph, so an ABBA-shaped ordering inconsistency
anywhere in the suite surfaces as a lockdep cycle report even when the
threads never actually collide. Cond-parks go through
``_release_save``/``_acquire_restore`` and are excluded from ordering
(the park releases the lock; the wakeup re-acquire is not a new ordering
decision). Witness accounting is independent of ``TPUC_PROFILE`` — the
deadlock detector must not vanish with the telemetry.

``BusyTracker`` is the saturation sibling: worker pools feed it their
per-turn busy seconds and it level-sets ``tpuc_worker_busy_ratio{pool}``
over a rolling window — visible before queue wait (and long before
latency) climbs.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from tpu_composer_torch.analysis import lockdep
from tpu_composer_torch.runtime.metrics import (
    lock_hold_seconds,
    lock_wait_seconds,
    worker_busy_ratio,
)

_enabled = os.environ.get("TPUC_PROFILE", "1") != "0"


def set_enabled(on: bool) -> None:
    """Hard on/off for every contention observation (the TPUC_PROFILE=0
    escape hatch, shared with the profiler and the SLO engine)."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


class ObservedLock:
    """Drop-in Lock/RLock replacement recording wait + hold histograms."""

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # Per-thread (depth, held_at): depth>0 means this thread owns the
        # lock; held_at is the outermost acquire's timestamp (None when
        # observation was disabled at acquire time).
        self._local = threading.local()

    # -- standard lock protocol -----------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        depth = getattr(self._local, "depth", 0)
        if depth:
            # Reentrant re-acquire: uncontended, not re-timed, and not an
            # ordering event for lockdep (the outermost acquire was).
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._local.depth = depth + 1
            return ok
        # Lockdep sees the ATTEMPT (before blocking): the ordering
        # decision is made here, and recording uncontended acquires is
        # what lets the witness flag a cycle no collision exercised.
        witness = lockdep.current()
        if witness is not None:
            witness.note_acquire(self.name, id(self))
        if not _enabled:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._local.depth = 1
                self._local.held_at = None
            elif witness is not None:
                witness.note_acquire_failed(self.name)
            return ok
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            t1 = time.perf_counter()
            self._local.depth = 1
            self._local.held_at = t1
            lock_wait_seconds.observe(t1 - t0, lock=self.name)
        elif witness is not None:
            witness.note_acquire_failed(self.name)
        return ok

    def release(self) -> None:
        depth = getattr(self._local, "depth", 0)
        if depth > 1:
            self._local.depth = depth - 1
            self._inner.release()
            return
        held_at = getattr(self._local, "held_at", None)
        self._local.depth = 0
        self._local.held_at = None
        self._inner.release()
        witness = lockdep.current()
        if witness is not None:
            witness.note_release(self.name)
        if held_at is not None and _enabled:
            lock_hold_seconds.observe(
                time.perf_counter() - held_at, lock=self.name
            )

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # -- threading.Condition private protocol ---------------------------
    def _is_owned(self) -> bool:
        return getattr(self._local, "depth", 0) > 0

    def _release_save(self):
        """Condition.wait is about to park: close the hold observation
        (the lock really is released for the park's duration) and save
        enough state to restore the exact ownership depth afterwards."""
        depth = getattr(self._local, "depth", 0)
        held_at = getattr(self._local, "held_at", None)
        self._local.depth = 0
        self._local.held_at = None
        if hasattr(self._inner, "_release_save"):
            inner_state = self._inner._release_save()  # RLock: all levels
        else:
            self._inner.release()
            inner_state = None
        witness = lockdep.current()
        if witness is not None:
            witness.note_park(self.name)
        if held_at is not None and _enabled:
            lock_hold_seconds.observe(
                time.perf_counter() - held_at, lock=self.name
            )
        return (inner_state, depth)

    def _acquire_restore(self, state) -> None:
        """Wakeup from Condition.wait: re-own at the saved depth and
        restart the hold clock. The re-acquire is deliberately NOT counted
        as lock wait — it is indistinguishable from the park itself."""
        inner_state, depth = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        witness = lockdep.current()
        if witness is not None:
            # Deliberately NOT note_acquire: the wakeup re-acquire is not
            # a new ordering decision (cond-park exclusion).
            witness.note_unpark(self.name, id(self))
        self._local.depth = depth
        self._local.held_at = time.perf_counter() if _enabled else None


class BusyTracker:
    """Rolling busy-ratio gauge for a worker pool.

    Workers call ``add(busy_seconds)`` after each turn (0.0 on an idle
    wake); once ``window`` seconds have elapsed the tracker level-sets
    ``tpuc_worker_busy_ratio{pool}`` to busy/(elapsed*workers) and resets.
    The gauge goes stale only if every worker parks indefinitely — worker
    loops here all wake on bounded timeouts."""

    def __init__(self, pool: str, workers: int = 1, window: float = 15.0) -> None:
        self.pool = pool
        self.workers = max(1, workers)
        self.window = window
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._busy = 0.0

    def add(self, busy_s: float) -> None:
        if not _enabled:
            return
        now = time.monotonic()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._busy += max(0.0, busy_s)
            elapsed = now - self._t0
            if elapsed < self.window:
                return
            ratio = min(1.0, self._busy / (elapsed * self.workers))
            self._t0 = now
            self._busy = 0.0
        worker_busy_ratio.set(round(ratio, 4), pool=self.pool)
