"""Per-CR lifecycle timelines + the crash flight recorder (port of
``tpu_composer/runtime/lifecycle.py``).

Two consumers of the same bounded per-object ledger:

- **Timelines**: a watch-fed tracker records every ``status.state``
  transition of ComposabilityRequests and ComposableResources, maps states
  to canonical phases (Pending -> Scheduled -> Attaching -> Ready, and the
  teardown mirror), observes the duration of each phase LEFT into
  ``tpuc_phase_duration_seconds{kind,phase}`` and serves
  ``/debug/requests/<name>`` on the manager's health port. This is the
  stage-attributed latency view the 32-GPU composable scaling study
  (arXiv:2404.06467) and Dagger (arXiv:2106.01482) both argue for: a
  latency CURVE decomposed by stage, not a single attach-to-ready point.

- **Flight recorder**: the same ledger also collects span summaries (via a
  tracing sink) and controller events per object — the last N things that
  happened to each CR. ``dump()`` writes it to ``$TPUC_FLIGHT_FILE`` on
  drain-timeout (Manager.stop), at interpreter exit, and on unhandled
  thread exceptions (``install()`` registers the hooks), so a wedged or
  crashing process leaves a black box behind. The crash-soak / chaos-soak
  CI steps upload it (plus the trace ring) as failure artifacts.

Everything is bounded: per-object entries roll off a fixed-length deque and
the object map is LRU-capped, so a churning fleet cannot grow the heap.
"""

from __future__ import annotations

import atexit
import collections
import json
import logging
import os
import queue as _queue
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from tpu_composer_torch.api.meta import now_iso
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.metrics import flight_dumps_total, phase_duration_seconds

log = logging.getLogger("lifecycle")

#: State -> canonical phase, per kind. The phase is what the histogram and
#: the timeline endpoint speak; the raw state is kept alongside in entries.
_REQUEST_PHASES = {
    "": "Pending",
    "NodeAllocating": "Pending",
    "Updating": "Scheduled",
    "Running": "Ready",
    "Cleaning": "Terminating",
    "Deleting": "Terminating",
}
_RESOURCE_PHASES = {
    "": "Pending",
    "Attaching": "Attaching",
    "Online": "Ready",
    # Self-healing: post-Ready failure (damped health probes / vanished
    # device) and the make-before-break window while a replacement attaches.
    "Degraded": "Degraded",
    "Repairing": "Repairing",
    # Live migration: a healthy member being evacuated make-before-break
    # (maintenance drain / node evacuation / defrag) while its replacement
    # attaches on the target node.
    "Migrating": "Migrating",
    "Detaching": "Detaching",
    "Deleting": "Terminating",
}
_DELETED_STATE = "(deleted)"
_DELETED_PHASE = "Deleted"

#: Span categories worth keeping in a CR's flight ledger (fabric spans are
#: children of these and visible in the full trace ring).
_SPAN_CATS = frozenset({"controller", "dispatcher", "adoption"})


def phase_for(kind: str, state: str) -> str:
    if state == _DELETED_STATE:
        return _DELETED_PHASE
    table = _REQUEST_PHASES if kind == "ComposabilityRequest" else _RESOURCE_PHASES
    return table.get(state, state or "Pending")


def _metric_kind(kind: str) -> str:
    return "request" if kind == "ComposabilityRequest" else "resource"


class FlightRecorder:
    """Bounded per-object ledger of phase transitions, span summaries and
    controller events; process-global singleton ``recorder`` below (the
    trace ring's sibling)."""

    def __init__(self, per_object: int = 64, max_objects: int = 2048) -> None:
        self._lock = threading.Lock()
        self._per_object = per_object
        self._max_objects = max_objects
        # name -> deque of entry dicts, LRU-ordered (oldest object first).
        # Entries carry their kind; a request and a resource sharing a
        # name interleave in one ledger (each entry says which it is).
        self._objects: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        # (kind, name) -> (phase, state, monotonic entered-at) of the
        # current phase — the duration source for phase_duration_seconds.
        # Keyed per kind so same-named objects of different kinds can't
        # fabricate phantom transitions or cross-attribute durations.
        self._current: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    def _ledger(self, name: str) -> collections.deque:
        # caller holds the lock
        entries = self._objects.get(name)
        if entries is None:
            entries = collections.deque(maxlen=self._per_object)
            self._objects[name] = entries
            while len(self._objects) > self._max_objects:
                evicted, _ = self._objects.popitem(last=False)
                for kind in ("ComposabilityRequest", "ComposableResource"):
                    self._current.pop((kind, evicted), None)
        else:
            self._objects.move_to_end(name)
        return entries

    def record_state(
        self, kind: str, name: str, state: str,
        trace_id: str = "", detail: str = "",
    ) -> None:
        """One observed ``status.state`` value; dedups repeats (every status
        write delivers a MODIFIED event, most without a state change)."""
        now_mono = time.monotonic()
        phase = phase_for(kind, state)
        with self._lock:
            cur = self._current.get((kind, name))
            if cur is not None and cur[1] == state:
                return  # no transition
            entry: Dict[str, Any] = {
                "t": "phase", "at": now_iso(), "kind": kind,
                "state": state, "phase": phase,
            }
            if trace_id:
                entry["trace_id"] = trace_id
            if detail:
                entry["detail"] = detail
            if cur is not None and cur[0] != phase:
                left_s = now_mono - cur[2]
                entry["prev_phase"] = cur[0]
                entry["prev_phase_s"] = round(left_s, 6)
                if cur[0] != _DELETED_PHASE:
                    phase_duration_seconds.observe(
                        left_s, kind=_metric_kind(kind), phase=cur[0]
                    )
            entered = now_mono if cur is None or cur[0] != phase else cur[2]
            self._current[(kind, name)] = (phase, state, entered)
            self._ledger(name).append(entry)

    def note_event(
        self, kind: str, name: str, type_: str, reason: str, message: str
    ) -> None:
        with self._lock:
            self._ledger(name).append({
                "t": "event", "at": now_iso(), "kind": kind,
                "type": type_, "reason": reason, "message": message,
            })

    def span_sink(self, evt: Dict[str, Any]) -> None:
        """tracing span-end sink: keep a summary of controller/dispatcher/
        adoption spans in the object's ledger (name from the span attrs)."""
        if evt.get("cat") not in _SPAN_CATS:
            return
        args = evt.get("args", {})
        name = args.get("object") or args.get("resource")
        if not name:
            return
        entry: Dict[str, Any] = {
            "t": "span", "at": now_iso(), "span": evt["name"],
            "dur_ms": round(evt.get("dur", 0.0) / 1e3, 3),
        }
        for k in ("trace_id", "outcome", "verb", "error", "controller"):
            if k in args:
                entry[k] = args[k]
        with self._lock:
            self._ledger(name).append(entry)

    # ------------------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return list(self._objects)

    def timeline(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entries = self._objects.get(name)
            if entries is None:
                return None
            out: Dict[str, Any] = {"name": name, "entries": list(entries)}
            # Same-named objects of different kinds share the ledger;
            # surface the most recently transitioned one as "current".
            matches = [
                (kind, cur) for (kind, n), cur in self._current.items()
                if n == name
            ]
            if matches:
                kind, cur = max(matches, key=lambda kc: kc[1][2])
                out["kind"] = kind
                out["phase"] = cur[0]
                out["state"] = cur[1]
                out["phase_age_s"] = round(time.monotonic() - cur[2], 6)
            return out

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """p50/p90 per (kind, phase) from the histogram's retained samples
        — what bench.py folds into its report."""
        out: Dict[str, Dict[str, float]] = {}
        for labels in phase_duration_seconds.label_sets():
            p50 = phase_duration_seconds.percentile(0.5, **labels)
            p90 = phase_duration_seconds.percentile(0.9, **labels)
            key = f"{labels.get('kind', '?')}/{labels.get('phase', '?')}"
            out[key] = {
                "p50_ms": round((p50 or 0.0) * 1e3, 3),
                "p90_ms": round((p90 or 0.0) * 1e3, 3),
                "count": phase_duration_seconds.count(**labels),
            }
        return out

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ledger (+ a trace summary) to ``path`` or
        ``$TPUC_FLIGHT_FILE``; returns the path or None when neither names
        a destination. Never raises — this runs on crash paths."""
        path = path or os.environ.get("TPUC_FLIGHT_FILE")
        if not path:
            return None
        with self._lock:
            objects = {name: list(entries) for name, entries in self._objects.items()}
            current = {
                name: {"kind": kind, "phase": c[0], "state": c[1]}
                for (kind, name), c in self._current.items()
            }
        doc = {
            "reason": reason,
            "written_at": now_iso(),
            "pid": os.getpid(),
            "objects": objects,
            "current": current,
            "trace_summary": tracing.summarize(),
        }
        try:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError:
            log.warning("flight-recorder dump to %s failed", path, exc_info=True)
            return None
        flight_dumps_total.inc(reason=reason)
        return path

    def reset(self) -> None:
        with self._lock:
            self._objects.clear()
            self._current.clear()


#: Process-global ledger, like tracing's ring and the metrics registry.
recorder = FlightRecorder()

#: Transition sinks: callables fed every watch-observed state transition
#: as (kind, name, state, owner) — owner is the managing request for
#: ComposableResources, "" otherwise. The goodput tracker subscribes;
#: sink exceptions are swallowed so an accounting bug can't kill the
#: lifecycle watch.
_transition_sinks: List[Callable[[str, str, str, str], None]] = []


def add_transition_sink(fn: Callable[[str, str, str, str], None]) -> None:
    if fn not in _transition_sinks:
        _transition_sinks.append(fn)


def remove_transition_sink(fn: Callable[[str, str, str, str], None]) -> None:
    if fn in _transition_sinks:
        _transition_sinks.remove(fn)


# ----------------------------------------------------------------------
# watch-fed state tracking (a Manager runnable)
# ----------------------------------------------------------------------
def watch_runnable(store) -> Callable[[threading.Event], None]:
    """Build a Manager runnable that subscribes to both CR kinds and feeds
    ``recorder`` every state transition. Decoupled from the controllers on
    purpose: transitions are recorded whoever wrote them (reconcile,
    adoption, a kubectl edit), and a controller bug can't silence the
    black box describing it."""

    def run(stop_event: threading.Event) -> None:
        kinds = ("ComposabilityRequest", "ComposableResource")
        watches = []
        try:
            for kind in kinds:
                try:
                    watches.append((kind, store.watch(kind)))
                except Exception:
                    log.exception("lifecycle watch on %s failed to start", kind)
            def drain() -> bool:
                progressed = False
                for kind, q in watches:
                    while True:
                        try:
                            ev = q.get_nowait()
                        except _queue.Empty:
                            break
                        if ev is None:
                            continue  # shutdown wake-up sentinel
                        progressed = True
                        try:
                            _apply(kind, ev)
                        except Exception:
                            log.exception("lifecycle: event apply failed")
                return progressed

            while not stop_event.is_set():
                if not drain() and stop_event.wait(0.05):
                    break
            # Final drain: anything the store already published before the
            # stop event fired must still land in the recorder, or a
            # teardown that completes just before Manager.stop loses its
            # last transitions (Terminating would never be observed).
            drain()
        finally:
            for _, q in watches:
                try:
                    store.stop_watch(q)
                except Exception:
                    pass

    return run


def _apply(kind: str, ev) -> None:
    name = ev.obj.metadata.name
    owner = ""
    if kind == "ComposableResource":
        # The managing request (LABEL_MANAGED_BY, inlined to keep this
        # module api-import-free) — what the goodput tracker charges a
        # member's Degraded/Repairing/Migrating time against.
        owner = ev.obj.metadata.labels.get(
            "app.kubernetes.io/managed-by", ""
        )
    if ev.type == "DELETED":
        recorder.record_state(kind, name, _DELETED_STATE)
        _feed_sinks(kind, name, _DELETED_STATE, owner)
        return
    trace_id = ""
    po = getattr(ev.obj.status, "pending_op", None)
    if po is not None:
        trace_id = po.nonce
    detail = getattr(ev.obj.status, "error", "") or ""
    recorder.record_state(kind, name, ev.obj.status.state,
                          trace_id=trace_id, detail=detail[:160])
    _feed_sinks(kind, name, ev.obj.status.state, owner)


def _feed_sinks(kind: str, name: str, state: str, owner: str) -> None:
    for sink in list(_transition_sinks):
        try:
            sink(kind, name, state, owner)
        except Exception:
            log.exception("lifecycle transition sink failed")


# ----------------------------------------------------------------------
# crash hooks (atexit + unhandled exceptions) — the satellite closing the
# "trace file only written on clean stop" gap.
# ----------------------------------------------------------------------
_install_lock = threading.Lock()
_installed = False
_prev_thread_hook: Optional[Callable] = None
_prev_sys_hook: Optional[Callable] = None
#: Set once a CRASH-shaped dump (unhandled exception, drain-timeout) has
#: been written: the atexit sweep must not later clobber that snapshot's
#: reason and crash-time ledger with post-crash state.
_crash_dumped = False


def dump_crash(reason: str) -> None:
    """Best-effort black-box write: flight ledger + trace ring + the
    continuous-profile ring, the SLO snapshot, the fleet view, the
    lock-order witness's report and the scheduler's decision ring,
    env-gated ($TPUC_FLIGHT_FILE /
    $TPUC_TRACE_FILE / $TPUC_PROFILE_FILE / $TPUC_SLO_FILE /
    $TPUC_FLEET_FILE / $TPUC_LOCKDEP_FILE / $TPUC_DECISIONS_FILE).
    Never raises."""
    global _crash_dumped
    if reason != "atexit":
        _crash_dumped = True
    try:
        recorder.dump(reason)
    except Exception:
        pass
    try:
        tracing.write_file()
    except Exception:
        pass
    # Late imports: the crash path should survive a partially-imported
    # interpreter at exit.
    try:
        from tpu_composer_torch.runtime import profiler as _profiler

        _profiler.dump_file()
    except Exception:
        pass
    try:
        from tpu_composer_torch.runtime import slo as _slo

        _slo.dump_file()
    except Exception:
        pass
    try:
        from tpu_composer_torch.runtime import fleet as _fleet

        _fleet.dump_file()
    except Exception:
        pass
    try:
        from tpu_composer_torch.analysis import lockdep as _lockdep

        _lockdep.dump_file()
    except Exception:
        pass
    try:
        from tpu_composer_torch.scheduler import ledger as _ledger

        _ledger.dump_file()
    except Exception:
        pass


def _atexit_hook() -> None:
    # The backstop for a process that exits without a clean Manager.stop.
    # A crash dump already on disk is the better snapshot — keep it.
    if not _crash_dumped:
        dump_crash("atexit")


def _thread_hook(hook_args) -> None:
    exc = hook_args.exc_type.__name__ if hook_args.exc_type else "unknown"
    dump_crash(f"unhandled-exception:{exc}")
    if _prev_thread_hook is not None:
        _prev_thread_hook(hook_args)


def _sys_hook(exc_type, exc, tb) -> None:
    dump_crash(f"unhandled-exception:{exc_type.__name__}")
    if _prev_sys_hook is not None:
        _prev_sys_hook(exc_type, exc, tb)


def install() -> None:
    """Idempotently register the span sink and the crash hooks: atexit
    (a process that exits without a clean Manager.stop — sys.exit from a
    wedged main, an unhandled MainThread exception) and
    threading.excepthook (a dying worker/dispatcher thread), each dumping
    the black box before delegating to the previous hook."""
    global _installed, _prev_thread_hook, _prev_sys_hook
    with _install_lock:
        if _installed:
            return
        _installed = True
    tracing.add_span_sink(recorder.span_sink)
    atexit.register(_atexit_hook)
    _prev_thread_hook = threading.excepthook
    threading.excepthook = _thread_hook
    _prev_sys_hook = sys.excepthook
    sys.excepthook = _sys_hook
