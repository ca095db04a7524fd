"""Manager: owns the store, controllers, runnables and the health server
(port of ``tpu_composer/runtime/manager.py``: its core).

Reference analog: ctrl.NewManager + mgr.Start in cmd/main.go:137-218 —
controllers are registered, optional leader election gates startup, healthz/
readyz endpoints back the Deployment probes (config/manager/manager.yaml:73-85),
and a metrics endpoint serves Prometheus text.

The port keeps the controllers, the runnables, leader election on a lock
file, the health server (``/healthz``, ``/readyz``, ``/metrics`` and the
trace and lifecycle routes), the startup hooks, the lifecycle recorder and
the graceful stop. The JAX manager's optional collaborators (the fabric
dispatcher's drain, the sampling profiler, the SLO engine, the fleet plane,
defrag, the decision ledger, capacity, goodput, the overload governor, the
watchdog, the store breaker, lease electors, replica identity and the TLS
metrics port) and their ``/debug/*`` routes arrive with the modules they
need.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import urllib.parse
from typing import Callable, List, Optional

from tpu_composer_torch.runtime.controller import Controller
from tpu_composer_torch.runtime.events import EventRecorder
from tpu_composer_torch.runtime.leader import LeaderElector
from tpu_composer_torch.runtime import lifecycle, tracing
from tpu_composer_torch.runtime.metrics import global_registry
from tpu_composer_torch.runtime.store import Store

#: /debug/traces responses are capped: a 10k-event ring serializes to
#: multiple MB, and an unpaginated scrape of it from a dashboard poller
#: must not balloon memory or saturate the probe port. Oldest events are
#: dropped first (the ring's own semantics) and the response says so.
TRACE_RESPONSE_BYTE_CAP = 2_000_000

#: The /debug index: route -> one-line description. Kept here (not in a
#: docstring) so the running process is self-describing.
DEBUG_ENDPOINTS = {
    "/debug/traces": "Chrome trace-event JSON of recent control-plane spans"
                     " (?cat=&limit=; open in Perfetto)",
    "/debug/traces/summary": "per-span-name count/total/max durations (ms)"
                             " (?cat=)",
    "/debug/requests": "names with recorded lifecycle timelines",
    "/debug/requests/<name>": "one CR's timeline: phase transitions,"
                              " events, span summaries",
}

# A runnable is the analog of manager.Add(RunnableFunc) used by the
# UpstreamSyncer (upstreamsyncer_controller.go:52-77): start(stop_event).
Runnable = Callable[[threading.Event], None]


def _runnable_name(r) -> str:
    """Stable thread name for a runnable: the owning class for bound
    methods and callable instances, the function name otherwise."""
    owner = getattr(r, "__self__", None)
    if owner is not None:
        return type(owner).__name__
    name = getattr(r, "__name__", "")
    if name and name not in ("<lambda>", "run"):
        return name
    return type(r).__name__


class _HealthHandler(http.server.BaseHTTPRequestHandler):
    manager: "Manager"

    def _respond(self, code: int, body: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_json(self, code: int, data: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):  # noqa: N802
        parts = urllib.parse.urlsplit(self.path)
        path = parts.path
        query = urllib.parse.parse_qs(parts.query)
        if path == "/healthz":
            self._respond(200, "ok")
        elif path == "/readyz":
            ready = self.manager.ready()
            self._respond(200 if ready else 503, "ok" if ready else "not ready")
        elif path == "/metrics":
            self._respond(200, global_registry.expose_text())
        elif path == "/debug/traces":
            # Chrome trace-event JSON of recent control-plane spans
            # (chrome://tracing / Perfetto). Names and durations only — no
            # secrets. ?cat=<category> and ?limit=<n> narrow the export;
            # responses are size-capped either way, dropping OLDEST events
            # first (ring semantics) and reporting how many were dropped.
            self._respond_json(200, self._trace_body(query))
        elif path == "/debug/traces/summary":
            cat = (query.get("cat") or [None])[0]
            self._respond(200, json.dumps(tracing.summarize(cat=cat), indent=1))
        elif path == "/debug/requests":
            self._respond_json(200, json.dumps(
                {"requests": lifecycle.recorder.names()}).encode())
        elif path.startswith("/debug/requests/"):
            # Per-CR lifecycle timeline: phase transitions with durations,
            # span summaries and controller events — "where did this
            # request's time go" as one JSON document.
            name = urllib.parse.unquote(path[len("/debug/requests/"):])
            timeline = lifecycle.recorder.timeline(name)
            if timeline is None:
                self._respond(404, f"no timeline recorded for {name!r}")
            else:
                self._respond_json(200, json.dumps(timeline, indent=1).encode())
        elif path in ("/debug", "/debug/"):
            self._respond_json(200, json.dumps(
                {"endpoints": DEBUG_ENDPOINTS}, indent=1).encode())
        else:
            self._respond(404, "not found")

    @staticmethod
    def _trace_body(query) -> bytes:
        cat = (query.get("cat") or [None])[0]
        limit = None
        raw_limit = (query.get("limit") or [None])[0]
        if raw_limit is not None:
            try:
                limit = max(0, int(raw_limit))
            except ValueError:
                limit = None
        events = tracing.snapshot(cat=cat, limit=limit)
        total = len(events)

        def body(evts) -> bytes:
            doc = tracing.chrome_doc(evts)
            if len(evts) < total:
                doc["truncated"] = total - len(evts)
            return json.dumps(doc).encode()

        data = body(events)
        while len(data) > TRACE_RESPONSE_BYTE_CAP and events:
            # Halve from the OLD end until it fits — newest spans are the
            # ones a live debugging session wants.
            events = events[len(events) // 2 + 1:]
            data = body(events)
        return data


class Manager:
    def __init__(
        self,
        store: Optional[Store] = None,
        leader_elect: bool = False,
        leader_lock_path: Optional[str] = None,
        health_addr: Optional[str] = None,  # "host:port" or None to disable
    ) -> None:
        # `is not None`, not `or`: an EMPTY store is falsy (Store.__len__),
        # and silently swapping in a fresh one would orphan the caller's
        # admission hooks and persistence settings.
        self.store = store if store is not None else Store()
        self.recorder = EventRecorder()
        self.log = logging.getLogger("manager")
        self._controllers: List[Controller] = []
        self._runnables: List[Runnable] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        #: set when a running leader loses its lock (the caller exits non-zero)
        self.lost_leadership = False
        self._elector = LeaderElector(leader_lock_path) if leader_elect else None
        self._health_addr = health_addr
        self._health_server: Optional[http.server.ThreadingHTTPServer] = None
        # Post-leader-acquire / pre-controller-start hooks: they run only
        # once leadership is held — a standby must not probe the fabric —
        # and strictly before the first reconcile fires.
        self._startup_hooks: List[Callable[[], None]] = []
        # Observability plumbing: span sink + crash hooks (atexit /
        # unhandled thread exception -> flight-recorder + trace dump) are
        # registered once per process; the lifecycle watch runnable below
        # feeds per-CR phase timelines from this manager's store.
        lifecycle.install()

    def add_controller(self, controller: Controller) -> None:
        self._controllers.append(controller)

    def add_runnable(self, runnable: Runnable) -> None:
        self._runnables.append(runnable)

    def add_startup_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` after leader acquisition and before any controller
        starts. Hook failures are logged, not fatal: the reconcile-path
        safety nets (idempotent verbs, poll timers) still converge, just
        slower."""
        self._startup_hooks.append(hook)

    def ready(self) -> bool:
        return self._started

    @property
    def health_port(self) -> Optional[int]:
        if self._health_server is None:
            return None
        return self._health_server.server_address[1]

    def start(self, workers_per_controller: int = 1) -> None:
        if self._health_addr is not None:
            host, _, port = self._health_addr.rpartition(":")
            handler = type("BoundHealthHandler", (_HealthHandler,), {"manager": self})
            self._health_server = http.server.ThreadingHTTPServer(
                (host or "127.0.0.1", int(port)), handler
            )
            t = threading.Thread(
                target=self._health_server.serve_forever, name="health", daemon=True
            )
            t.start()
            self._threads.append(t)

        if self._elector is not None:
            self.log.info("waiting for leader lock %s", self._elector.lock_path)
            if not self._elector.acquire(stop_event=self._stop):
                return
            self.log.info("became leader")
            # Fencing enforcement: a deposed leader must stop driving the
            # fabric before the successor starts — client-go's analog exits
            # the process; we stop the manager and set lost_leadership so
            # the caller can exit non-zero (restart → rejoin as standby).
            t = threading.Thread(
                target=self._leadership_watchdog, name="leader-watchdog",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

        for hook in self._startup_hooks:
            try:
                hook()
            except Exception:
                self.log.exception(
                    "startup hook failed; relying on reconcile-path recovery"
                )

        # Lifecycle timelines: a watch-fed tracker records every CR state
        # transition (phase durations -> tpuc_phase_duration_seconds, the
        # /debug/requests timelines, and the flight recorder's ledger).
        t = threading.Thread(
            target=lifecycle.watch_runnable(self.store),
            args=(self._stop,),
            name="lifecycle-watch", daemon=True,
        )
        t.start()
        self._threads.append(t)

        for c in self._controllers:
            c.start(workers=workers_per_controller)
        for r in self._runnables:
            # Named after the runnable: an anonymous Thread-N says nothing
            # in a stack dump.
            t = threading.Thread(
                target=r, args=(self._stop,), daemon=True,
                name=_runnable_name(r),
            )
            t.start()
            self._threads.append(t)
        self._started = True

    def _leadership_watchdog(self) -> None:
        while not self._stop.wait(1.0):
            if not self._elector.is_leader:
                from tpu_composer_torch.runtime.metrics import (
                    lease_transitions_total,
                )

                self.log.error("leadership lost — stopping controllers")
                lease_transitions_total.inc(event="deposed")
                self.lost_leadership = True
                # stop() joins threads including this one; run it from a
                # helper thread to avoid self-join.
                threading.Thread(
                    target=self.stop, name="manager-stop", daemon=True
                ).start()
                return

    def stop(self) -> None:
        """Graceful stop: controllers first (their queues drain and their
        workers join), then the health server, the runnables and the
        lifecycle watch, then the leader lock; the span ring is persisted
        when ``$TPUC_TRACE_FILE`` is set."""
        self._stop.set()
        for c in self._controllers:
            c.stop()
        if self._health_server is not None:
            self._health_server.shutdown()
            self._health_server.server_close()
            self._health_server = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        if self._elector is not None:
            self._elector.release()
        self._started = False
        try:
            tracing.write_file()
        except OSError:
            self.log.warning("trace file write failed", exc_info=True)

    def wait(self) -> None:  # pragma: no cover - used by a command-line entry
        try:
            while not self._stop.wait(1.0):
                pass
        except KeyboardInterrupt:
            self.stop()
