"""Manager: owns the store, controllers, runnables and the health server
(port of ``tpu_composer/runtime/manager.py``: its core).

Reference analog: ctrl.NewManager + mgr.Start in cmd/main.go:137-218 —
controllers are registered, optional leader election gates startup, healthz/
readyz endpoints back the Deployment probes (config/manager/manager.yaml:73-85),
and a metrics endpoint serves Prometheus text.

The port keeps the controllers, the runnables, leader election (on a
lock file, or any elector passed as ``leader_elector=``: a
``runtime.leases.LeaseElector`` or a ``runtime.shards.ShardLeaseElector``),
the health server (``/healthz``, ``/readyz``, ``/metrics``, the trace and
lifecycle routes, the scheduler's observatory: ``/debug/defrag``,
``/debug/scheduler/explain/<name>``, ``/debug/scheduler/capacity`` and
``/debug/goodput``, the survival layer's ``/debug/overload``,
``/debug/watchdog``, ``/debug/storebreaker`` and ``/debug/profile*``, the
SLO engine's ``/debug/slo``, the fleet plane's ``/debug/fleet`` and the
lock-order witness's ``/debug/lockdep``), the
startup hooks, ``resync`` (the shard-acquisition hook), the replica
identity (``replica_id=``) that tags the dispatcher's, the controllers'
and the runnables' trace events, the always-on sampling profiler, the
SLO burn-rate engine (``slo_engine=``, a default one whenever the
profiler is on), the fleet plane (``fleet=``; its caller adds
``fleet.run`` as a runnable, as the JAX command line does), the
overload governor, the subsystem watchdog (whose restarter is
``_respawn_runnable``), the store breaker, the lifecycle recorder and the
graceful stop, which drains the fabric dispatcher's lanes first
(``dispatcher=``) and stops a ``CachedClient`` store's informers last,
and the dedicated metrics port (``metrics_addr=``: TLS from
``metrics_certfile=``/``metrics_keyfile=``, waiting for a cert that has
not landed yet, and a bearer token read from ``metrics_token_file=`` on
every scrape), with which the health port stops serving ``/metrics``.
"""

from __future__ import annotations

import hmac
import http.server
import json
import logging
import os
import threading
import urllib.parse
from typing import Callable, Dict, List, Optional

from tpu_composer_torch.runtime.controller import Controller
from tpu_composer_torch.runtime.events import EventRecorder
from tpu_composer_torch.runtime.leader import LeaderElector
from tpu_composer_torch.runtime import lifecycle, profiler as profiler_mod, tracing
from tpu_composer_torch.runtime.metrics import global_registry
from tpu_composer_torch.runtime.slo import SloEngine
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
    "/debug/slo": "SLO objectives with fast/slow burn rates and breach"
                  " state",
    "/debug/fleet": "cross-replica fleet view: live/stale replicas with"
                    " owned shards, fleet-merged latency percentiles and"
                    " fleet SLO burn rates (identical from whichever"
                    " replica you ask)",
    "/debug/profile": "on-demand stack profile burst"
                      " (?seconds=&format=top|collapsed|json)",
    "/debug/profile/continuous": "the always-on profiler's window ring:"
                                 " per-subsystem wall/CPU/GIL estimates +"
                                 " top frames",
    "/debug/lockdep": "lock-order witness state: acquisition-order graph"
                      " edges with first-seen stacks, declared orders and"
                      " any cycle (potential ABBA deadlock) reports"
                      " (503 unless --lockdep/TPUC_LOCKDEP=1)",
    "/debug/defrag": "defragmentation report: a fresh dry-run plan (never"
                     " executed) with per-candidate skip reasons, plus the"
                     " last periodic pass's record and breaker state",
    "/debug/scheduler/explain/<name>": "one CR's decision ring: every"
                      " placement / hold-back / preemption with inputs"
                      " digest, candidate verdicts, tiebreak rationale and"
                      " binding constraint (503 under TPUC_DECISIONS=0)",
    "/debug/scheduler/capacity": "capacity timeline: largest-placeable-"
                      "slice, free-chip distribution, fragmentation and"
                      " goodput samples on the observatory cadence",
    "/debug/goodput": "per-request goodput accounting: Ready-serving vs"
                      " queued/degraded/repairing/migrating wall seconds"
                      " and the fleet-local ratio",
    "/debug/overload": "overload governor state: Ok/Warn/Shed with the"
                       " signals behind the verdict, stretched cadences"
                       " and shed counts (503 under TPUC_OVERLOAD=0)",
    "/debug/watchdog": "subsystem heartbeat registry: last-beat age,"
                       " stall/restart counts per subsystem and the last"
                       " stall's profiler burst (503 under TPUC_WATCHDOG=0)",
    "/debug/storebreaker": "store circuit breaker: state, trips, outage"
                           " seconds and resync-pacing status (503 under"
                           " TPUC_STORE_BREAKER=0)",
}

# A runnable is the analog of manager.Add(RunnableFunc) used by the
# UpstreamSyncer (upstreamsyncer_controller.go:52-77): start(stop_event).
Runnable = Callable[[threading.Event], None]


def _runnable_name(r) -> str:
    """Stable thread name for a runnable: the owning class for bound
    methods (FabricDispatcher.run -> 'FabricDispatcher') and callable
    instances (UpstreamSyncer), the function name otherwise."""
    owner = getattr(r, "__self__", None)
    if owner is not None:
        return type(owner).__name__
    name = getattr(r, "__name__", "")
    if name and name not in ("<lambda>", "run"):
        return name
    return type(r).__name__


class _PlainTextHandler(http.server.BaseHTTPRequestHandler):
    """Shared response plumbing for the health and metrics handlers."""

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


class _HealthHandler(_PlainTextHandler):
    manager: "Manager"

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
            # With a dedicated (TLS/authenticated) metrics server
            # configured — even one still waiting for its cert — the plain
            # health port must not leak the same data.
            if self.manager._metrics_addr is not None:
                self._respond(404, "metrics served on the secure metrics port")
            else:
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
        elif path == "/debug/slo":
            eng = self.manager.slo_engine
            if eng is None:
                self._respond(503, "slo engine disabled (TPUC_PROFILE=0)")
            else:
                self._respond_json(
                    200, json.dumps(eng.snapshot(), indent=1).encode()
                )
        elif path == "/debug/fleet":
            fleet = self.manager.fleet
            if fleet is None:
                self._respond(503, "fleet plane disabled (TPUC_FLEET=0)")
            else:
                self._respond_json(
                    200, json.dumps(fleet.snapshot(), indent=1).encode()
                )
        elif path == "/debug/defrag":
            loop = self.manager.defrag
            if loop is None:
                self._respond(
                    503, "defrag loop not running (--defrag-interval 0)"
                )
            else:
                self._respond_json(
                    200, json.dumps(loop.report(), indent=1).encode()
                )
        elif path.startswith("/debug/scheduler/explain/"):
            # The decision ledger's per-CR ring: why this request landed
            # where it did / is still queued / preempted whom.
            led = self.manager.decisions
            if led is None:
                self._respond(
                    503, "decision ledger disabled (TPUC_DECISIONS=0)"
                )
            else:
                name = urllib.parse.unquote(
                    path[len("/debug/scheduler/explain/"):]
                )
                doc = led.explain(name)
                if doc is None:
                    self._respond(
                        404, f"no scheduler decisions recorded for {name!r}"
                    )
                else:
                    self._respond_json(
                        200, json.dumps(doc, indent=1).encode()
                    )
        elif path == "/debug/scheduler/capacity":
            cap = self.manager.capacity
            if cap is None:
                self._respond(
                    503, "capacity observatory disabled (TPUC_DECISIONS=0)"
                )
            else:
                self._respond_json(
                    200, json.dumps(cap.snapshot(), indent=1).encode()
                )
        elif path == "/debug/goodput":
            gp = self.manager.goodput
            if gp is None:
                self._respond(
                    503, "goodput accounting disabled (TPUC_DECISIONS=0)"
                )
            else:
                self._respond_json(
                    200, json.dumps(gp.snapshot(), indent=1).encode()
                )
        elif path == "/debug/overload":
            gov = self.manager.overload
            if gov is None:
                self._respond(
                    503, "overload governor disabled (TPUC_OVERLOAD=0)"
                )
            else:
                self._respond_json(
                    200, json.dumps(gov.snapshot(), indent=1).encode()
                )
        elif path == "/debug/watchdog":
            wd = self.manager.watchdog
            if wd is None:
                self._respond(503, "watchdog disabled (TPUC_WATCHDOG=0)")
            else:
                self._respond_json(
                    200, json.dumps(wd.snapshot(), indent=1).encode()
                )
        elif path == "/debug/storebreaker":
            brk = self.manager.storebreaker
            if brk is None:
                self._respond(
                    503, "store breaker disabled (TPUC_STORE_BREAKER=0)"
                )
            else:
                self._respond_json(
                    200, json.dumps(brk.snapshot(), indent=1).encode()
                )
        elif path == "/debug/profile/continuous":
            prof = self.manager.profiler
            if prof is None:
                self._respond(503, "profiler disabled (TPUC_PROFILE=0)")
            else:
                self._respond_json(200, json.dumps({
                    "interval_s": prof.interval,
                    "window_s": prof.window_s,
                    "windows": prof.windows(),
                    "summary": prof.thread_summary(),
                }, indent=1).encode())
        elif path == "/debug/profile":
            # On-demand burst profile on this handler thread (explicitly
            # requested, so it runs even under TPUC_PROFILE=0).
            self._profile_burst(query)
        elif path == "/debug/lockdep":
            from tpu_composer_torch.analysis import lockdep

            witness = lockdep.current()
            if witness is None:
                self._respond(
                    503, "lockdep witness disabled (--lockdep/TPUC_LOCKDEP=1)"
                )
            else:
                self._respond_json(
                    200, json.dumps(witness.snapshot(), indent=1).encode()
                )
        else:
            self._respond(404, "not found")

    def _profile_burst(self, query) -> None:
        try:
            seconds = float((query.get("seconds") or ["2"])[0])
        except ValueError:
            seconds = 2.0
        seconds = max(0.1, min(30.0, seconds))
        fmt = (query.get("format") or ["top"])[0]
        prof = profiler_mod.profile_burst(seconds=seconds)
        if fmt == "collapsed":
            # Flamegraph-folded text: pipe into flamegraph.pl / speedscope.
            self._respond(200, prof.collapsed())
        elif fmt == "json":
            self._respond_json(200, json.dumps({
                "seconds": seconds,
                "threads": prof.thread_summary(),
                "top": prof.top(25),
                "collapsed": prof.collapsed().splitlines(),
            }, indent=1).encode())
        else:  # top (default)
            self._respond_json(200, json.dumps({
                "seconds": seconds,
                "threads": prof.thread_summary(),
                "top": prof.top(25),
            }, indent=1).encode())

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


class _MetricsHandler(_PlainTextHandler):
    """Dedicated metrics endpoint with bearer-token authorization.

    The reference protects its metrics with controller-runtime's
    authn/authz filter (TokenReview + SubjectAccessReview delegation,
    cmd/main.go:120-127). The standalone analog: the scraper presents a
    bearer token matched against a mounted secret (re-read per request so
    rotation needs no restart); TLS comes from the per-connection-handshake
    server wrapper shared with the admission webhook."""

    manager: "Manager"
    token_file: Optional[str] = None

    def do_GET(self):  # noqa: N802
        if self.path != "/metrics":
            return self._respond(404, "not found")
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    expected = f.read().strip()
            except OSError:
                return self._respond(500, "metrics token file unreadable")
            presented = self.headers.get("Authorization", "")
            # Constant-time comparison: anything reaching this port must
            # not be able to recover the scrape secret through a timing
            # side channel.
            if not expected or not hmac.compare_digest(
                presented, f"Bearer {expected}"
            ):
                return self._respond(401, "unauthorized")
        self._respond(200, global_registry.expose_text())


class Manager:
    def __init__(
        self,
        store: Optional[Store] = None,
        leader_elect: bool = False,
        leader_lock_path: Optional[str] = None,
        leader_elector=None,  # custom elector (e.g. runtime.leases.LeaseElector)
        health_addr: Optional[str] = None,  # "host:port" or None to disable
        metrics_addr: Optional[str] = None,  # dedicated secure metrics port
        metrics_certfile: Optional[str] = None,
        metrics_keyfile: Optional[str] = None,
        metrics_token_file: Optional[str] = None,
        dispatcher=None,  # FabricDispatcher to drain at shutdown/handoff
        drain_timeout: float = 8.0,  # seconds; <= 0 disables graceful drain
        profiler=None,  # SamplingProfiler override (None = default when enabled)
        slo_engine=None,  # SloEngine override (None = defaults when enabled)
        replica_id: Optional[str] = None,  # fleet identity for trace pids
        fleet=None,  # runtime.fleet.FleetPlane serving /debug/fleet
        defrag=None,  # scheduler.DefragLoop serving /debug/defrag
        decisions=None,  # scheduler.DecisionLedger serving explain routes
        capacity=None,  # runtime.capacity.CapacityObservatory
        goodput=None,  # runtime.goodput.GoodputTracker
        overload=None,  # runtime.overload.OverloadGovernor
        watchdog=None,  # runtime.watchdog.Watchdog
        storebreaker=None,  # runtime.storebreaker.BreakingStore
    ) -> None:
        # `is not None`, not `or`: an EMPTY store is falsy (Store.__len__),
        # and silently swapping in a fresh one would orphan the caller's
        # admission hooks and persistence settings.
        self.store = store if store is not None else Store()
        # The handle may be a runtime.cache.CachedClient (the watch-fed
        # informer facade): the manager owns its lifecycle and stops the
        # informer threads on shutdown.
        self.recorder = EventRecorder()
        self.log = logging.getLogger("manager")
        self._controllers: List[Controller] = []
        self._runnables: List[Runnable] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        #: set when a running leader loses its lease (the caller exits non-zero)
        self.lost_leadership = False
        self._elector = leader_elector or (
            LeaderElector(leader_lock_path) if leader_elect else None
        )
        self._health_addr = health_addr
        self._health_server: Optional[http.server.ThreadingHTTPServer] = None
        self._metrics_addr = metrics_addr
        self._metrics_certfile = metrics_certfile
        self._metrics_keyfile = metrics_keyfile
        self._metrics_token_file = metrics_token_file
        self._metrics_server: Optional[http.server.ThreadingHTTPServer] = None
        self._dispatcher = dispatcher
        self._drain_timeout = drain_timeout
        # Fleet observatory plumbing: the replica identity tags every
        # trace event recorded by this manager's threads (controller
        # workers, dispatcher lanes, runnables) with a stable pseudo-pid,
        # so N in-proc replicas sharing one trace ring still render — and
        # merge — as N distinct Perfetto processes, exactly like real OS
        # replicas do via their real pids. None (the default) changes
        # nothing: events keep plain os.getpid().
        self.replica_id = replica_id
        self.fleet = fleet
        # Defrag loop handle for /debug/defrag (dry-run plan + skip
        # reasons); None = loop not wired.
        self.defrag = defrag
        # Decision observatory handles (all None under TPUC_DECISIONS=0):
        # the scheduler's decision ledger (/debug/scheduler/explain/*),
        # the capacity timeline sampler (/debug/scheduler/capacity) and
        # the goodput tracker (/debug/goodput; its lifecycle transition
        # sink is unregistered at stop()).
        self.decisions = decisions
        self.capacity = capacity
        self.goodput = goodput
        # Survival-layer handles (all None under their TPUC_*=0 hatches):
        # the overload governor (/debug/overload), the subsystem watchdog
        # (/debug/watchdog) and the store circuit breaker
        # (/debug/storebreaker).
        self.overload = overload
        self.watchdog = watchdog
        self.storebreaker = storebreaker
        if watchdog is not None:
            # A stalled RESTARTABLE runnable is respawned through this
            # hook: the old thread is abandoned (daemon, unjoinable while
            # wedged) and a fresh one takes over its name. Unknown names
            # (nothing started yet) just return False.
            watchdog.restarter = self._respawn_runnable
        #: runnable-name -> runnable, built by start(); the watchdog's
        #: respawn hook resolves restart targets through it.
        self._runnable_by_name: Dict[str, Runnable] = {}
        # Post-leader-acquire / pre-controller-start hooks (cold-start
        # adoption of durable fabric intents, controllers/adoption.py):
        # they run only once leadership is held — a standby must not probe
        # the fabric — and strictly before the first reconcile fires.
        self._startup_hooks: List[Callable[[], None]] = []
        # Observability plumbing: span sink + crash hooks (atexit /
        # unhandled thread exception -> flight-recorder + trace dump) are
        # registered once per process; the lifecycle watch runnable below
        # feeds per-CR phase timelines from this manager's store.
        lifecycle.install()
        # Control-plane observatory (always-on by default, TPUC_PROFILE=0
        # escape hatch): the sampling profiler and the SLO burn-rate
        # engine run as manager-owned threads; /debug/profile* and
        # /debug/slo on the health port read them.
        if profiler is not None:
            self.profiler = profiler
        else:
            self.profiler = (
                profiler_mod.SamplingProfiler()
                if profiler_mod.enabled() else None
            )
        if slo_engine is not None:
            self.slo_engine = slo_engine
        else:
            self.slo_engine = (
                SloEngine(recorder=self.recorder)
                if profiler_mod.enabled() else None
            )

    def _bound(self, target):
        """Wrap a thread target so the thread tags its trace events with
        this manager's replica identity before running (no-op unbound)."""
        if not self.replica_id:
            return target
        rid = self.replica_id

        def run(*args, **kwargs):
            tracing.bind_thread(rid)
            return target(*args, **kwargs)

        return run

    def add_controller(self, controller: Controller) -> None:
        self._controllers.append(controller)

    def add_runnable(self, runnable: Runnable) -> None:
        self._runnables.append(runnable)

    def add_startup_hook(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` after leader acquisition and before any controller
        starts (the cold-start adoption slot). Hook failures are logged,
        not fatal: the reconcile-path safety nets (idempotent verbs, poll
        timers, the syncer) still converge, just slower."""
        self._startup_hooks.append(hook)

    def resync(self, match: Callable[[str], bool]) -> None:
        """Re-enqueue every primary object whose key ``match`` accepts into
        its controller's work queue. The shard-acquisition hook: a shard
        picked up AFTER startup has no watch events pending for its
        objects, so the new owner must level-trigger a reconcile wave over
        the moved keys (the in-process analog of a cache resync)."""
        for c in self._controllers:
            if not c.primary_kind:
                continue
            try:
                cls = self.store.scheme.lookup(c.primary_kind)
                for obj in self.store.list(cls):
                    if match(obj.metadata.name):
                        c.queue.add(obj.metadata.name)
            except Exception:
                self.log.exception(
                    "resync of %s failed; poll timers will converge",
                    c.primary_kind,
                )

    def ready(self) -> bool:
        return self._started

    @property
    def health_port(self) -> Optional[int]:
        if self._health_server is None:
            return None
        return self._health_server.server_address[1]

    @property
    def metrics_port(self) -> Optional[int]:
        if self._metrics_server is None:
            return None
        return self._metrics_server.server_address[1]

    def _start_metrics_server(self) -> None:
        from tpu_composer_torch.admission.server import (
            _TlsPerConnectionServer,
            make_server_tls_context,
        )

        host, _, port = self._metrics_addr.rpartition(":")  # type: ignore[union-attr]
        handler = type(
            "BoundMetricsHandler",
            (_MetricsHandler,),
            {"manager": self, "token_file": self._metrics_token_file},
        )
        server = _TlsPerConnectionServer((host or "127.0.0.1", int(port)), handler)
        if self._metrics_certfile:
            server.ssl_context = make_server_tls_context(
                self._metrics_certfile, self._metrics_keyfile
            )
        self._metrics_server = server
        t = threading.Thread(target=server.serve_forever, name="metrics",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _serve_metrics_when_cert_lands(self) -> None:
        """cert-manager writes the serving cert AFTER the pod starts (the
        secret mount is optional) — same dance as the webhook server in
        cmd/main. Crashing on the missing file would crash-loop every
        fresh install until the issuer caught up."""
        warned = False
        while not os.path.exists(self._metrics_certfile):  # type: ignore[arg-type]
            if not warned:
                self.log.warning(
                    "waiting for metrics cert %s", self._metrics_certfile
                )
                warned = True
            if self._stop.wait(2.0):
                return
        self._start_metrics_server()

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
        if self._metrics_addr is not None:
            if self._metrics_certfile and not os.path.exists(self._metrics_certfile):
                t = threading.Thread(
                    target=self._serve_metrics_when_cert_lands,
                    name="metrics-cert-wait", daemon=True,
                )
                t.start()
                self._threads.append(t)
            else:
                self._start_metrics_server()

        if self._elector is not None:
            self.log.info("waiting for leader lock %s", self._elector.lock_path)
            if not self._elector.acquire(stop_event=self._stop):
                return
            self.log.info("became leader")
            # Fencing enforcement: leadership can be LOST after start (a
            # LeaseElector that fails to renew through a partition stands
            # down). A deposed leader must stop driving the fabric before
            # the successor starts — client-go's analog exits the process;
            # we stop the manager and set lost_leadership so the caller
            # can exit non-zero (restart → rejoin as standby).
            t = threading.Thread(
                target=self._leadership_watchdog, name="leader-watchdog",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

        # Cold-start adoption window: leadership (if any) is held, no
        # controller worker is running yet — in-flight fabric intents from
        # the previous incarnation are classified and resolved here so the
        # first reconcile wave starts from reconstructed state.
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
            target=self._bound(lifecycle.watch_runnable(self.store)),
            args=(self._stop,),
            name="lifecycle-watch", daemon=True,
        )
        t.start()
        self._threads.append(t)

        # Observatory: the always-on stack sampler and the SLO burn-rate
        # evaluator (both absent under TPUC_PROFILE=0).
        if self.profiler is not None:
            t = threading.Thread(
                target=self.profiler.run, args=(self._stop,),
                name="profiler", daemon=True,
            )
            t.start()
            self._threads.append(t)
        if self.slo_engine is not None:
            t = threading.Thread(
                target=self.slo_engine.run, args=(self._stop,),
                name="slo-engine", daemon=True,
            )
            t.start()
            self._threads.append(t)

        # Tag the dispatcher BEFORE any controller starts: a controller
        # worker's first submission lazily spawns the lane threads, and a
        # lane that spawns before the tag lands would record untagged pids
        # for the rest of the process.
        if self.replica_id and self._dispatcher is not None:
            if getattr(self._dispatcher, "replica_id", None) is None:
                self._dispatcher.replica_id = self.replica_id
        for c in self._controllers:
            # Controller worker/dispatch threads bind the replica identity
            # themselves (runtime/controller.py) — the attribute survives
            # stop/start cycles the way a wrapped target would not.
            if self.replica_id and getattr(c, "replica_id", None) is None:
                c.replica_id = self.replica_id
            c.start(workers=workers_per_controller)
        for r in self._runnables:
            # Named after the runnable (UpstreamSyncer, FabricDispatcher,
            # FabricSession, ...): the profiler attributes samples by
            # thread name, and an anonymous Thread-N would land every
            # runnable in its 'other' bucket.
            name = _runnable_name(r)
            self._runnable_by_name[name] = r
            t = threading.Thread(
                target=self._bound(r), args=(self._stop,), daemon=True,
                name=name,
            )
            t.start()
            self._threads.append(t)
        self._started = True

    def _respawn_runnable(self, name: str) -> bool:
        """Watchdog respawn hook: start a fresh thread for the runnable
        registered under ``name``. The wedged thread is left behind — it
        is a daemon, and joining it would wedge the watchdog too."""
        r = self._runnable_by_name.get(name)
        if r is None or self._stop.is_set():
            return False
        t = threading.Thread(
            target=self._bound(r), args=(self._stop,), daemon=True, name=name
        )
        t.start()
        self._threads.append(t)
        self.log.warning("respawned runnable %s after watchdog stall", name)
        return True

    def _leadership_watchdog(self) -> None:
        while not self._stop.wait(1.0):
            if not self._elector.is_leader:
                from tpu_composer_torch.runtime.metrics import (
                    lease_transitions_total,
                )

                self.log.error("leadership lost — stopping controllers")
                lease_transitions_total.inc(event="deposed")
                self.lost_leadership = True
                # Exactly once per deposition: the watchdog fires a single
                # time and returns (a ShardLeaseElector never trips it —
                # shard losses fence per-shard, not per-process).
                # stop() joins threads including this one; run it from a
                # helper thread to avoid self-join.
                threading.Thread(
                    target=self.stop, name="manager-stop", daemon=True
                ).start()
                return

    def stop(self) -> None:
        """Graceful stop: the dispatcher's drain, then the controllers
        (their queues drain and their workers join), the health server,
        the runnables and the lifecycle watch, the goodput tracker's sink,
        a ``CachedClient`` store's informers, then the leader lock or
        lease; the span ring is persisted when ``$TPUC_TRACE_FILE`` is
        set."""
        # Graceful drain BEFORE anything is torn down: the controllers
        # must stay live while lanes flush, because completions re-enqueue
        # CR keys and those reconciles are what persist outcomes. Skipped
        # when leadership was LOST (fencing: a deposed leader must stop
        # driving the fabric immediately — queued ops are abandoned and
        # the successor's adoption pass re-derives them from durable
        # intent) and on re-entrant stop calls.
        if (
            self._dispatcher is not None
            and self._drain_timeout > 0
            and self._started
            and not self.lost_leadership
            # Live leadership check, not just the watchdog flag: the
            # watchdog polls on a period, so a lease that expired
            # moments ago may not have set lost_leadership yet — and a
            # deposed leader draining for up to drain_timeout while the
            # successor adopts is exactly the double-driving window
            # fencing must close.
            and (self._elector is None or self._elector.is_leader)
            and not self._stop.is_set()
        ):
            from tpu_composer_torch.runtime.metrics import (
                dispatcher_drains_total,
            )

            drained = self._dispatcher.drain(self._drain_timeout)
            dispatcher_drains_total.inc(
                outcome="clean" if drained else "timeout"
            )
            if not drained:
                self.log.warning(
                    "dispatcher drain exceeded %.1fs; in-flight intents"
                    " recover via adoption on the next start",
                    self._drain_timeout,
                )
                # A drain timeout is a crash-shaped exit: leave the black
                # box behind (flight ledger + trace ring, both env-gated)
                # so the operator can see WHAT was still in flight.
                lifecycle.dump_crash("drain-timeout")
        self._stop.set()
        for c in self._controllers:
            c.stop()
        if self._health_server is not None:
            self._health_server.shutdown()
            self._health_server.server_close()
            self._health_server = None
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
            self._metrics_server = None
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        # Unregister the goodput tracker's lifecycle sink: the sink list
        # is process-global, and a test cycling managers must not
        # accumulate dead trackers behind every later transition.
        if self.goodput is not None:
            lifecycle.remove_transition_sink(self.goodput.observe)
        # Informer shutdown AFTER the controllers: their stop() paths may
        # still read through the cache, and the store watches the informers
        # hold must unsubscribe before the process exits.
        stop_informers = getattr(self.store, "stop_informers", None)
        if callable(stop_informers):
            stop_informers()
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
