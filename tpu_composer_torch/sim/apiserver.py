"""In-process kube-apiserver fake speaking the real K8s wire protocol (port
of ``tpu_composer/sim/apiserver.py``).

The envtest analog for this repo: the reference runs every controller suite
against a real kube-apiserver+etcd spun up per suite
(internal/controller/suite_test.go:357-385). We get the same
fidelity boundary — controllers talk HTTP/JSON to a server enforcing apiserver
semantics — without vendoring the binaries: this server implements

- typed REST: POST/GET/PUT/DELETE on ``/apis/<group>/<version>/<plural>``
  and ``/api/v1/nodes`` (core group);
- the status subresource (``PUT .../status`` only persists status);
- optimistic concurrency: stale ``resourceVersion`` → 409 Conflict,
  duplicate create → 409 AlreadyExists (Status body with ``reason`` set the
  way apimachinery does);
- finalizer-gated deletion: DELETE with finalizers present marks
  ``deletionTimestamp``; a PUT removing the last finalizer purges;
- spec-change generation bump; system-owned uid/creationTimestamp;
- ``?labelSelector=`` equality filtering on lists;
- ``?watch=true`` chunked streaming watches with ``resourceVersion``
  resume and JSON-per-line events, ADDED/MODIFIED/DELETED;
- the ``tpuc-mux/1`` framed transport (``GET /mux`` + Upgrade): every verb
  and watch of one client multiplexed over a single socket as
  length-prefixed JSON frames (runtime/wiremux.py defines the protocol),
  served alongside plain HTTP by the same verb plane.

It is launchable as a standalone shared store:

    python -m tpu_composer_torch.sim.apiserver --nodes 8 --url-file api.json

Concurrency contract (multi-process hardening): state is sharded per kind —
each path prefix owns a ``_KindState`` with its own lock, objects, watch
fanout, and bounded event log — so replicas writing different kinds never
serialize on each other (a single lock would make the sim the fleet's
scaling ceiling). Within one kind, every rv allocation, object
mutation, and watch-event publication happens under that kind's lock, so
the per-kind event log is totally ordered by rv no matter how many client
processes write in parallel; a CAS PUT observes-and-replaces atomically
(lost updates are impossible — one of two racing writers gets 409
Conflict). resourceVersions still come from one global monotonic counter
(its own small leaf lock), so rvs stay comparable across kinds exactly as
one etcd revision counter serves all keys. The listen backlog is sized for
whole fleets of replicas dialing at once.

Used by the port's kubestore twins for the operator on a cluster-shaped
API, and by ``chip_smoke.py``'s ``operator_fleet`` phase as the store the
H100's replicas share over the ``tpuc-mux/1`` wire.
"""

from __future__ import annotations

import base64
import collections
import json
import ssl
import sys
import threading
import time
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Deque, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from tpu_composer_torch.runtime import wiremux

#: Listen backlog. ThreadingHTTPServer's default request_queue_size of 5 is
#: tuned for one polite in-process client; a 4-replica proc fleet (each with
#: per-kind reflectors, lease renewers, and reconcile workers opening fresh
#: connections) can burst far past it and see ECONNREFUSED. Real apiservers
#: listen deep; so do we.
_LISTEN_BACKLOG = 128

#: Rolling cap on the wire-level request log. The log exists for
#: cache-efficiency assertions in unit tests (thousands of entries at most);
#: under a macro-scale churn bench it would otherwise grow without bound.
_REQUEST_LOG_CAP = 100_000

#: Verb workers per mux connection. Frames pipeline from every controller
#: thread of one replica; handling them serially would stack the injected
#: latency_s (the RTT model) request-by-request and erase the pipelining the
#: transport exists for. Sixteen matches a replica's plausible concurrent
#: verb count (reconcile workers + lease + telemetry + syncer).
_MUX_VERB_WORKERS = 16


def _apply_jsonpatch(obj: Dict[str, Any], patch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Minimal RFC 6902 apply (add/replace/remove) — what a real apiserver
    does with a mutating webhook's JSONPatch response."""
    out = json.loads(json.dumps(obj))
    for op in patch:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].lstrip("/").split("/")]
        parent = out
        for p in parts[:-1]:
            parent = parent[int(p)] if isinstance(parent, list) else parent.setdefault(p, {})
        leaf = parts[-1]
        if op["op"] in ("add", "replace"):
            if isinstance(parent, list):
                if leaf == "-":
                    parent.append(op["value"])
                else:
                    parent.insert(int(leaf), op["value"]) if op["op"] == "add" \
                        else parent.__setitem__(int(leaf), op["value"])
            else:
                parent[leaf] = op["value"]
        elif op["op"] == "remove":
            if isinstance(parent, list):
                parent.pop(int(leaf))
            else:
                parent.pop(leaf, None)
        else:
            raise ValueError(f"unsupported JSONPatch op {op['op']!r}")
    return out


def _status_doc(code: int, reason: str, message: str) -> Dict[str, Any]:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "code": code,
        "reason": reason,
        "message": message,
    }


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps(_status_doc(code, reason, message)).encode()


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a fleet-sized accept queue."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = _LISTEN_BACKLOG

    def handle_error(self, request, client_address):  # pragma: no cover
        # A SIGKILLed replica (proc-mode failover tests) tears down its
        # sockets mid-response; the resulting BrokenPipe/ConnectionReset in
        # the handler thread is expected churn, not a server bug. Everything
        # else keeps the stock stderr traceback.
        exc = sys.exc_info()[1]
        if isinstance(exc, ConnectionError):
            return
        super().handle_error(request, client_address)


class _KindState:
    """One kind's shard of the 'etcd': its own lock, objects by name, watch
    fanout, and a bounded event log with a per-kind compaction horizon."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.objects: Dict[str, Dict[str, Any]] = {}
        # watch subscribers: (buffer, condition) pairs
        self.watchers: List[Tuple[List[Dict[str, Any]], threading.Condition]] = []
        # True event history, exactly as etcd's WAL serves watch resumes:
        # (rv, type, object). A resume within the horizon replays real
        # events — including DELETED, which a current-state replay could
        # never produce.
        self.event_log: List[Tuple[int, str, Dict[str, Any]]] = []
        # Watches resuming from rv <= compacted_rv are answered with an
        # ERROR event carrying a 410 Status, like a compacted etcd.
        self.compacted_rv = 0


class _ObjectsView:
    """(prefix, name)-keyed dict facade over the per-kind shards.

    Harness code (tests, pollers, shard/intent scans) reads and mutates ``state.objects`` as one flat
    dict; this view keeps that surface while each operation takes only the
    touched shard's lock. ``items()`` is a cross-shard snapshot — each
    shard internally consistent, shards read in sequence."""

    _MISSING = object()

    def __init__(self, state: "_State") -> None:
        self._state = state

    def items(self) -> List[Tuple[Tuple[str, str], Dict[str, Any]]]:
        out: List[Tuple[Tuple[str, str], Dict[str, Any]]] = []
        for prefix, ks in self._state.kinds():
            with ks.lock:
                out.extend(
                    ((prefix, name), obj)
                    for name, obj in sorted(ks.objects.items())
                )
        return out

    def keys(self) -> List[Tuple[str, str]]:
        return [k for k, _ in self.items()]

    def values(self) -> List[Dict[str, Any]]:
        return [v for _, v in self.items()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        total = 0
        for _, ks in self._state.kinds():
            with ks.lock:
                total += len(ks.objects)
        return total

    def get(self, key: Tuple[str, str], default: Any = None) -> Any:
        prefix, name = key
        ks = self._state.kind(prefix)
        with ks.lock:
            return ks.objects.get(name, default)

    def __getitem__(self, key: Tuple[str, str]) -> Dict[str, Any]:
        out = self.get(key, self._MISSING)
        if out is self._MISSING:
            raise KeyError(key)
        return out

    def __contains__(self, key: Tuple[str, str]) -> bool:
        return self.get(key, self._MISSING) is not self._MISSING

    def __setitem__(self, key: Tuple[str, str], obj: Dict[str, Any]) -> None:
        prefix, name = key
        ks = self._state.kind(prefix)
        with ks.lock:
            ks.objects[name] = obj

    def __delitem__(self, key: Tuple[str, str]) -> None:
        prefix, name = key
        ks = self._state.kind(prefix)
        with ks.lock:
            del ks.objects[name]

    def pop(self, key: Tuple[str, str], *default: Any) -> Any:
        prefix, name = key
        ks = self._state.kind(prefix)
        with ks.lock:
            return ks.objects.pop(name, *default)


class _State:
    """The 'etcd' — one global rv counter over per-kind shards, each with
    its own objects, watch fanout, and bounded event log (real etcd
    compacts; a watch resuming from before the horizon gets 410 Expired).

    ``lock`` survives as the legacy coarse lock: external harnesses hold it
    around multi-step reads of ``objects``; the server's own verb paths use
    only the per-kind shard locks (that coarse lock serializing all
    replicas would be the proc-scaling ceiling)."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._rv_lock = threading.Lock()
        self._rv = 0
        self._kinds: Dict[str, _KindState] = {}
        self._kinds_lock = threading.Lock()
        # (path_prefix, name)-keyed dict facade over the shards
        self.objects = _ObjectsView(self)

    @property
    def rv(self) -> int:
        return self._rv

    def kind(self, prefix: str) -> _KindState:
        with self._kinds_lock:
            ks = self._kinds.get(prefix)
            if ks is None:
                ks = self._kinds[prefix] = _KindState()
            return ks

    def kinds(self) -> List[Tuple[str, _KindState]]:
        with self._kinds_lock:
            return sorted(self._kinds.items())

    def next_rv(self) -> int:
        # Leaf lock (kind lock → rv lock): rvs stay globally comparable
        # across shards, like one etcd revision counter over all keys.
        with self._rv_lock:
            self._rv += 1
            return self._rv

    def notify(self, prefix: str, etype: str, obj: Dict[str, Any]) -> None:
        """Publish one event. Caller holds ``kind(prefix).lock`` — that is
        what totally orders the kind's event log by rv. ONE immutable
        snapshot is shared by the event log and every watcher buffer:
        nothing mutates a published event, so the per-watcher deep-copy
        the pre-proc fake did was O(watchers × object) for nothing."""
        ks = self.kind(prefix)
        snapshot = json.loads(json.dumps(obj))
        event = {"type": etype, "object": snapshot}
        ks.event_log.append(
            (int(snapshot["metadata"]["resourceVersion"]), etype, snapshot)
        )
        if len(ks.event_log) > 10_000:
            # Rolling auto-compaction, like etcd's: dropping history moves
            # the 410 horizon forward, so long soaks stay bounded and
            # clients resuming from far behind get the Expired persona.
            dropped = ks.event_log[:5_000]
            ks.event_log = ks.event_log[5_000:]
            ks.compacted_rv = max(ks.compacted_rv, dropped[-1][0])
        for buf, cond in list(ks.watchers):
            with cond:
                buf.append(event)
                cond.notify_all()

    def compact(self, up_to_rv: Optional[int] = None) -> None:
        """Discard event history ≤ up_to_rv (default: everything so far)
        in every shard. The next watch resume from inside the discarded
        range gets 410."""
        horizon = self._rv if up_to_rv is None else up_to_rv
        for _, ks in self.kinds():
            with ks.lock:
                ks.compacted_rv = max(ks.compacted_rv, horizon)
                ks.event_log = [e for e in ks.event_log if e[0] > horizon]


class FakeApiServer:
    """HTTP + mux kube-apiserver fake. ``resources`` maps path prefixes to
    config:

        {"/apis/tpu.composer.dev/v1alpha1/composabilityrequests":
             {"kind": "ComposabilityRequest"}, ...}

    Start with ``start()``; ``url`` gives the base endpoint. Objects can be
    seeded/inspected directly via ``put_object``/``get_object`` (the tests'
    equivalent of kubectl).
    """

    def __init__(self, resources: Dict[str, Dict[str, Any]]) -> None:
        self.resources = resources
        self.state = _State()
        self.fail_hooks: List[Any] = []  # callables (method, path) -> Optional[(code, reason, msg)]
        # Wire-level request log [(method, path)] — the envtest-style probe
        # for how chatty a client is (cache-efficiency assertions). Mux
        # verbs log the same (method, path) strings as HTTP ones, so the
        # assertions hold on either transport. Bounded: a macro-scale churn
        # run would otherwise hold every request ever.
        self.request_log: Deque[Tuple[str, str]] = collections.deque(
            maxlen=_REQUEST_LOG_CAP
        )
        # Admission webhook registrations, called out over the wire exactly
        # as a real apiserver would (the envtest WebhookInstallOptions
        # analog — the reference's internal/webhook/v1alpha1/
        # webhook_suite_test.go:74-144). Each entry:
        #   {"prefix": <resource path prefix>, "url": <webhook endpoint>,
        #    "operations": {"CREATE", "UPDATE"}}
        # A denied review fails the API call with 403; a JSONPatch response
        # is applied to the object before it is stored.
        self.webhooks: List[Dict[str, Any]] = []
        # Injected per-request latency (seconds) — models apiserver RTT for
        # latency benchmarks. Applied once per request on either transport
        # (streaming watch events after connect are push, not
        # request/response).
        self.latency_s: float = 0.0
        # Live streaming-watch sockets, for the socket-kill persona
        # (kill_watch_connections): a mid-stream TCP reset is how real
        # apiserver restarts/LB failovers present to client watches. A mux
        # connection carrying watches registers here too — killing it takes
        # the verbs down with the watches, exactly like an LB failover.
        self.active_watch_conns: List[Any] = []
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # TCP_NODELAY, like the real apiserver (Go's net stack enables
            # it on every accepted conn). Without it, keep-alive clients
            # stall ~40ms per request: the handler writes response headers
            # and body as separate small sends, and Nagle holds the second
            # until the client's delayed ACK — invisible on one-shot
            # connections, a 1.4x attach-p50 tax on pooled ones.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet
                pass

            def _deny(self, code: int, reason: str, message: str) -> None:
                self._send(code, _status_doc(code, reason, message))

            def _ok(self, payload: Dict[str, Any], code: int = 200) -> None:
                self._send(code, payload)

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _maybe_fail(self) -> bool:
                out = server._check_fail(self.command, self.path)
                if out:
                    self._deny(*out)
                    return True
                return False

            # ---- verbs (thin shims over the shared verb plane) ----
            def do_GET(self) -> None:
                if urlparse(self.path).path == wiremux.MUX_PATH:
                    return self._mux_session()
                if self._maybe_fail():
                    return
                routed = server._route_path(self.path)
                if not routed:
                    return self._deny(404, "NotFound", f"no route {self.path}")
                prefix, name, cfg, _ = routed
                qs = parse_qs(urlparse(self.path).query)
                if not name and qs.get("watch", ["false"])[0] == "true":
                    return self._watch(prefix, qs)
                code, payload = server.handle_verb("GET", self.path, None)
                self._send(code, payload)

            def _watch(self, prefix: str, qs: Dict[str, List[str]]) -> None:
                st = server.state
                ks = st.kind(prefix)
                since = int(qs.get("resourceVersion", ["0"])[0] or 0)
                buf, cond, expired = server._subscribe(prefix, since)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def _write(evt: Dict[str, Any]) -> None:
                    line = (json.dumps(evt) + "\n").encode()
                    self.wfile.write(f"{len(line):x}\r\n".encode())
                    self.wfile.write(line + b"\r\n")

                if expired is not None:
                    try:
                        _write(expired)
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        pass
                    return
                with st.lock:
                    server.active_watch_conns.append(self.connection)
                try:
                    while not getattr(server, "_shutdown", False):
                        with cond:
                            if not buf:
                                cond.wait(timeout=0.5)
                            events, buf[:] = list(buf), []
                        for evt in events:
                            _write(evt)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    with ks.lock:
                        ks.watchers = [
                            w for w in ks.watchers if w[0] is not buf
                        ]
                    with st.lock:
                        try:
                            server.active_watch_conns.remove(self.connection)
                        except ValueError:
                            pass

            def _read_body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_POST(self) -> None:
                body = self._read_body()
                if self._maybe_fail():
                    return
                code, payload = server.handle_verb("POST", self.path, body)
                self._send(code, payload)

            def do_PUT(self) -> None:
                body = self._read_body()
                if self._maybe_fail():
                    return
                code, payload = server.handle_verb("PUT", self.path, body)
                self._send(code, payload)

            def do_DELETE(self) -> None:
                if self._maybe_fail():
                    return
                code, payload = server.handle_verb("DELETE", self.path, None)
                self._send(code, payload)

            # ---- tpuc-mux/1 framed transport ----
            def _mux_session(self) -> None:
                """Upgrade this connection to framed mode and serve it until
                EOF: verbs pipeline through a small worker pool, each watch
                gets a dedicated pusher thread (the HTTP equivalent is one
                handler thread per watch connection). All response and push
                frames serialize on one write lock."""
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", wiremux.PROTOCOL)
                self.send_header("Connection", "Upgrade")
                self.end_headers()
                self.wfile.flush()
                self.close_connection = True
                conn = self.connection
                wlock = threading.Lock()
                watch_stops: Dict[int, threading.Event] = {}
                pool = ThreadPoolExecutor(
                    max_workers=_MUX_VERB_WORKERS, thread_name_prefix="mux-verb"
                )

                def send(frame: Dict[str, Any]) -> None:
                    data = wiremux.encode_frame(frame)
                    with wlock:
                        conn.sendall(data)

                try:
                    while not getattr(server, "_shutdown", False):
                        frame = wiremux.read_frame(self.rfile)
                        if frame is None:
                            break
                        if "ping" in frame:
                            # Liveness probe: answered inline on the read
                            # loop, never through the verb pool, so pongs
                            # measure the wire — not modeled apiserver
                            # latency or fail-hook personas.
                            send({"pong": frame["ping"]})
                            continue
                        if "cancel" in frame:
                            stop = watch_stops.get(frame["cancel"])
                            if stop is not None:
                                stop.set()
                            continue
                        rid = frame.get("id")
                        method = frame.get("method", "GET")
                        path = frame.get("path", "")
                        qs = parse_qs(urlparse(path).query)
                        is_watch = (
                            method == "GET"
                            and qs.get("watch", ["false"])[0] == "true"
                        )
                        routed = server._route_path(path) if is_watch else None
                        if is_watch and routed and not routed[1]:
                            stop = threading.Event()
                            watch_stops[rid] = stop
                            threading.Thread(
                                target=server._mux_watch,
                                args=(rid, path, routed[0], send, stop, conn),
                                daemon=True,
                                name=f"mux-watch-{rid}",
                            ).start()
                        else:
                            pool.submit(
                                server._mux_verb, rid, method, path,
                                frame.get("body"), send,
                            )
                except (wiremux.MuxError, OSError, ValueError):
                    pass  # truncated/corrupt peer or dead socket: drop session
                finally:
                    for stop in watch_stops.values():
                        stop.set()
                    pool.shutdown(wait=False)

        self._handler_cls = Handler
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False

    # ------------------------------------------------------------------
    # shared verb plane (HTTP handlers and the mux endpoint both call in)
    # ------------------------------------------------------------------
    @staticmethod
    def _status(code: int, reason: str, message: str) -> Tuple[int, Dict[str, Any]]:
        return code, _status_doc(code, reason, message)

    def _check_fail(
        self, method: str, path: str
    ) -> Optional[Tuple[int, str, str]]:
        """Request-log + injected latency + fail-hook personas. Runs once
        per request on either transport, with identical (method, path)
        strings — so request-counting assertions and path-matching hooks
        (watch_blocker) can't tell mux from HTTP."""
        self.request_log.append((method, path))
        if self.latency_s:
            time.sleep(self.latency_s)
        # Snapshot: hooks are armed/disarmed from other threads (and,
        # proc-mode, while many handler threads are in here).
        for hook in list(self.fail_hooks):
            out = hook(method, path)
            if out:
                return out
        return None

    def _route_path(
        self, path: str
    ) -> Optional[Tuple[str, Optional[str], Dict[str, Any], bool]]:
        """→ (prefix, name|None, resource_cfg, is_status)"""
        parsed = urlparse(path)
        p = unquote(parsed.path).rstrip("/")
        for prefix, cfg in self.resources.items():
            if p == prefix:
                return prefix, None, cfg, False
            if p.startswith(prefix + "/"):
                rest = p[len(prefix) + 1 :]
                if rest.endswith("/status"):
                    return prefix, rest[: -len("/status")], cfg, True
                if "/" not in rest:
                    return prefix, rest, cfg, False
        return None

    def _admit(
        self,
        prefix: str,
        operation: str,
        obj: Dict[str, Any],
        old: Optional[Dict[str, Any]],
    ) -> Tuple[Optional[Dict[str, Any]], Optional[Tuple[int, Dict[str, Any]]]]:
        """Run registered webhooks over the wire. Returns (patched object,
        None) on admission, (None, (code, status)) on denial/failure."""
        for hook in list(self.webhooks):
            if hook["prefix"] != prefix:
                continue
            if operation not in hook.get("operations", {"CREATE", "UPDATE"}):
                continue
            review = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": str(uuid.uuid4()),
                    "operation": operation,
                    "object": obj,
                    "oldObject": old,
                },
            }
            data = json.dumps(review).encode()
            req = urllib.request.Request(
                hook["url"], data=data, method="POST",
                headers={"Content-Type": "application/json"},
            )
            kwargs: Dict[str, Any] = {"timeout": 10}
            if hook["url"].startswith("https"):
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE  # self-signed test certs
                kwargs["context"] = ctx
            try:
                with urllib.request.urlopen(req, **kwargs) as resp:
                    out = json.loads(resp.read())
            except (OSError, ValueError) as e:
                # failurePolicy: Fail — the reference's default for its
                # validating webhook.
                return None, self._status(
                    500, "InternalError",
                    f"webhook {hook['url']} unreachable: {e}",
                )
            response = out.get("response") or {}
            if not response.get("allowed", False):
                msg = ((response.get("status") or {}).get("message")
                       or "admission denied")
                return None, self._status(403, "Forbidden", msg)
            if response.get("patch"):
                patch = json.loads(base64.b64decode(response["patch"]))
                obj = _apply_jsonpatch(obj, patch)
        return obj, None

    def handle_verb(
        self, method: str, path: str, body: Optional[Dict[str, Any]]
    ) -> Tuple[int, Dict[str, Any]]:
        """One non-watch REST verb, transport-agnostic: (code, payload)."""
        routed = self._route_path(path)
        if not routed:
            return self._status(404, "NotFound", f"no route {path}")
        prefix, name, cfg, is_status = routed
        st = self.state
        ks = st.kind(prefix)

        if method == "GET":
            if name:
                with ks.lock:
                    obj = ks.objects.get(name)
                if obj is None:
                    return self._status(404, "NotFound", f"{name} not found")
                return 200, obj
            qs = parse_qs(urlparse(path).query)
            with ks.lock:
                items = [o for _, o in sorted(ks.objects.items())]
                # rv snapshotted while holding the kind lock: a list must
                # never advertise an rv newer than its contents for this
                # kind, or a watch resumed from it skips events (only
                # observable with parallel writer processes). Same-kind
                # writes serialize on ks.lock, so every event this kind
                # publishes after this snapshot carries rv > list_rv.
                list_rv = st.rv
            sel = qs.get("labelSelector", [None])[0]
            if sel:
                pairs = dict(kv.split("=", 1) for kv in sel.split(","))
                items = [
                    o
                    for o in items
                    if all(
                        (o["metadata"].get("labels") or {}).get(k) == v
                        for k, v in pairs.items()
                    )
                ]
            return 200, {
                "kind": cfg["kind"] + "List",
                "apiVersion": cfg.get("apiVersion", "v1"),
                "metadata": {"resourceVersion": str(list_rv)},
                "items": items,
            }

        if method == "POST":
            if name:
                return self._status(405, "MethodNotAllowed", "POST to item")
            obj = body if body is not None else {}
            meta = obj.setdefault("metadata", {})
            oname = meta.get("name", "")
            if not oname:
                return self._status(422, "Invalid", "metadata.name required")
            obj, denied = self._admit(prefix, "CREATE", obj, None)
            if denied is not None:
                return denied
            meta = obj.setdefault("metadata", {})
            with ks.lock:
                if oname in ks.objects:
                    return self._status(
                        409, "AlreadyExists", f"{oname} already exists"
                    )
                meta["uid"] = meta.get("uid") or str(uuid.uuid4())
                meta["resourceVersion"] = str(st.next_rv())
                meta["generation"] = 1
                meta.setdefault(
                    "creationTimestamp",
                    time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                )
                meta.pop("deletionTimestamp", None)
                ks.objects[oname] = obj
                st.notify(prefix, "ADDED", obj)
            return 201, obj

        if method == "PUT":
            if not name:
                return self._status(405, "MethodNotAllowed", "PUT to collection")
            incoming = body if body is not None else {}
            # Admission sees spec updates, not status subresource writes
            # (matching real webhook rules scoped to the main resource).
            if not is_status:
                with ks.lock:
                    old = ks.objects.get(name)
                    old = json.loads(json.dumps(old)) if old else None
                incoming, denied = self._admit(prefix, "UPDATE", incoming, old)
                if denied is not None:
                    return denied
            with ks.lock:
                stored = ks.objects.get(name)
                if stored is None:
                    return self._status(404, "NotFound", f"{name} not found")
                in_rv = str(incoming.get("metadata", {}).get("resourceVersion", ""))
                if in_rv and in_rv != stored["metadata"]["resourceVersion"]:
                    return self._status(
                        409,
                        "Conflict",
                        f"resourceVersion {in_rv} != {stored['metadata']['resourceVersion']}",
                    )
                new = json.loads(json.dumps(stored))
                if is_status:
                    new["status"] = incoming.get("status", {})
                else:
                    spec_changed = incoming.get("spec") != stored.get("spec")
                    new["spec"] = incoming.get("spec", {})
                    # mutable metadata
                    im = incoming.get("metadata", {})
                    for k in ("labels", "annotations", "finalizers", "ownerReferences"):
                        if k in im:
                            new["metadata"][k] = im[k]
                        else:
                            new["metadata"].pop(k, None)
                    if spec_changed:
                        new["metadata"]["generation"] = (
                            int(stored["metadata"].get("generation", 1)) + 1
                        )
                new["metadata"]["resourceVersion"] = str(st.next_rv())
                if (
                    new["metadata"].get("deletionTimestamp")
                    and not new["metadata"].get("finalizers")
                ):
                    del ks.objects[name]
                    st.notify(prefix, "DELETED", new)
                    return 200, new
                ks.objects[name] = new
                st.notify(prefix, "MODIFIED", new)
                return 200, new

        if method == "DELETE":
            if not name:
                return self._status(405, "MethodNotAllowed", "DELETE collection")
            with ks.lock:
                stored = ks.objects.get(name)
                if stored is None:
                    return self._status(404, "NotFound", f"{name} not found")
                if stored["metadata"].get("finalizers"):
                    if not stored["metadata"].get("deletionTimestamp"):
                        new = json.loads(json.dumps(stored))
                        new["metadata"]["deletionTimestamp"] = time.strftime(
                            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                        )
                        new["metadata"]["resourceVersion"] = str(st.next_rv())
                        ks.objects[name] = new
                        st.notify(prefix, "MODIFIED", new)
                        return 200, new
                    return 200, stored
                del ks.objects[name]
                # Deletion is a write: the DELETED event carries a fresh
                # rv (etcd semantics) so watch resumes ordered after older
                # MODIFIEDs still replay it.
                stored = json.loads(json.dumps(stored))
                stored["metadata"]["resourceVersion"] = str(st.next_rv())
                st.notify(prefix, "DELETED", stored)
                return 200, stored

        return self._status(405, "MethodNotAllowed", f"unsupported {method}")

    def _subscribe(
        self, prefix: str, since: int
    ) -> Tuple[List[Dict[str, Any]], threading.Condition, Optional[Dict[str, Any]]]:
        """Register a watch on one kind shard: (buffer, condition,
        expired_event|None). When the resume rv is behind the compaction
        horizon, nothing is registered and the 410 ERROR event to send is
        returned — a real apiserver answers 200 + ERROR, then ends the
        watch; the client must relist."""
        ks = self.state.kind(prefix)
        buf: List[Dict[str, Any]] = []
        cond = threading.Condition()
        with ks.lock:
            if since and since < ks.compacted_rv:
                return buf, cond, {
                    "type": "ERROR",
                    "object": {
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure", "code": 410,
                        "reason": "Expired",
                        "message": (
                            f"too old resource version: {since} "
                            f"({ks.compacted_rv})"
                        ),
                    },
                }
            if since:
                # Faithful resume: replay the true event history — including
                # DELETED — exactly as etcd serves a watch from a historical
                # rv inside the horizon. Replay and subscription happen under
                # ONE lock hold, so a write landing while we replay is either
                # in the history we replay or in the buffer we just
                # subscribed — never both, never neither (the
                # lost-event/duplicate race a 4-process hammer exposes
                # immediately).
                for rv, etype, o in ks.event_log:
                    if rv > since:
                        buf.append({"type": etype, "object": o})
            else:
                # No resume rv: current state as ADDED (legacy
                # list+watch-from-now shape).
                for oname in sorted(ks.objects):
                    buf.append(
                        {"type": "ADDED",
                         "object": json.loads(json.dumps(ks.objects[oname]))}
                    )
            ks.watchers.append((buf, cond))
        return buf, cond, None

    # ------------------------------------------------------------------
    # mux request execution (called from per-session worker threads)
    # ------------------------------------------------------------------
    def _mux_verb(self, rid, method, path, body, send) -> None:
        fail = self._check_fail(method, path)
        code, payload = (
            self._status(*fail) if fail else self.handle_verb(method, path, body)
        )
        try:
            send({"id": rid, "code": code, "body": payload})
        except (wiremux.MuxError, OSError):
            pass  # session died; the read loop tears everything down

    def _mux_watch(self, rid, path, prefix, send, stop, conn) -> None:
        """One watch stream on a mux session: ack, then push events until
        the client cancels, the session dies, or the server shuts down."""
        st = self.state
        ks = st.kind(prefix)
        buf: Optional[List[Dict[str, Any]]] = None
        registered = False
        try:
            fail = self._check_fail("GET", path)
            if fail:
                code, payload = self._status(*fail)
                send({"id": rid, "code": code, "body": payload})
                return
            qs = parse_qs(urlparse(path).query)
            since = int(qs.get("resourceVersion", ["0"])[0] or 0)
            buf, cond, expired = self._subscribe(prefix, since)
            registered = expired is None
            send({"id": rid, "code": 200, "watch": True})
            if expired is not None:
                send({"watch": rid, "event": expired})
                return
            with st.lock:
                self.active_watch_conns.append(conn)
            try:
                while not self._shutdown and not stop.is_set():
                    with cond:
                        if not buf:
                            cond.wait(timeout=0.5)
                        events, buf[:] = list(buf), []
                    for evt in events:
                        send({"watch": rid, "event": evt})
            finally:
                with st.lock:
                    try:
                        self.active_watch_conns.remove(conn)
                    except ValueError:
                        pass
        except (wiremux.MuxError, OSError):
            pass
        finally:
            if registered and buf is not None:
                with ks.lock:
                    ks.watchers = [w for w in ks.watchers if w[0] is not buf]
            try:
                send({"watch": rid, "end": True})
            except (wiremux.MuxError, OSError):
                pass

    # ------------------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._httpd = _Server((host, port), self._handler_cls)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="fake-apiserver"
        )
        self._thread.start()
        return self.url

    @property
    def url(self) -> str:
        assert self._httpd
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self._shutdown = True
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    # ------------------------------------------------------------------
    # hostile-wire personas
    # ------------------------------------------------------------------
    def compact(self, up_to_rv: Optional[int] = None) -> None:
        """Etcd compaction: discard watch history; resumes from inside the
        discarded range get a 410 Expired ERROR event and must relist."""
        self.state.compact(up_to_rv)

    def kill_watch_connections(self) -> int:
        """Socket-level reset of every live streaming watch (no clean HTTP
        end). Returns how many were killed."""
        import socket as _socket

        with self.state.lock:
            conns = list(self.active_watch_conns)
        for conn in conns:
            try:
                conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        return len(conns)

    def sever_watches(self, settle_s: float = 0.3) -> None:
        """Kill live watch sockets until none remain for ``settle_s``.
        Meant to run with a ``watch_blocker`` armed: reconnects are refused,
        so quiescence is permanent — closes the race where a watch was
        between reconnects (or mid-handshake) at the instant of a single
        kill and survived into the 'gap'."""
        quiet_since = None
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self.kill_watch_connections():
                quiet_since = None
            else:
                quiet_since = quiet_since or time.monotonic()
                if time.monotonic() - quiet_since >= settle_s:
                    return
            time.sleep(0.02)

    def watch_blocker(self):
        """A fail-hook that 503s watch (re)connection attempts while armed —
        appended to ``fail_hooks`` to hold the stream down during a gap:

            unblock = srv.watch_blocker()
            ... mutate world ...
            unblock()

        Matches on the path string, which is identical on both transports,
        so a mux client's re-watch is refused exactly like an HTTP one's.
        """
        def hook(method: str, path: str):
            if method == "GET" and "watch=true" in path:
                return (503, "ServiceUnavailable", "watch blocked by test")
            return None

        self.fail_hooks.append(hook)

        def unblock() -> None:
            try:
                self.fail_hooks.remove(hook)
            except ValueError:
                pass

        return unblock

    # ------------------------------------------------------------------
    # test-side kubectl
    # ------------------------------------------------------------------
    def put_object(self, prefix: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Seed/replace an object directly (bypasses conflict checks)."""
        st = self.state
        name = obj["metadata"]["name"]
        ks = st.kind(prefix)
        with ks.lock:
            existed = name in ks.objects
            meta = obj.setdefault("metadata", {})
            meta.setdefault("uid", str(uuid.uuid4()))
            meta["resourceVersion"] = str(st.next_rv())
            meta.setdefault("generation", 1)
            meta.setdefault(
                "creationTimestamp", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
            )
            ks.objects[name] = obj
            st.notify(prefix, "MODIFIED" if existed else "ADDED", obj)
        return obj

    def get_object(self, prefix: str, name: str) -> Optional[Dict[str, Any]]:
        ks = self.state.kind(prefix)
        with ks.lock:
            obj = ks.objects.get(name)
            return json.loads(json.dumps(obj)) if obj else None

    def delete_object(self, prefix: str, name: str) -> None:
        st = self.state
        ks = st.kind(prefix)
        with ks.lock:
            obj = ks.objects.pop(name, None)
            if obj:
                obj = json.loads(json.dumps(obj))
                obj["metadata"]["resourceVersion"] = str(st.next_rv())
                st.notify(prefix, "DELETED", obj)


def operator_resources(
    group: str, version: str, namespace: str = "tpu-composer-system"
) -> Dict[str, Dict[str, Any]]:
    """The standard route map for operator-on-cluster harnesses — ONE
    definition shared by every harness that serves the operator over the
    wire, so a new published resource can't silently diverge between them.
    ``namespace`` scopes the namespaced kinds (Leases, matching KubeStore's
    --namespace / TPUC_NAMESPACE routing)."""
    return {
        f"/apis/{group}/{version}/composabilityrequests": {
            "kind": "ComposabilityRequest", "apiVersion": f"{group}/{version}",
        },
        f"/apis/{group}/{version}/composableresources": {
            "kind": "ComposableResource", "apiVersion": f"{group}/{version}",
        },
        "/api/v1/nodes": {"kind": "Node", "apiVersion": "v1"},
        "/apis/resource.k8s.io/v1beta1/resourceslices": {
            "kind": "ResourceSlice", "apiVersion": "resource.k8s.io/v1beta1",
        },
        "/apis/resource.k8s.io/v1alpha3/devicetaintrules": {
            "kind": "DeviceTaintRule", "apiVersion": "resource.k8s.io/v1alpha3",
        },
        # The control-plane-infrastructure kinds: leader/shard Leases, fleet
        # telemetry snapshots, maintenance drains. In-proc suites drive these
        # through an in-memory Store; a full operator replica over the
        # wire needs all three.
        "/apis/coordination.k8s.io/v1/namespaces/" + namespace + "/leases": {
            "kind": "Lease", "apiVersion": "coordination.k8s.io/v1",
        },
        f"/apis/{group}/{version}/fleettelemetries": {
            "kind": "FleetTelemetry", "apiVersion": f"{group}/{version}",
        },
        f"/apis/{group}/{version}/nodemaintenances": {
            "kind": "NodeMaintenance", "apiVersion": f"{group}/{version}",
        },
    }


def core_node_doc(name: str, chips: int = 4,
                  chip_resource: str = "tpu.composer.dev/chips") -> Dict[str, Any]:
    """A core-v1-shaped Node as kubelet would publish it."""
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
        "status": {
            "allocatable": {
                "cpu": "8",
                "memory": "32Gi",
                "ephemeral-storage": "100Gi",
                "pods": "110",
                chip_resource: str(chips),
            },
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


# ----------------------------------------------------------------------
# standalone launcher: python -m tpu_composer_torch.sim.apiserver
# ----------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    """Serve the fake apiserver (and optionally a fake fabric) as a
    standalone process — the shared store operator replicas in other
    processes dial into. Prints one JSON line with the bound URLs (and
    writes it to --url-file for supervisors that redirect stdout)."""
    import argparse
    import signal
    import sys

    from tpu_composer_torch import GROUP, VERSION

    p = argparse.ArgumentParser(
        prog="python -m tpu_composer_torch.sim.apiserver",
        description="standalone kube-apiserver fake for multi-process"
                    " operator replicas",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    p.add_argument("--namespace", default="tpu-composer-system",
                   help="namespace for the namespaced routes (Leases)")
    p.add_argument("--nodes", type=int, default=0,
                   help="seed N Ready core-v1 Nodes (node-0000...)")
    p.add_argument("--chips", type=int, default=4, help="chips per seeded node")
    p.add_argument("--latency", type=float, default=0.0,
                   help="injected per-request latency (seconds)")
    p.add_argument("--fabric", action="store_true",
                   help="also serve a fake fabric (REST pool dialect) backed"
                        " by an InMemoryPool sized to the seeded inventory")
    p.add_argument("--fabric-chips", default="",
                   help="fabric pool inventory, MODEL=N[,MODEL=N...]"
                        " (default: nvidia-h100-sxm sized to nodes*chips)")
    p.add_argument("--url-file", default="",
                   help="write the JSON discovery line here too")
    args = p.parse_args(argv)

    srv = FakeApiServer(operator_resources(GROUP, VERSION, args.namespace))
    srv.latency_s = args.latency
    srv.start(host=args.host, port=args.port)
    for i in range(args.nodes):
        srv.put_object(
            "/api/v1/nodes", core_node_doc(f"node-{i:04d}", chips=args.chips)
        )

    fabric_url = None
    fabric_srv = None
    if args.fabric:
        from tpu_composer_torch.fabric.inmem import InMemoryPool
        try:
            from tests.torch_fake_fabric import FakeFabricServer
        except ImportError as e:
            print(f"--fabric needs tests/torch_fake_fabric.py importable "
                  f"(run from the repo root): {e}", file=sys.stderr)
            srv.stop()
            return 2
        if args.fabric_chips:
            chips = {
                m: int(n)
                for m, n in (kv.split("=", 1)
                             for kv in args.fabric_chips.split(","))
            }
        else:
            chips = {"nvidia-h100-sxm": max(args.nodes, 1) * args.chips}
        fabric_srv = FakeFabricServer(pool=InMemoryPool(chips=chips))
        fabric_url = fabric_srv.url

    discovery = {
        "apiserver": srv.url,
        "fabric": fabric_url,
        "namespace": args.namespace,
        "nodes": args.nodes,
    }
    line = json.dumps(discovery)
    print(line, flush=True)
    if args.url_file:
        with open(args.url_file, "w") as f:
            f.write(line + "\n")

    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    try:
        while not done.wait(0.5):
            pass
    finally:
        if fabric_srv is not None:
            fabric_srv.close()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
