"""Kubernetes-backed Store — the operator running *as an operator* (port of
``tpu_composer/runtime/kubestore.py``).

An operator that speaks only to its own in-process ``Store`` never sees a
``kubectl apply``-ed ComposabilityRequest. ``KubeStore`` implements the exact same
client surface as ``runtime.store.Store`` against a real kube-apiserver over
its REST API, so every controller, the syncer, admission and the manager run
unchanged on a cluster:

- typed CRUD on the project CRDs (``deploy/crds/``) at
  ``/apis/tpu.composer.dev/v1alpha1/<plural>[/<name>]``;
- the status subresource (``PUT .../status``) for ``update_status``;
- optimistic concurrency: HTTP 409 → ``ConflictError`` (same contract the
  reference's controller-runtime client has, and the same type our
  controllers already retry on);
- finalizer-gated deletion: DELETE marks ``deletionTimestamp`` server-side
  when finalizers are present; removing the last finalizer purges;
- watches: streaming ``?watch=true`` GETs decoded into the same
  ``WatchEvent`` queues ``Store.watch`` hands out, with automatic reconnect
  from the last seen resourceVersion;
- core v1 Nodes (``/api/v1/nodes``) translated into our ``Node`` type —
  allocatable cpu/memory/pods plus the ``tpu.composer.dev/chips`` extended
  resource become ``NodeStatus`` fields, and the Ready condition becomes
  ``status.ready``.

Reference analog: ``cmd/main.go:161-165`` builds a raw clientset next to the
manager's cached client; all reference controllers speak to kube-apiserver
through exactly these verbs (typed GET/LIST/UPDATE/status-UPDATE/DELETE +
watches). Config loading mirrors client-go's rules: ``--kubeconfig`` flag >
``$KUBECONFIG`` > in-cluster service account
(``/var/run/secrets/kubernetes.io/serviceaccount``).

Implementation is stdlib-only (``urllib`` + ``ssl`` + ``json`` + ``yaml`` for
kubeconfig parsing) — no kubernetes client dependency.
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import queue
import socket
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, TypeVar

from tpu_composer_torch import GROUP, VERSION
from tpu_composer_torch.api.meta import ApiObject, ObjectMeta
from tpu_composer_torch.api.scheme import Scheme, default_scheme
from tpu_composer_torch.api.types import Node, NodeStatus
from tpu_composer_torch.runtime import wiremux
from tpu_composer_torch.runtime.metrics import (
    cached_reads_total,
    status_writes_coalesced_total,
    store_requests_total,
    wire_mux_active,
    wire_mux_degraded_total,
)
from tpu_composer_torch.runtime.store import (
    ADDED,
    DELETED,
    MODIFIED,
    AdmissionHook,
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    StoreError,
    WatchEvent,
)

T = TypeVar("T", bound=ApiObject)

# The extended resource name composed chips are advertised under (see
# agent/publisher.py). A core Node's allocatable map carries it. The name
# stays ``tpu.composer.dev/chips`` on every host: on an H100 host it counts
# GPUs, just as ``NodeStatus.tpu_slots`` (which it fills) does.
CHIP_RESOURCE = f"{GROUP}/chips"

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class KubeConfig:
    """Connection parameters for one apiserver."""

    host: str  # e.g. https://10.0.0.1:6443 or http://127.0.0.1:8001
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    insecure_skip_verify: bool = False
    # temp files materialized from inline kubeconfig data — the private key
    # must not outlive the client (cleanup() removes them).
    temp_files: List[str] = field(default_factory=list)

    def cleanup(self) -> None:
        for p in self.temp_files:
            try:
                os.remove(p)
            except OSError:
                pass
        self.temp_files.clear()

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        """Pod environment: KUBERNETES_SERVICE_HOST + mounted service account.
        client-go's rest.InClusterConfig equivalent."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise StoreError("not running in a cluster (KUBERNETES_SERVICE_HOST unset)")
        token = ""
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(
            host=f"https://{host}:{port}",
            token=token or None,
            ca_file=ca if os.path.exists(ca) else None,
        )

    @classmethod
    def from_kubeconfig(cls, path: str, context: Optional[str] = None) -> "KubeConfig":
        """Minimal kubeconfig loader: current-context cluster + user, with
        inline (base64) or file-referenced certs, token or client cert auth."""
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f)
        ctx_name = context or doc.get("current-context")
        ctx = next(
            c["context"] for c in doc.get("contexts", []) if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in doc.get("clusters", []) if c["name"] == ctx["cluster"]
        )
        user = next(
            (u["user"] for u in doc.get("users", []) if u["name"] == ctx.get("user")),
            {},
        )

        temp_files: List[str] = []

        def materialize(data_key: str, file_key: str, src: Dict[str, Any]) -> Optional[str]:
            if src.get(file_key):
                return src[file_key]
            if src.get(data_key):
                fd, p = tempfile.mkstemp(prefix="kubecfg-", suffix=".pem")
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(src[data_key]))
                temp_files.append(p)
                return p
            return None

        out = cls(
            host=cluster["server"],
            token=user.get("token"),
            ca_file=materialize("certificate-authority-data", "certificate-authority", cluster),
            client_cert_file=materialize("client-certificate-data", "client-certificate", user),
            client_key_file=materialize("client-key-data", "client-key", user),
            insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        )
        out.temp_files = temp_files
        return out

    @classmethod
    def load(cls, kubeconfig: Optional[str] = None) -> "KubeConfig":
        """client-go precedence: explicit flag > $KUBECONFIG > in-cluster."""
        path = kubeconfig or os.environ.get("KUBECONFIG")
        if path:
            return cls.from_kubeconfig(path)
        return cls.in_cluster()


@dataclass
class _KindRoute:
    """REST location of one kind."""

    path_prefix: str  # e.g. /apis/tpu.composer.dev/v1alpha1/composabilityrequests
    api_version: str
    translate_in: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    translate_out: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None
    read_only: bool = False
    # Whether get/list may be served from the watch-backed cache. Leases are
    # excluded: leader election needs linearizable reads (client-go likewise
    # reads Leases through a direct client, never the informer cache).
    cacheable: bool = True


def _core_node_to_ours(d: Dict[str, Any]) -> Dict[str, Any]:
    """Translate a core v1 Node into our Node wire form.

    Reference analog: the reference consumes core Nodes directly for capacity
    checks (utils/nodes.go:78-117) and the Machine/BMH identity chain; our
    data model folds the fields the controllers use into NodeStatus.
    """

    def qty(s: str) -> int:
        """Parse a K8s resource.Quantity into an integer base-unit count."""
        s = str(s)
        mults = {
            "Ki": 1024, "Mi": 1024 ** 2, "Gi": 1024 ** 3, "Ti": 1024 ** 4,
            "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12,
        }
        for suf, m in mults.items():
            if s.endswith(suf):
                return int(float(s[: -len(suf)]) * m)
        if s.endswith("m"):  # milli — used for cpu
            return int(s[:-1])
        return int(float(s))

    alloc = (d.get("status") or {}).get("allocatable") or {}
    conds = (d.get("status") or {}).get("conditions") or []
    ready = any(c.get("type") == "Ready" and c.get("status") == "True" for c in conds)
    cpu_raw = str(alloc.get("cpu", "0"))
    milli_cpu = qty(cpu_raw) if cpu_raw.endswith("m") else int(float(cpu_raw) * 1000)
    status = NodeStatus(
        milli_cpu=milli_cpu,
        memory=qty(alloc.get("memory", "0")),
        ephemeral_storage=qty(alloc.get("ephemeral-storage", "0")),
        allowed_pod_number=qty(alloc.get("pods", "0")),
        tpu_slots=qty(alloc.get(CHIP_RESOURCE, "0")),
        ready=ready,
    )
    meta = dict(d.get("metadata", {}))
    # Core RVs are opaque strings; ours are ints. Numeric strings (etcd
    # revisions) pass through; anything else gets a deterministic digest
    # (crc32 — PYTHONHASHSEED-independent, so the mapping is stable across
    # processes and restarts; Nodes are read-only so it is never written back).
    rv = str(meta.get("resourceVersion", "0"))
    meta["resourceVersion"] = int(rv) if rv.isdigit() else zlib.crc32(rv.encode())
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Node",
        "metadata": meta,
        "spec": {},  # our NodeSpec carries nothing a core Node provides
        "status": status.to_dict(),
    }


class KubeStore:
    """Store-compatible client for a real kube-apiserver."""

    def __init__(
        self,
        config: Optional[KubeConfig] = None,
        scheme: Optional[Scheme] = None,
        kubeconfig: Optional[str] = None,
        watch_reconnect_s: float = 1.0,
        cache_reads: bool = True,
        cache_sync_timeout_s: float = 5.0,
        namespace: Optional[str] = None,
        wire_mux: Optional[bool] = None,
        wire_ping_period: Optional[float] = None,
        wire_ping_misses: Optional[int] = None,
        wire_mux_max_fails: Optional[int] = None,
        wire_connect_timeout: Optional[float] = None,
    ) -> None:
        self._cfg = config or KubeConfig.load(kubeconfig)
        # Per-thread persistent HTTP connection (keep-alive). A fresh
        # TCP connect per request costs getaddrinfo + handshake + a
        # server-side thread spawn — ~20% of reconcile-worker CPU under
        # a multi-process churn run. Watches (stream=True) still get
        # dedicated connections; this pool is for the short verbs only.
        # With the mux transport active neither pool is touched — every
        # verb and watch rides ONE framed socket — but both remain the
        # fallback path (TPUC_WIRE_MUX=0, or a server without /mux).
        self._conn_local = threading.local()
        # Multiplexed framed transport (runtime/wiremux.py): one socket
        # per replica, correlation-id pipelining, watches as server-push
        # frames. None until first use; permanently disabled after the
        # server declines the upgrade.
        if wire_mux is None:
            wire_mux = os.environ.get("TPUC_WIRE_MUX", "1") != "0"
        self._wire_mux = wire_mux
        self._mux: Optional[wiremux.MuxClient] = None
        self._mux_lock = threading.Lock()
        self._mux_failed = False
        # Mux liveness + flap-damping knobs (a command line passes them
        # here; env reads are the fallback for direct constructions).
        # TPUC_WIRE_PING=0 is the kill switch that wins over any period.
        if wire_ping_period is None:
            wire_ping_period = float(
                os.environ.get("TPUC_WIRE_PING_PERIOD", "5.0")
            )
        if os.environ.get("TPUC_WIRE_PING", "1") == "0":
            wire_ping_period = 0.0
        self._wire_ping_period = max(0.0, wire_ping_period)
        if wire_ping_misses is None:
            wire_ping_misses = int(os.environ.get("TPUC_WIRE_PING_MISSES", "2"))
        self._wire_ping_misses = max(1, wire_ping_misses)
        if wire_mux_max_fails is None:
            wire_mux_max_fails = int(
                os.environ.get("TPUC_WIRE_MUX_MAX_FAILS", "5")
            )
        self._wire_mux_max_fails = max(1, wire_mux_max_fails)
        if wire_connect_timeout is None:
            wire_connect_timeout = float(
                os.environ.get("TPUC_WIRE_CONNECT_TIMEOUT", "5.0")
            )
        self._wire_connect_timeout = wire_connect_timeout
        # Namespace for the namespaced kinds (Leases, FleetTelemetry):
        # a command line passes it here; the env read below
        # (TPUC_NAMESPACE) is the fallback for direct constructions.
        self._namespace = namespace or os.environ.get(
            "TPUC_NAMESPACE", "tpu-composer-system"
        )
        self._scheme = scheme or default_scheme()
        self._lock = threading.RLock()
        self._admission: List[Tuple[str, AdmissionHook]] = []
        self._watches: Dict[int, List["_Reflector"]] = {}
        self._watch_reconnect_s = watch_reconnect_s
        self._closed = threading.Event()
        # Watch-backed read cache (controller-runtime's cached client /
        # client-go informer analog — cmd/main.go:137-155 reads through the
        # manager cache; only writes hit the wire). One lazily-started
        # reflector per kind; get/list are served from it once synced, with
        # wire fallback until then.
        self._cache_reads = cache_reads
        self._cache_sync_timeout_s = cache_sync_timeout_s
        self._reflectors: Dict[str, "_Reflector"] = {}
        # Original opaque resourceVersion strings by (kind, name): K8s RVs
        # are opaque; when one is non-numeric we keep the raw string here so
        # _encode can write back the server's exact token instead of dropping
        # the precondition (which would turn CAS PUTs into blind overwrites).
        self._rv_raw: Dict[Tuple[str, str], Tuple[int, str]] = {}
        # True once any non-numeric resourceVersion is seen: the crc32
        # digests standing in for opaque RVs are NOT ordered, so every
        # rv-comparison optimization (reflector tombstones, newer-wins
        # folds) must disable itself and fall back to stream-order-only
        # semantics.
        self._opaque_rv = False

        base = f"/apis/{GROUP}/{VERSION}"
        self._routes: Dict[str, _KindRoute] = {
            "ComposabilityRequest": _KindRoute(
                f"{base}/composabilityrequests", f"{GROUP}/{VERSION}"
            ),
            "ComposableResource": _KindRoute(
                f"{base}/composableresources", f"{GROUP}/{VERSION}"
            ),
            # Core Nodes are kubelet-owned: the operator reads them and maps
            # them into our Node type; writes are rejected.
            "Node": _KindRoute(
                "/api/v1/nodes", "v1", translate_in=_core_node_to_ours, read_only=True
            ),
            # Leader-election Lease (namespaced — reference elects in its own
            # namespace, cmd/main.go:142-155). Serialization already matches
            # the coordination.k8s.io wire form (api/lease.py).
            "Lease": _KindRoute(
                "/apis/coordination.k8s.io/v1/namespaces/"
                + self._namespace
                + "/leases",
                "coordination.k8s.io/v1",
                cacheable=False,
            ),
            # Fleet telemetry snapshots (runtime/fleet.py): our own CRD
            # (deploy/crds), read/written by every replica's fleet plane.
            # Uncacheable like Leases — the aggregator's staleness clock
            # needs the freshest seq, and the churn would thrash a cache.
            "FleetTelemetry": _KindRoute(
                f"{base}/fleettelemetries", f"{GROUP}/{VERSION}",
                cacheable=False,
            ),
            # Node maintenance drains (live-migration verb): our own CRD
            # (deploy/crds), written by operators and reconciled by the
            # maintenance controller.
            "NodeMaintenance": _KindRoute(
                f"{base}/nodemaintenances", f"{GROUP}/{VERSION}"
            ),
            # DRA publication + quarantine (reference scans ResourceSlices at
            # gpus.go:207-239 and rules DeviceTaintRules at :894-975).
            "ResourceSlice": _KindRoute(
                "/apis/resource.k8s.io/v1beta1/resourceslices",
                "resource.k8s.io/v1beta1",
            ),
            "DeviceTaintRule": _KindRoute(
                "/apis/resource.k8s.io/v1alpha3/devicetaintrules",
                "resource.k8s.io/v1alpha3",
            ),
        }

        ctx = ssl.create_default_context()
        if self._cfg.ca_file:
            ctx.load_verify_locations(self._cfg.ca_file)
        if self._cfg.client_cert_file:
            ctx.load_cert_chain(
                self._cfg.client_cert_file, self._cfg.client_key_file
            )
        if self._cfg.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        self._ssl_ctx = ctx

    @property
    def scheme(self) -> Scheme:
        return self._scheme

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        timeout: float = 30.0,
        stream: bool = False,
    ):
        mux = self._mux_client()
        if mux is not None:
            try:
                if stream:
                    # Watch: a server-push stream on the shared socket.
                    # MuxWatch iterates JSON lines exactly like the urllib
                    # response the HTTP path returns, so _WatchThread is
                    # transport-blind.
                    return mux.watch(path, timeout=timeout)
                code, payload = mux.request(
                    method, path, body=body, timeout=timeout,
                    idempotent=self._retry_safe(method, body),
                )
                if code >= 400:
                    raise self._http_error(method, path, code, payload)
                return payload if isinstance(payload, dict) else {}
            except wiremux.MuxHTTPError as e:
                raise self._http_error(method, path, e.code, e.body)
            except wiremux.MuxUnsupported:
                # Server has no /mux endpoint: permanent per-store HTTP
                # fallback (logged once inside _mux_client's next call).
                self._mux_disable("server declined tpuc-mux/1 upgrade")
            except wiremux.MuxError as e:
                # Transport failure on the framed socket: same contract as
                # an HTTP transport failure — typed StoreError, reconnect
                # happens lazily on the next call. Connection-level failure
                # streaks (never per-request ones) feed the flap damper.
                self._note_mux_failure(mux)
                raise StoreError(f"{method} {path}: {e}") from None
        url = self._cfg.host.rstrip("/") + path
        data = json.dumps(body).encode() if body is not None else None
        if stream:
            # Watches hold their response open for minutes — they must
            # not occupy (or be torn down with) the per-thread verb
            # connection, so they go through urllib on a dedicated one.
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Accept", "application/json")
            if data is not None:
                req.add_header("Content-Type", "application/json")
            if self._cfg.token:
                req.add_header("Authorization", f"Bearer {self._cfg.token}")
            kwargs: Dict[str, Any] = {"timeout": timeout}
            if url.startswith("https"):
                kwargs["context"] = self._ssl_ctx
            try:
                return urllib.request.urlopen(req, **kwargs)
            except urllib.error.HTTPError as e:
                raise self._http_error(method, path, e.code,
                                       e.read().decode(errors="replace"))
            except (urllib.error.URLError, OSError) as e:
                # Transport failures (apiserver unreachable, DNS, socket
                # timeout) must surface as StoreError like every other
                # API failure — callers' retry/absorb policies are typed
                # on the Store exception hierarchy, not on urllib
                # internals.
                raise StoreError(f"{method} {path}: {e}") from None
        headers = {"Accept": "application/json"}
        if data is not None:
            headers["Content-Type"] = "application/json"
        if self._cfg.token:
            headers["Authorization"] = f"Bearer {self._cfg.token}"
        # Keep-alive with one CLASSIFIED retry: a pooled connection the
        # server idle-closed surfaces as a transport error while writing
        # the request — nothing was executed, so retrying any verb once on
        # a fresh connection is the standard (urllib3-style) recovery. A
        # failure AFTER the request was fully written is ambiguous (the
        # server may have executed it and the response was lost): only
        # idempotent verbs — reads and CAS-guarded updates — retry; a
        # create/delete surfaces as StoreError so the controllers'
        # requeue + nonce machinery resolves the ambiguity. A failure on
        # a brand-new connection is a real outage and propagates.
        idempotent = self._retry_safe(method, body)
        for attempt in (0, 1):
            conn = getattr(self._conn_local, "conn", None)
            reused = conn is not None
            if conn is None:
                conn = self._new_connection(timeout)
                self._conn_local.conn = conn
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            else:
                conn.timeout = timeout
            sent = False
            try:
                conn.request(method, path, body=data, headers=headers)
                # Fully written: failures past here are ambiguous. The
                # converse — request() raised, so the server provably did
                # not execute — rests on the invariant documented next to
                # _retry_safe; see the residual-window note there.
                sent = True
                resp = conn.getresponse()
                payload = resp.read().decode(errors="replace")
                code = resp.status
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                self._conn_local.conn = None
                if reused and attempt == 0 and (not sent or idempotent):
                    continue
                raise StoreError(f"{method} {path}: {e}") from None
            if code >= 400:
                raise self._http_error(method, path, code, payload)
            return json.loads(payload) if payload else {}
        raise StoreError(f"{method} {path}: retry fell through")  # unreachable

    @staticmethod
    def _retry_safe(method: str, body: Optional[Dict[str, Any]]) -> bool:
        """Idempotency classification for ambiguous "sent, response lost"
        transport failures. GET re-runs trivially. A PUT carrying a
        ``metadata.resourceVersion`` is CAS-guarded: if the lost attempt
        actually landed, the replay hits 409 ConflictError and the caller
        requeues on fresh state — never a double apply. Creates, deletes,
        and blind PUTs are NOT safe: replaying one can double-execute, so
        the ambiguity must surface as StoreError and be resolved by the
        controllers' requeue + nonce machinery, not by the transport.

        RESIDUAL WINDOW of the sent/not-sent split in the HTTP leg: an
        exception raised inside ``conn.request()`` is classified as
        "never executed" and retried once for ANY verb on a reused
        connection. That is sound only under the invariant that a raising
        write path left some suffix of the request un-queued — the server
        then cannot hold the complete request (headers + full
        Content-Length body) and will not execute it. CPython's
        ``http.client`` with a ``bytes`` body upholds this (headers and
        body coalesce into one ``sendall``, which raises only with
        unconsumed data remaining), but it is an assumption about the
        stdlib write path, not something this code can observe: a
        successful ``sendall`` only proves kernel-buffering, and a
        transport whose write raised AFTER the full request was queued
        (e.g. a socket wrapper surfacing a delayed RST from
        fully-delivered earlier writes) would let a create/delete retry
        double-execute in that narrow window. If the write path ever
        grows such a layer, ``sent`` must flip to True the moment body
        bytes begin flowing, accepting idempotent-only retries for
        write-phase failures."""
        if method == "GET":
            return True
        if method == "PUT":
            md = (body or {}).get("metadata") or {}
            return bool(md.get("resourceVersion"))
        return False

    def _note_mux_failure(self, mux: wiremux.MuxClient) -> None:
        """Flap damper: degrade to HTTP only after K consecutive mux
        CONNECTION failures (failed dials plus connections that died
        before serving a single frame). Per-request failures never count,
        so one lost verb on a healthy transport can't flap it, and a
        healthy frame resets the streak — degradation means the wire
        itself is persistently unusable."""
        if mux.fail_streak >= self._wire_mux_max_fails:
            self._mux_disable(
                f"{mux.fail_streak} consecutive mux connection failures"
                f" (limit {self._wire_mux_max_fails})",
                cause="failures",
            )

    def _mux_client(self) -> Optional[wiremux.MuxClient]:
        """The shared framed-transport client, or None when the store is on
        the HTTP path (kill switch off, or the server declined /mux)."""
        if not self._wire_mux or self._mux_failed:
            return None
        with self._mux_lock:
            if self._mux is None:
                ctx = (
                    self._ssl_ctx
                    if self._cfg.host.startswith("https")
                    else None
                )
                self._mux = wiremux.MuxClient(
                    self._cfg.host,
                    ssl_context=ctx,
                    token=self._cfg.token,
                    connect_timeout=self._wire_connect_timeout,
                    ping_period=self._wire_ping_period,
                    ping_misses=self._wire_ping_misses,
                )
                wire_mux_active.set(1)
            return self._mux

    def _mux_disable(self, reason: str, cause: str = "declined") -> None:
        """Permanent fallback to the keep-alive HTTP path for this store."""
        if not self._mux_failed:
            logging.getLogger("tpu_composer_torch.kubestore").warning(
                "wire mux disabled, falling back to HTTP: %s", reason
            )
            wire_mux_degraded_total.inc(reason=cause)
        self._mux_failed = True
        wire_mux_active.set(0)
        with self._mux_lock:
            mux, self._mux = self._mux, None
        if mux is not None:
            mux.close()

    def _new_connection(self, timeout: float):
        host = urllib.parse.urlsplit(self._cfg.host)
        if host.scheme == "https":
            conn = http.client.HTTPSConnection(
                host.netloc, timeout=timeout, context=self._ssl_ctx
            )
        else:
            conn = http.client.HTTPConnection(host.netloc, timeout=timeout)
        try:
            conn.connect()
        except OSError as e:
            raise StoreError(f"connect {self._cfg.host}: {e}") from None
        # TCP_NODELAY on the pooled verb connections (client-go parity —
        # Go enables it on every dialed conn): a pooled connection that
        # Nagles a small write behind the peer's delayed ACK pays ~40ms
        # per request, which is the whole keep-alive dividend and then
        # some.
        try:
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        except OSError:  # pragma: no cover - non-TCP transports
            pass
        return conn

    @staticmethod
    def _http_error(method: str, path: str, code: int, payload):
        """Map an apiserver error status to the Store exception hierarchy
        (returned, not raised, so callers control the traceback). ``payload``
        is the raw response body string on the HTTP path, an already-decoded
        Status dict on the mux path."""
        if isinstance(payload, dict):
            status = payload
        else:
            try:
                status = json.loads(payload)
            except (ValueError, TypeError):
                status = {"message": payload}
        msg = f"{method} {path}: {code} {status.get('reason', '')} {status.get('message', '')}"
        if code == 404:
            return NotFoundError(msg)
        if code == 409:
            if status.get("reason") == "AlreadyExists":
                return AlreadyExistsError(msg)
            return ConflictError(msg)
        return StoreError(msg)

    # ------------------------------------------------------------------
    # serde helpers
    # ------------------------------------------------------------------
    def _route(self, kind: str) -> _KindRoute:
        try:
            return self._routes[kind]
        except KeyError:
            raise StoreError(f"kind {kind!r} has no REST route") from None

    def _decode(self, kind: str, d: Dict[str, Any]) -> ApiObject:
        route = self._route(kind)
        if route.translate_in:
            d = route.translate_in(d)
        d = dict(d)
        d["kind"] = kind
        meta = d.get("metadata") or {}
        rv = str(meta.get("resourceVersion", 0))
        if not rv.isdigit():
            # Opaque RV: map to a deterministic digest for our int field and
            # remember the raw token for faithful write-back.
            digest = zlib.crc32(rv.encode()) or 1
            d.setdefault("metadata", {})["resourceVersion"] = digest
            self._opaque_rv = True
            name = str(meta.get("name", ""))
            if name:
                with self._lock:
                    self._rv_raw[(kind, name)] = (digest, rv)
        return self._scheme.decode(d)

    def _encode(self, obj: ApiObject) -> Dict[str, Any]:
        d = obj.to_dict()
        route = self._route(obj.KIND)
        d["apiVersion"] = route.api_version
        meta = d.get("metadata", {})
        # K8s wants RV as an opaque string, absent on create. If this object
        # came in with a non-numeric (opaque) RV, write the server's exact
        # token back so the optimistic-concurrency precondition survives.
        rv = meta.get("resourceVersion", 0)
        if rv:
            with self._lock:
                kept = self._rv_raw.get((obj.KIND, obj.metadata.name))
            if kept is not None and kept[0] == rv:
                meta["resourceVersion"] = kept[1]
            else:
                meta["resourceVersion"] = str(rv)
        else:
            meta.pop("resourceVersion", None)
        meta.pop("generation", None)  # system-owned server-side
        if not meta.get("uid"):
            meta.pop("uid", None)
        if not meta.get("creationTimestamp"):
            meta.pop("creationTimestamp", None)
        if route.translate_out:
            d = route.translate_out(d)
        return d

    def _run_admission(self, op: str, new: ApiObject, old: Optional[ApiObject]) -> None:
        """Client-side admission mirror.

        On a cluster with the webhook deployed (deploy/webhook.yaml) the
        apiserver enforces admission; running the registered hooks here too
        keeps standalone parity and costs one in-process call."""
        for kind, hook in list(self._admission):
            if kind == "*" or kind == new.KIND:
                hook(op, new, old)

    def register_admission(self, kind: str, hook: AdmissionHook) -> None:
        with self._lock:
            self._admission.append((kind, hook))

    # ------------------------------------------------------------------
    # read cache plumbing
    # ------------------------------------------------------------------
    def _reflector(self, kind: str) -> "_Reflector":
        with self._lock:
            refl = self._reflectors.get(kind)
            if refl is None:
                refl = _Reflector(self, kind, self._watch_reconnect_s)
                self._reflectors[kind] = refl
                refl.start()
        return refl

    def _cached(self, kind: str) -> Optional["_Reflector"]:
        """Reflector serving reads for this kind, or None → read the wire.
        The first cached read lazily starts the reflector and blocks (up to
        cache_sync_timeout_s) for its initial list; if the sync doesn't land
        in time we fall back to the wire rather than serve an empty cache."""
        if not self._cache_reads or self._closed.is_set():
            return None
        route = self._routes.get(kind)
        if route is None or not route.cacheable:
            return None
        refl = self._reflector(kind)
        if not refl.wait_synced(self._cache_sync_timeout_s):
            return None
        return refl

    def _note_write(self, obj: ApiObject) -> None:
        """Fold a write response into the cache, if one is running."""
        route = self._routes.get(obj.KIND)
        if route is None or not route.cacheable:
            return
        with self._lock:
            refl = self._reflectors.get(obj.KIND)
        if refl is not None:
            refl.note_write(obj)

    # ------------------------------------------------------------------
    # CRUD — Store-compatible surface
    # ------------------------------------------------------------------
    def create(self, obj: T) -> T:
        route = self._route(obj.KIND)
        if route.read_only:
            raise StoreError(f"{obj.KIND} is read-only through KubeStore")
        obj = obj.deepcopy()
        if not obj.metadata.name:
            raise StoreError("metadata.name is required")
        self._run_admission("CREATE", obj, None)
        if hasattr(obj, "validate"):
            obj.validate()
        store_requests_total.inc(verb="create", kind=obj.KIND)
        out = self._request("POST", route.path_prefix, self._encode(obj))
        decoded = self._decode(obj.KIND, out)
        self._note_write(decoded)
        return decoded  # type: ignore[return-value]

    def get(self, cls: Type[T], name: str) -> T:
        refl = self._cached(cls.KIND)
        if refl is not None:
            cached_reads_total.inc(verb="get", kind=cls.KIND)
            obj = refl.get(name)
            if obj is None:
                raise NotFoundError(f"GET {cls.KIND}/{name}: 404 NotFound (cache)")
            return obj  # type: ignore[return-value]
        route = self._route(cls.KIND)
        store_requests_total.inc(verb="get", kind=cls.KIND)
        out = self._request("GET", f"{route.path_prefix}/{name}")
        return self._decode(cls.KIND, out)  # type: ignore[return-value]

    def try_get(self, cls: Type[T], name: str) -> Optional[T]:
        try:
            return self.get(cls, name)
        except NotFoundError:
            return None

    def list(
        self,
        cls: Type[T],
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        refl = self._cached(cls.KIND)
        if refl is not None:
            cached_reads_total.inc(verb="list", kind=cls.KIND)
            decoded = refl.list()
            if label_selector:
                decoded = [
                    o
                    for o in decoded
                    if all(
                        o.metadata.labels.get(k) == v
                        for k, v in label_selector.items()
                    )
                ]
            return sorted(decoded, key=lambda o: o.metadata.name)  # type: ignore[return-value]
        route = self._route(cls.KIND)
        store_requests_total.inc(verb="list", kind=cls.KIND)
        path = route.path_prefix
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))
            path += "?labelSelector=" + urllib.parse.quote(sel)
        out = self._request("GET", path)
        items = out.get("items", [])
        decoded = [self._decode(cls.KIND, i) for i in items]
        # Server-side labelSelector is authoritative, but fake servers in
        # tests may ignore it; filter again for exactness.
        if label_selector:
            decoded = [
                o
                for o in decoded
                if all(o.metadata.labels.get(k) == v for k, v in label_selector.items())
            ]
        return sorted(decoded, key=lambda o: o.metadata.name)  # type: ignore[return-value]

    def _has_hooks(self, kind: str) -> bool:
        return any(k == "*" or k == kind for k, _ in self._admission)

    def update(self, obj: T) -> T:
        route = self._route(obj.KIND)
        if route.read_only:
            raise StoreError(f"{obj.KIND} is read-only through KubeStore")
        obj = obj.deepcopy()
        # The old-object fetch exists only to feed client-side admission
        # hooks; without any registered it would double the round trips on
        # the hottest reconcile path for nothing (a PUT 404 already maps to
        # NotFoundError).
        if self._has_hooks(obj.KIND):
            old = self.try_get(type(obj), obj.metadata.name)
            if old is None:
                raise NotFoundError(f"{obj.KIND}/{obj.metadata.name} not found")
            self._run_admission("UPDATE", obj, old)
        if hasattr(obj, "validate"):
            obj.validate()
        store_requests_total.inc(verb="update", kind=obj.KIND)
        out = self._request(
            "PUT", f"{route.path_prefix}/{obj.metadata.name}", self._encode(obj)
        )
        decoded = self._decode(obj.KIND, out)
        self._note_write(decoded)
        return decoded  # type: ignore[return-value]

    def update_status(self, obj: T) -> T:
        route = self._route(obj.KIND)
        if route.read_only:
            raise StoreError(f"{obj.KIND} is read-only through KubeStore")
        obj = obj.deepcopy()
        # Status-write coalescing (shared dirty-check with the standalone
        # CachedClient): a status identical to the cached head at the same
        # resourceVersion would be a pure rv-bump PUT — skip the wire op.
        # Known window: a reflector lagging the apiserver can coalesce a
        # write the apiserver would 409 (stale rv, identical status) —
        # reported success on an object a concurrent writer superseded.
        # There is no cheap wire barrier to close it; level triggering
        # still converges via the pending MODIFIED event, and the skipped
        # write was a no-op at the head the caller read. The standalone
        # CachedClient CAN close it (in-proc queue barrier) and does.
        if route.cacheable and self._cache_reads:
            from tpu_composer_torch.runtime.cache import status_write_needed

            with self._lock:
                refl = self._reflectors.get(obj.KIND)
            if refl is not None and refl.wait_synced(0):
                if not status_write_needed(refl.get(obj.metadata.name), obj):
                    status_writes_coalesced_total.inc(kind=obj.KIND)
                    return obj.deepcopy()
        store_requests_total.inc(verb="update_status", kind=obj.KIND)
        out = self._request(
            "PUT",
            f"{route.path_prefix}/{obj.metadata.name}/status",
            self._encode(obj),
        )
        decoded = self._decode(obj.KIND, out)
        self._note_write(decoded)
        return decoded  # type: ignore[return-value]

    def delete(self, cls: Type[T], name: str) -> None:
        route = self._route(cls.KIND)
        if route.read_only:
            raise StoreError(f"{cls.KIND} is read-only through KubeStore")
        if self._has_hooks(cls.KIND):
            stored = self.try_get(cls, name)
            if stored is None:
                raise NotFoundError(f"{cls.KIND}/{name} not found")
            self._run_admission("DELETE", stored.deepcopy(), stored)
        store_requests_total.inc(verb="delete", kind=cls.KIND)
        out = self._request("DELETE", f"{route.path_prefix}/{name}")
        # Keep the cache coherent with what the DELETE actually did: the
        # server returns the object when deletion is pending on finalizers
        # (fold it back in), otherwise it was purged (drop it). A Status
        # body or undecodable response also means gone.
        if route.cacheable:
            with self._lock:
                refl = self._reflectors.get(cls.KIND)
            if refl is not None:
                try:
                    decoded = self._decode(cls.KIND, out)
                    if decoded.metadata.finalizers:
                        refl.note_write(decoded)
                    else:
                        refl.note_delete(
                            name, decoded.metadata.resource_version
                        )
                except Exception:
                    refl.note_delete(name)

    # ------------------------------------------------------------------
    # watches
    # ------------------------------------------------------------------
    def watch(self, kind: Optional[str] = None) -> "queue.Queue[WatchEvent]":
        """Store-compatible event queue fed by the shared per-kind reflector.

        kind=None multiplexes every routed kind into a single queue (the
        in-proc Store's any-kind watch). Subscribing replays the current
        cache as an ADDED snapshot, then streams live events whose types
        follow the stream lifecycle: first delivery of a name is ADDED,
        subsequent deliveries are MODIFIED, and DELETED arrives only for
        names previously surfaced. One caveat keeps consumers honest:
        after a watch gap, an object that entered the cache only via local
        write-folding (note_write) can be re-delivered as ADDED by the
        recovering relist — treat ADDED/MODIFIED as level-triggered upsert
        signals, not exactly-once lifecycle edges. N watchers share ONE
        apiserver watch connection per kind."""
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        kinds = [kind] if kind else list(self._routes)
        refls = []
        for k in kinds:
            refl = self._reflector(k)
            refl.subscribe(q)
            refls.append(refl)
        with self._lock:
            self._watches[id(q)] = refls  # type: ignore[assignment]
        return q

    def stop_watch(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            refls = self._watches.pop(id(q), [])
        for refl in refls:
            refl.unsubscribe(q)

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            self._watches.clear()
            refls = list(self._reflectors.values())
            self._reflectors.clear()
        for refl in refls:
            refl.stop()
        with self._mux_lock:
            mux, self._mux = self._mux, None
        if mux is not None:
            mux.close()
        self._cfg.cleanup()


class _WatchThread(threading.Thread):
    """One streaming watch connection, reconnecting from the last seen RV."""

    def __init__(
        self,
        store: KubeStore,
        kind: str,
        out: "queue.Queue[Any]",
        reconnect_s: float,
        emit_relist_complete: bool = False,
    ) -> None:
        super().__init__(daemon=True, name=f"kubewatch-{kind}")
        self._store = store
        self._kind = kind
        self._out = out
        self._reconnect_s = reconnect_s
        self._stop = threading.Event()
        self._resp = None
        self._emit_relist_complete = emit_relist_complete
        # Last-known object per name, maintained across the stream. Two jobs:
        # - synthesize DELETED for objects that vanished during a watch gap
        #   (client-go's DeletedFinalStateUnknown analog — without it a node
        #   deleted while the watch was down never triggers the controllers'
        #   node-GC mappers, orphaning its children).
        # - normalize event types into the per-stream lifecycle contract:
        #   the first delivery of a name is ADDED,
        #   every subsequent delivery is MODIFIED, DELETED is delivered only
        #   for names previously surfaced. Wire types are unreliable across
        #   relist/replay races (a watch replay from a historical RV can
        #   carry current state under a stale type); _known is stream-ordered
        #   truth, so consumers get a deterministic lifecycle per object.
        self._known: Dict[str, ApiObject] = {}

    def stop(self) -> None:
        self._stop.set()
        resp = self._resp
        if resp is not None:
            # A mux watch exposes shutdown(): it cancels the stream on the
            # shared socket without touching the socket itself (other verbs
            # and watches keep riding it).
            shut = getattr(resp, "shutdown", None)
            if shut is not None:
                try:
                    shut()
                except Exception:
                    pass
                return
            # HTTP watch: closing the HTTPResponse (a BufferedReader) from
            # this thread would block on the reader lock the watch thread
            # holds inside its blocked read. Shut the raw socket down
            # instead: the blocked recv returns EOF and the thread exits on
            # its own.
            try:
                import socket as _socket

                resp.fp.raw._sock.shutdown(_socket.SHUT_RDWR)  # type: ignore[union-attr]
            except Exception:
                pass

    def _relist(self) -> str:
        """client-go reflector pattern: list the collection, surface every
        item (names never seen on this stream as ADDED, the rest as a
        conservative MODIFIED — each just triggers a reconcile), return the
        list's resourceVersion to watch from. Without this, events falling
        in a 410-Gone compaction gap (or before the first watch established)
        would be lost forever: controllers only enqueue existing objects
        once at start.

        Objects we knew about that are absent from the relist were deleted
        during the gap: emit a synthetic DELETED carrying the last-known
        state so consumers (node-GC mappers, the read cache) still observe
        the deletion."""
        route = self._store._route(self._kind)
        store_requests_total.inc(verb="list", kind=self._kind)
        out = self._store._request("GET", route.path_prefix)
        listed: Dict[str, ApiObject] = {}
        for item in out.get("items", []):
            try:
                obj = self._store._decode(self._kind, item)
            except Exception:
                continue
            listed[obj.metadata.name] = obj
            self._out.put(
                WatchEvent(MODIFIED if obj.metadata.name in self._known else ADDED, obj)
            )
        for name in list(self._known):
            if name not in listed:
                self._out.put(WatchEvent(DELETED, self._known.pop(name)))
        self._known = dict(listed)
        return str((out.get("metadata") or {}).get("resourceVersion", ""))

    def run(self) -> None:
        log = logging.getLogger("kubestore.watch")
        last_rv = ""
        need_relist = True
        backoff = self._reconnect_s
        last_err_log = 0.0
        while not self._stop.is_set():
            route = self._store._route(self._kind)
            connected = False
            try:
                if need_relist:
                    last_rv = self._relist()
                    need_relist = False
                    if self._emit_relist_complete:
                        self._out.put(_RelistComplete(frozenset(self._known)))
                path = f"{route.path_prefix}?watch=true"
                if last_rv:
                    path += f"&resourceVersion={last_rv}"
                path += "&allowWatchBookmarks=true"
                # A finite socket timeout doubles as the liveness check: a
                # quiet watch raises timeout, we reconnect from last_rv (the
                # pattern client-go's reflector uses with its watch timeout).
                resp = self._store._request("GET", path, stream=True, timeout=30)
                self._resp = resp
                connected = True
                backoff = self._reconnect_s
                for raw in resp:
                    if self._stop.is_set():
                        break
                    raw = raw.strip()
                    if not raw:
                        continue
                    evt = json.loads(raw)
                    etype = evt.get("type", "")
                    item = evt.get("object", {})
                    last_rv = str(
                        (item.get("metadata") or {}).get("resourceVersion", last_rv)
                    )
                    if etype == "BOOKMARK":
                        continue
                    if etype == "ERROR":
                        # 410 Gone (compaction) → relist before re-watching
                        need_relist = True
                        break
                    if etype not in (ADDED, MODIFIED, DELETED):
                        continue
                    try:
                        obj = self._store._decode(self._kind, item)
                    except Exception:
                        continue
                    # Lifecycle normalization: _known decides the delivered
                    # type, not the wire type (see __init__ note).
                    if etype == DELETED:
                        if self._known.pop(obj.metadata.name, None) is None:
                            continue  # never surfaced on this stream
                    else:
                        etype = (
                            MODIFIED if obj.metadata.name in self._known else ADDED
                        )
                        self._known[obj.metadata.name] = obj
                    self._out.put(WatchEvent(etype, obj))
            except Exception as e:
                # A read timeout on an established quiet stream is the normal
                # reconnect path. A failure to even connect (RBAC missing the
                # watch verb, expired token) would otherwise leave the
                # operator silently event-blind: log it (rate-limited) and
                # back off instead of hammering the apiserver.
                if not connected:
                    import time as _time

                    now = _time.monotonic()
                    if not self._stop.is_set() and now - last_err_log > 30.0:
                        log.warning("watch %s failed: %s; retrying in %.1fs",
                                    self._kind, e, backoff)
                        last_err_log = now
                    backoff = min(backoff * 2, 30.0)
            finally:
                resp, self._resp = self._resp, None
                # A mux stream being abandoned (idle-timeout reconnect, 410
                # relist) must be cancelled on the shared socket, or the
                # server keeps pushing to a stream nobody reads.
                shut = getattr(resp, "shutdown", None)
                if shut is not None:
                    try:
                        shut()
                    except Exception:
                        pass
            if not self._stop.is_set():
                self._stop.wait(backoff if not connected else self._reconnect_s)


@dataclass(frozen=True)
class _RelistComplete:
    """Queue marker a _WatchThread emits after each relist: everything
    before it is the full current collection (so the cache behind it is
    synced), and `names` is that collection's exact name set — the consumer
    evicts cache entries outside it. The _known-based DELETED synthesis
    can't cover objects that entered the cache via note_write while the
    watch was down (the watch thread never saw them); this does."""

    names: frozenset


class _Reflector:
    """Shared informer for one kind: ONE watch connection feeds an in-memory
    object cache and fans events out to any number of subscriber queues.

    This is the controller-runtime cached-client / client-go SharedInformer
    analog (the reference's manager reads through exactly this:
    cmd/main.go:137-155 — only writes hit the wire). Without it every
    get/list is a wire round trip and attach latency scales with
    apiserver RTT (~36 RTTs per attach).

    Consistency model (same as an informer): reads may trail the server by
    watch latency. Two mitigations keep the controllers' read-your-writes
    assumptions intact: write *responses* are folded into the cache
    (note_write, RV-guarded so a newer watch event is never regressed), and
    events are applied in stream order by a single consumer thread."""

    def __init__(self, store: "KubeStore", kind: str, reconnect_s: float) -> None:
        self._store = store
        self._kind = kind
        self._events: "queue.Queue[Any]" = queue.Queue()
        self._cache: Dict[str, ApiObject] = {}
        # name -> rv at deletion. A write RESPONSE folded by note_write can
        # race the object's purge: without a tombstone, a response carrying
        # rv N landing after the DELETED(rv > N) pops the entry re-inserts
        # a zombie the server no longer has — controllers then reconcile a
        # child that cannot be deleted, wedging teardown (found by the
        # wire-path soak). rvs grow monotonically (ours and etcd's), so a
        # re-created same-name object always clears its tombstone.
        self._tombstones: Dict[str, int] = {}
        self._subs: List["queue.Queue[WatchEvent]"] = []
        self._lock = threading.Lock()
        self._synced = threading.Event()
        self._stopped = threading.Event()
        self._watch = _WatchThread(
            store, kind, self._events, reconnect_s, emit_relist_complete=True
        )
        self._consumer = threading.Thread(
            target=self._run, daemon=True, name=f"kubecache-{kind}"
        )

    def start(self) -> None:
        self._watch.start()
        self._consumer.start()

    def stop(self) -> None:
        self._stopped.set()
        self._watch.stop()
        self._events.put(None)  # wake the consumer so it can observe _stopped

    def _run(self) -> None:
        while not self._stopped.is_set():
            evt = self._events.get()
            if evt is None:
                continue
            if isinstance(evt, _RelistComplete):
                # The relist names are authoritative: evict anything else
                # (e.g. entries note_write folded in while the watch was in
                # a 410 gap, whose DELETED the _known synthesis can't see).
                # An object created concurrently with the relist may be
                # evicted transiently — its watch ADDED (at a later RV than
                # the relist) re-adds it.
                with self._lock:
                    for name in list(self._cache):
                        if name not in evt.names:
                            del self._cache[name]
                self._synced.set()
                continue
            name = evt.obj.metadata.name
            rv = evt.obj.metadata.resource_version
            with self._lock:
                ordered = not self._store._opaque_rv
                if evt.type == DELETED:
                    cur = self._cache.get(name)
                    # rv-guarded pop: a late DELETED for a PREVIOUS
                    # incarnation must not evict a newer same-name object a
                    # write response already folded in (transient but real
                    # read-None window). The tombstone still lands at the
                    # delete's rv — it only blocks writes <= that rv.
                    if (not ordered or cur is None
                            or cur.metadata.resource_version <= rv):
                        self._cache.pop(name, None)
                    if ordered:
                        self._note_tombstone(name, rv)
                elif not ordered:
                    # Opaque (digested) RVs are unordered: apply events in
                    # stream order unconditionally, as before tombstones.
                    self._cache[name] = evt.obj
                else:
                    cur = self._cache.get(name)
                    if (rv > self._tombstones.get(name, -1)
                            and (cur is None
                                 or cur.metadata.resource_version <= rv)):
                        self._cache[name] = evt.obj
                subs = list(self._subs)
            for q in subs:
                q.put(WatchEvent(evt.type, evt.obj.deepcopy()))

    # ------------------------------------------------------------------
    # reads (all return deepcopies — the cache is never aliased out)
    # ------------------------------------------------------------------
    def wait_synced(self, timeout: float) -> bool:
        return self._synced.wait(timeout)

    def get(self, name: str) -> Optional[ApiObject]:
        with self._lock:
            obj = self._cache.get(name)
        return obj.deepcopy() if obj is not None else None

    def list(self) -> List[ApiObject]:
        with self._lock:
            return [o.deepcopy() for o in self._cache.values()]

    # ------------------------------------------------------------------
    # write-through hints
    # ------------------------------------------------------------------
    def note_write(self, obj: ApiObject) -> None:
        """Fold a write *response* into the cache so a reconcile that writes
        then immediately re-reads sees its own write. RV-guarded: never
        regress state a newer watch event already applied, and never
        resurrect past a deletion tombstone (a response in flight while the
        object purges must not re-insert a zombie). A response whose
        deletionTimestamp is set with no finalizers left means the server
        purged the object on this write (the remove-last-finalizer PUT)."""
        name = obj.metadata.name
        rv = obj.metadata.resource_version
        purged = obj.metadata.deletion_timestamp and not obj.metadata.finalizers
        ordered = not self._store._opaque_rv
        with self._lock:
            if ordered and rv <= self._tombstones.get(name, -1):
                return  # raced a deletion the cache already observed
            cur = self._cache.get(name)
            if purged:
                if cur is None or cur.metadata.resource_version <= rv:
                    self._cache.pop(name, None)
                if ordered:
                    self._note_tombstone(name, rv)
                return
            if cur is None or cur.metadata.resource_version <= rv:
                self._cache[name] = obj.deepcopy()

    def note_delete(self, name: str, rv: Optional[int] = None) -> None:
        """``rv``: the purged object's final resourceVersion when the
        DELETE response carried one — tombstoning at it closes the
        resurrect window even when the object was never cached. Falls back
        to the cached copy's rv (blocks responses no newer than that; the
        terminating MODIFIED still lands). Residual corner: undecodable
        response AND uncached object leaves no tombstone."""
        if self._store._opaque_rv:
            with self._lock:
                self._cache.pop(name, None)
            return
        with self._lock:
            cur = self._cache.pop(name, None)
            if rv is not None:
                self._note_tombstone(name, rv)
            elif cur is not None:
                self._note_tombstone(name, cur.metadata.resource_version)

    def _note_tombstone(self, name: str, rv: int) -> None:
        """Record (monotonic max) a deletion rv; caller holds _lock."""
        rv = max(rv, self._tombstones.pop(name, -1))
        # pop-then-set moves a refreshed entry to the end of the dict, so
        # the eviction below is LRU-by-refresh: a same-name object cycling
        # under sustained churn stays hot instead of being dropped for
        # merely having been first inserted long ago.
        self._tombstones[name] = rv
        if len(self._tombstones) > 4096:
            # Bounded memory: drop the coldest half (refresh order). Old
            # tombstones only matter while writes from that object's era
            # can still be in flight — seconds, not thousands of objects.
            for key in list(self._tombstones)[:2048]:
                del self._tombstones[key]

    # ------------------------------------------------------------------
    # fan-out subscriptions (KubeStore.watch)
    # ------------------------------------------------------------------
    def subscribe(self, q: "queue.Queue[WatchEvent]") -> None:
        # Replay the current cache as ADDED under the lock so the
        # subscriber's stream is ordered (full snapshot, then live events)
        # and lifecycle-shaped: from this subscriber's viewpoint each
        # snapshot object is a first observation — the same contract
        # client-go SharedInformer gives (initial sync delivers OnAdd).
        with self._lock:
            for o in self._cache.values():
                q.put(WatchEvent(ADDED, o.deepcopy()))
            self._subs.append(q)

    def unsubscribe(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass
