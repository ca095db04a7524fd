"""AdmissionReview HTTP(S) server — the wire side of the admission chain
(port of ``tpu_composer/admission/server.py``).

The reference serves its validating webhook through controller-runtime's
webhook server on :9443 with cert-manager TLS (cmd/main.go:101-103,:196-201;
the test suite stands up the real server and waits for TLS readiness,
webhook_suite_test.go:74-144). This module is that server for our two
webhooks, speaking `admission.k8s.io/v1` AdmissionReview JSON:

- ``/validate-tpu-composer-dev-v1alpha1-composabilityrequest``
  (deploy/webhook.yaml ValidatingWebhookConfiguration): decodes the
  embedded ComposabilityRequest, runs the same ``validate_request`` rules
  the in-process hook enforces, answers allowed/denied.
- ``/mutate-v1-pod`` (MutatingWebhookConfiguration): for Pods labeled
  ``tpu.composer.dev/composability-request``, looks up the request's
  authoritative ``status.slice`` and returns a JSONPatch injecting the
  coordinate env + node pin (coordinates.inject_pod_env). The slice
  block in status is the single source of truth, so the patch can never
  disagree with the allocation. For an H100 slice the env is torchrun's
  (``coordinates.slice_env``'s GPU branch).

TLS: pass cert/key paths (the cert-manager mounted secret) to serve HTTPS;
without them the server speaks plain HTTP (in-cluster test setups,
port-forward debugging).
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import socket
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpu_composer_torch.admission.coordinates import (
    LABEL_INJECT,
    LABEL_WORKER_ID,
    inject_pod_env,
)
from tpu_composer_torch.admission.validating import AdmissionDenied, validate_request
from tpu_composer_torch.api.scheme import default_scheme
from tpu_composer_torch.api.types import ComposabilityRequest
from tpu_composer_torch.runtime.store import Store

VALIDATE_PATH = "/validate-tpu-composer-dev-v1alpha1-composabilityrequest"
MUTATE_PATH = "/mutate-v1-pod"


def make_server_tls_context(certfile: str, keyfile: Optional[str]) -> ssl.SSLContext:
    """Server-side TLS context from a cert/key pair — shared by the
    admission webhook and the secure metrics endpoint so cert-handling
    fixes land in one place."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


class _TlsPerConnectionServer(ThreadingHTTPServer):
    """TLS handshakes happen per connection in the worker thread, never in
    the accept loop: wrapping the *listening* socket makes SSLSocket.accept
    run do_handshake in serve_forever's thread, so one client stalling
    mid-handshake (half-open connection, port scanner) would block every
    subsequent AdmissionReview — and with failurePolicy Fail that wedges
    all CR admission cluster-wide."""

    ssl_context: Optional[ssl.SSLContext] = None
    daemon_threads = True
    handshake_timeout = 10.0
    # Post-handshake read timeout: long enough for the API server's
    # keep-alive reuse, short enough that dead peers release threads.
    io_timeout = 65.0

    def finish_request(self, request, client_address):
        if self.ssl_context is not None:
            request.settimeout(self.handshake_timeout)
            try:
                request = self.ssl_context.wrap_socket(request, server_side=True)
            except (ssl.SSLError, OSError):
                try:
                    request.close()
                except OSError:
                    pass
                return
            # wrap_socket detached the original socket, so ThreadingMixIn's
            # shutdown_request (which still holds the pre-wrap object) can
            # never shut the wrapped SSLSocket down — do it here, and reset
            # the handshake timeout so idle keep-alive connections are not
            # killed after 10s.
            request.settimeout(self.io_timeout)
            try:
                super().finish_request(request, client_address)
            finally:
                try:
                    request.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                try:
                    request.close()
                except OSError:
                    pass
            return
        super().finish_request(request, client_address)

    def handle_error(self, request, client_address):
        """Expected disconnects (client closed mid-request, TLS teardown,
        idle timeout) are connection noise, not server errors — log at debug
        instead of dumping tracebacks to stderr."""
        import sys

        exc = sys.exception()
        if isinstance(exc, (ConnectionError, TimeoutError, ssl.SSLError, OSError)):
            logging.getLogger("AdmissionServer").debug(
                "connection from %s dropped: %s", client_address, exc
            )
            return
        super().handle_error(request, client_address)


def _review_response(uid: str, allowed: bool, message: str = "",
                     patch: Optional[list] = None) -> dict:
    response: dict = {"uid": uid, "allowed": allowed}
    if message:
        response["status"] = {"message": message}
    if patch is not None:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


class AdmissionServer:
    """Serves both webhooks for one Store."""

    def __init__(
        self,
        store: Store,
        bind: str = "127.0.0.1:0",
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
    ) -> None:
        self.store = store
        self.log = logging.getLogger("AdmissionServer")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802 — readiness for the Service probe
                if self.path == "/healthz":
                    return self._send(200, {"ok": True})
                self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    review = json.loads(self.rfile.read(length)) if length else {}
                except ValueError:
                    return self._send(400, {"error": "bad JSON body"})
                request = review.get("request") or {}
                uid = request.get("uid", "")
                if self.path == VALIDATE_PATH:
                    return self._send(200, server._validate(uid, request))
                if self.path == MUTATE_PATH:
                    return self._send(200, server._mutate(uid, request))
                self._send(404, {"error": f"no webhook at {self.path}"})

            def _send(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        host, _, port = bind.rpartition(":")
        # ":9443"-style binds (the deploy manifest form) listen on all
        # interfaces, like the manager's health server.
        self._httpd = _TlsPerConnectionServer(
            (host or ("0.0.0.0" if bind.startswith(":") else "127.0.0.1"),
             int(port)),
            Handler,
        )
        if certfile:
            self._httpd.ssl_context = make_server_tls_context(certfile, keyfile)
        self.tls = bool(certfile)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _validate(self, uid: str, request: dict) -> dict:
        try:
            obj = default_scheme().decode(request.get("object") or {})
            if not isinstance(obj, ComposabilityRequest):
                raise AdmissionDenied(
                    f"unexpected kind {type(obj).__name__} at {VALIDATE_PATH}"
                )
            obj.spec.validate()
            validate_request(self.store, obj)
        except Exception as e:
            return _review_response(uid, False, str(e))
        return _review_response(uid, True)

    def _mutate(self, uid: str, request: dict) -> dict:
        pod = request.get("object") or {}
        labels = (pod.get("metadata") or {}).get("labels") or {}
        req_name = labels.get(LABEL_INJECT, "")
        if not req_name:
            return _review_response(uid, True)  # not opted in — no patch
        req = self.store.try_get(ComposabilityRequest, req_name)
        if req is None or not req.status.slice.name:
            # failurePolicy: Ignore — admit unpatched rather than block pods
            # racing the allocation; the workload will crash-loop and retry
            # until the slice is Running.
            return _review_response(
                uid, True,
                f"request {req_name!r} not found or slice not allocated yet",
            )
        try:
            worker_id = int(labels.get(LABEL_WORKER_ID, "0"))
        except ValueError:
            return _review_response(uid, False,
                                    f"bad {LABEL_WORKER_ID} label")
        patched = inject_pod_env(
            copy.deepcopy(pod), req.status.slice, worker_id,
            req.spec.resource.model,
        )
        patch = [{"op": "replace", "path": "/spec", "value": patched["spec"]}]
        return _review_response(uid, True, patch=patch)

    # ------------------------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self._httpd.server_address
        return f"{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="admission-webhook", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # Manager runnable form (mgr.add_runnable(server.run)).
    def run(self, stop_event: threading.Event) -> None:
        self.start()
        stop_event.wait()
        self.stop()
