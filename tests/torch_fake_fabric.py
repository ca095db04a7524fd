"""Fake fabric/pool-manager HTTP server over the PyTorch port's pool.

A copy of ``tests/fake_fabric.py`` that imports only ``tpu_composer_torch``
and serves the port's ``InMemoryPool``, whose slice path covers the NVIDIA
H100 (``nvidia-h100-sxm``) as well as TPU groups. It speaks the same wire
dialects as the original:

- the REST pool API       (tpu_composer_torch.fabric.rest)
- the layout-apply API    (tpu_composer_torch.fabric.layout)
- the Redfish API         (tpu_composer_torch.fabric.redfish)

plus ``POST /auth/token`` issuing short-lived JWTs (the token-cache 401
retry path) and the long-polled ``GET /v1/events`` stream. The H100 twins
and ``chip_smoke.py``'s ``operator_remote`` phase compose through it; the
JAX package's twins keep ``tests/fake_fabric.py``. Scenarios are injected
through explicit methods on the backing pool and a few server-level knobs.
"""
from __future__ import annotations

import base64
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from tpu_composer_torch.api.types import (
    ComposableResource,
    ComposableResourceSpec,
    ComposableResourceStatus,
    ObjectMeta,
    PendingOp,
)
from tpu_composer_torch.fabric.inmem import InMemoryPool
from tpu_composer_torch.fabric.provider import (
    FabricError,
    TransientFabricError,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
)

#: Cap on one /v1/events long-poll hold (a handler thread parks on the
#: pool's event condition for at most this long; the client re-polls).
EVENTS_LONG_POLL_CAP_S = 10.0


def _make_jwt(expires_in: float) -> str:
    def b64(obj: dict) -> str:
        raw = json.dumps(obj).encode()
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    header = b64({"alg": "none", "typ": "JWT"})
    payload = b64({"exp": int(time.time() + expires_in), "iss": "fake-fabric"})
    return f"{header}.{payload}.fakesig"


class FakeFabricServer:
    """Threaded HTTP server wrapping an InMemoryPool.

    Knobs:
    - ``require_auth``: reject requests without a currently-valid issued
      bearer token (401), enabling the token-cache/retry tests;
    - ``token_ttl``: lifetime of issued JWTs;
    - ``apply_steps``: number of status polls a layout apply stays
      IN_PROGRESS before the op executes (NEC-style latency);
    - ``fail_next(method, path_prefix, code)``: force the next matching
      request to fail with an HTTP code (API-level fault injection);
    - pool-level faults via ``self.pool`` (inject_add_failure, set_health,
      leak_attachment, async_steps...).
    """

    def __init__(
        self,
        pool: Optional[InMemoryPool] = None,
        require_auth: bool = False,
        username: str = "composer",
        password: str = "secret",
        token_ttl: float = 300.0,
        apply_steps: int = 1,
    ) -> None:
        self.pool = pool or InMemoryPool()
        self.require_auth = require_auth
        self.username = username
        self.password = password
        self.token_ttl = token_ttl
        self.apply_steps = apply_steps
        self.valid_tokens: set = set()
        self.token_requests = 0
        self.request_log: List[str] = []
        # Supervisor-side attribution ledger: one entry per MUTATING fabric
        # verb — (replica identity from X-Tpuc-Replica, monotonic receive
        # time, verb, resource names). The cross-process TaggedPool analog:
        # the partition soak asserts a fenced replica has no entries past
        # its fencing deadline.
        self.mutation_log: List[tuple] = []
        self._applies: Dict[str, dict] = {}
        self._active_apply: Optional[str] = None
        self._forced_failures: List[tuple] = []
        self._lock = threading.RLock()

        server = self

        class Handler(_FabricHandler):
            fabric = server

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-fabric", daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    @property
    def token_url(self) -> str:
        return self.url + "/auth/token"

    def fail_next(self, method: str, path_prefix: str, code: int = 500) -> None:
        with self._lock:
            self._forced_failures.append((method.upper(), path_prefix, code))

    def revoke_tokens(self) -> None:
        """Invalidate every issued token (tests the 401 -> refresh path)."""
        with self._lock:
            self.valid_tokens.clear()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class _FabricHandler(BaseHTTPRequestHandler):
    fabric: FakeFabricServer

    # -- plumbing ----------------------------------------------------------
    def log_message(self, *args):  # quiet
        pass

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        try:
            return json.loads(self.rfile.read(length))
        except ValueError:
            return {}

    def _send(self, code: int, payload: Optional[dict] = None) -> None:
        data = json.dumps(payload or {}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _tag(self, verb: str, names: List[str]) -> None:
        """Record a mutating verb in the supervisor-side attribution
        ledger, stamped with the calling replica's X-Tpuc-Replica header
        (httpx adds it from $FABRIC_IDENTITY) — logged BEFORE the pool
        call, like TaggedPool, so even a half-executed mutation is
        attributed."""
        identity = self.headers.get("X-Tpuc-Replica", "")
        with self.fabric._lock:
            self.fabric.mutation_log.append(
                (identity, time.monotonic(), verb, list(names))
            )

    def _authorized(self, path: str) -> bool:
        if not self.fabric.require_auth or path == "/auth/token":
            return True
        auth = self.headers.get("Authorization", "")
        return auth.startswith("Bearer ") and auth[7:] in self.fabric.valid_tokens

    def _route(self, method: str) -> None:
        path, _, query = self.path.partition("?")
        wait = "wait=true" in query
        self._params = dict(
            pair.split("=", 1) for pair in query.split("&") if "=" in pair
        )
        f = self.fabric
        with f._lock:
            f.request_log.append(f"{method} {path}")
            for i, (m, prefix, code) in enumerate(f._forced_failures):
                if m == method and path.startswith(prefix):
                    f._forced_failures.pop(i)
                    self._send(code, {"error": f"injected {code}"})
                    return
        if not self._authorized(path):
            self._send(401, {"error": "invalid or missing token"})
            return
        try:
            self._dispatch(method, path, wait)
        except BrokenPipeError:  # client gave up; nothing to answer
            pass

    do_GET = lambda self: self._route("GET")  # noqa: E731
    do_PUT = lambda self: self._route("PUT")  # noqa: E731
    do_POST = lambda self: self._route("POST")  # noqa: E731
    do_PATCH = lambda self: self._route("PATCH")  # noqa: E731
    do_DELETE = lambda self: self._route("DELETE")  # noqa: E731

    # -- routing -----------------------------------------------------------
    def _dispatch(self, method: str, path: str, wait: bool) -> None:
        if path == "/auth/token" and method == "POST":
            return self._handle_token()
        # Strip optional /v1/tenants/{t}/clusters/{c} multi-tenant prefix.
        parts = [p for p in path.split("/") if p]
        if len(parts) >= 5 and parts[0] == "v1" and parts[1] == "tenants" and parts[3] == "clusters":
            parts = ["v1"] + parts[5:]
        if parts and parts[0] == "v1":
            return self._dispatch_pool(method, parts[1:], wait)
        if parts and parts[0] == "redfish":
            return self._dispatch_redfish(method, parts[2:])  # drop redfish/v1
        self._send(404, {"error": f"no route for {method} {path}"})

    def _handle_token(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        form = self.rfile.read(length).decode()
        fields = dict(
            pair.split("=", 1) for pair in form.split("&") if "=" in pair
        )
        f = self.fabric
        with f._lock:
            f.token_requests += 1
        if (
            fields.get("username") != f.username
            or fields.get("password") != f.password
        ):
            return self._send(401, {"error": "invalid_grant"})
        token = _make_jwt(f.token_ttl)
        with f._lock:
            f.valid_tokens.add(token)
        self._send(200, {"access_token": token, "expires_in": f.token_ttl})

    # -- pool API (rest.py + layout.py) ------------------------------------
    def _dispatch_pool(self, method: str, parts: List[str], wait: bool) -> None:
        pool = self.fabric.pool
        if parts[:1] == ["slices"] and len(parts) == 2:
            name = parts[1]
            if method == "PUT":
                body = self._body()
                try:
                    pool.reserve_slice(
                        name, body.get("model", ""), body.get("topology", ""),
                        list(body.get("nodes", [])),
                    )
                except FabricError as e:
                    return self._send(409, {"error": str(e)})
                return self._send(201, {"name": name})
            if method == "PATCH":
                # Live resize: surviving hosts keep their chip groups.
                body = self._body()
                try:
                    pool.resize_slice(
                        name, body.get("model", ""), body.get("topology", ""),
                        list(body.get("nodes", [])),
                    )
                except FabricError as e:
                    return self._send(409, {"error": str(e)})
                return self._send(200, {"name": name})
            if method == "DELETE":
                # Strict server behavior: unknown slice is 404 (clients must
                # treat release as idempotent on their side).
                if not pool.has_slice(name):
                    return self._send(404, {"error": f"no slice {name}"})
                pool.release_slice(name)
                return self._send(204)
        if parts == ["events"] and method == "GET":
            # Event-plane subscription (rest.py poll_events): long-poll the
            # pool's sequence-numbered stream from the resume cursor.
            try:
                cursor = int(self._params.get("cursor", "-1"))
            except ValueError:
                cursor = -1
            try:
                timeout = float(self._params.get("timeout", "5"))
            except ValueError:
                timeout = 5.0
            events, next_cursor = pool.poll_events(
                cursor, timeout=max(0.0, min(timeout, EVENTS_LONG_POLL_CAP_S))
            )
            return self._send(200, {
                "events": [e.to_wire() for e in events],
                "cursor": next_cursor,
            })
        if parts == ["attachments:batch"] and method == "POST":
            return self._attachment_batch(wait)
        if parts == ["attachments"] and method == "GET":
            items = [
                {
                    "device_id": d.device_id,
                    "node": d.node,
                    "model": d.model,
                    "slice": d.slice_name,
                    "type": d.type,
                    "resource": d.resource_name,
                    "health": {"state": d.health.state, "detail": d.health.detail},
                }
                for d in pool.get_resources()
            ]
            return self._send(200, {"attachments": items})
        if parts[:1] == ["attachments"] and len(parts) == 2:
            return self._attachment_crud(method, parts[1], wait)
        if parts[:1] == ["attachments"] and len(parts) == 3 and parts[2] == "health":
            rec = pool.attachment_record(parts[1])
            if rec is None:
                return self._send(404, {"error": "not attached"})
            health = pool.check_resource(_dummy_resource(parts[1]))
            return self._send(200, {"state": health.state, "detail": health.detail})
        if parts == ["layout-apply"] and method == "POST":
            return self._layout_submit()
        if parts[:1] == ["layout-apply"] and len(parts) == 2 and method == "GET":
            return self._layout_status(parts[1])
        self._send(404, {"error": f"no pool route for {method} /{'/'.join(parts)}"})

    def _attachment_batch(self, wait: bool) -> None:
        """Group attach/detach (rest.py add_resources/remove_resources):
        one request carries a whole per-node wave, the response reports
        PER-MEMBER outcomes so one bad device degrades one member."""
        pool = self.fabric.pool
        body = self._body()
        op = body.get("op", "")
        if op not in ("add", "remove"):
            return self._send(400, {"error": f"bad batch op {op!r}"})
        self._tag(f"batch-{op}",
                  [item.get("name", "") for item in body.get("items", [])])
        results: List[dict] = []
        for item in body.get("items", []):
            name = item.get("name", "")
            try:
                if op == "add":
                    resource = _resource_from_body(name, item)
                    result = _maybe_wait(
                        lambda: pool.add_resource(resource),
                        wait, WaitingDeviceAttaching,
                    )
                    results.append({
                        "name": name,
                        "device_ids": result.device_ids,
                        "cdi_device_id": result.cdi_device_id,
                    })
                else:
                    resource = _dummy_resource(
                        name, device_ids=list(item.get("device_ids", [])),
                        nonce=str(item.get("nonce", "")),
                    )
                    _maybe_wait(
                        lambda: pool.remove_resource(resource),
                        wait, WaitingDeviceDetaching,
                    )
                    results.append({"name": name, "removed": True})
            except WaitingDeviceAttaching:
                results.append({"name": name, "state": "attaching"})
            except WaitingDeviceDetaching:
                results.append({"name": name, "state": "detaching"})
            except TransientFabricError as e:
                results.append({"name": name, "error": str(e), "transient": True})
            except FabricError as e:
                results.append({"name": name, "error": str(e), "transient": False})
        self._send(200, {"results": results})

    def _attachment_crud(self, method: str, name: str, wait: bool) -> None:
        pool = self.fabric.pool
        if method == "GET":
            rec = pool.attachment_record(name)
            if rec is None:
                return self._send(404, {"error": "not attached"})
            return self._send(200, rec)
        if method == "PUT":
            resource = _resource_from_body(name, self._body())
            self._tag("attach", [name])
            try:
                result = _maybe_wait(
                    lambda: pool.add_resource(resource), wait, WaitingDeviceAttaching
                )
            except WaitingDeviceAttaching as e:
                return self._send(202, {"state": "attaching", "detail": str(e)})
            except FabricError as e:
                return self._send(409, {"error": str(e)})
            return self._send(
                200,
                {"device_ids": result.device_ids, "cdi_device_id": result.cdi_device_id},
            )
        if method == "DELETE":
            body = self._body()
            resource = _dummy_resource(name, device_ids=list(body.get("device_ids", [])),
                                       nonce=str(body.get("nonce", "")))
            self._tag("detach", [name])
            try:
                _maybe_wait(
                    lambda: pool.remove_resource(resource), wait, WaitingDeviceDetaching
                )
            except WaitingDeviceDetaching as e:
                return self._send(202, {"state": "detaching", "detail": str(e)})
            except FabricError as e:
                return self._send(409, {"error": str(e)})
            return self._send(204)
        self._send(405, {"error": f"{method} not allowed"})

    # -- layout-apply workflow ---------------------------------------------
    def _layout_submit(self) -> None:
        f = self.fabric
        body = self._body()
        with f._lock:
            if f._active_apply is not None:
                return self._send(409, {"code": "APPLY_IN_PROGRESS",
                                        "error": "another layout apply is running"})
            apply_id = uuid.uuid4().hex[:12]
            f._applies[apply_id] = {
                "body": body,
                "polls_left": f.apply_steps,
                "status": "IN_PROGRESS",
                "detail": "",
            }
            f._active_apply = apply_id
        self._send(202, {"apply_id": apply_id})

    def _layout_status(self, apply_id: str) -> None:
        f = self.fabric
        with f._lock:
            rec = f._applies.get(apply_id)
            if rec is None:
                return self._send(404, {"error": f"unknown apply {apply_id}"})
            if rec["status"] != "IN_PROGRESS":
                return self._send(200, {"status": rec["status"], "detail": rec["detail"]})
            rec["polls_left"] -= 1
            if rec["polls_left"] > 0:
                return self._send(200, {"status": "IN_PROGRESS"})
            body = rec["body"]
            op = body.get("operation", "")
            name = body.get("resource", "")
            self._tag(f"layout-{op}", [name])
            try:
                if op == "connect":
                    f.pool.add_resource(_resource_from_body(name, body))
                else:
                    f.pool.remove_resource(
                        _dummy_resource(name, device_ids=list(body.get("device_ids", [])))
                    )
                rec["status"] = "COMPLETED"
            except (WaitingDeviceAttaching, WaitingDeviceDetaching):
                rec["polls_left"] = 1  # pool still async; stay IN_PROGRESS
                return self._send(200, {"status": "IN_PROGRESS"})
            except FabricError as e:
                rec["status"] = "FAILED"
                rec["detail"] = str(e)
            f._active_apply = None
            self._send(200, {"status": rec["status"], "detail": rec["detail"]})

    # -- Redfish dialect ----------------------------------------------------
    def _dispatch_redfish(self, method: str, parts: List[str]) -> None:
        pool = self.fabric.pool
        if parts == ["Systems"] and method == "GET":
            nodes = sorted({d.node for d in pool.get_resources()})
            return self._send(
                200,
                {"Members": [{"Id": n, "@odata.id": f"/redfish/v1/Systems/{n}"}
                             for n in nodes]},
            )
        if parts[:1] == ["Systems"] and len(parts) == 2:
            node = parts[1]
            if method == "GET":
                return self._send(200, {"Id": node,
                                        "Accelerators": self._redfish_blocks(node)})
            if method == "PATCH":
                return self._redfish_patch(node, self._body())
        if parts[:2] == ["CompositionService", "ResourceZones"] and len(parts) == 3:
            name = parts[2]
            if method == "PUT":
                body = self._body()
                try:
                    pool.reserve_slice(
                        name, body.get("Model", ""), body.get("Topology", ""),
                        list(body.get("Nodes", [])),
                    )
                except FabricError as e:
                    return self._send(409, {"error": str(e)})
                return self._send(201, {"Id": name})
            if method == "DELETE":
                if not pool.has_slice(name):
                    return self._send(404, {"error": f"no zone {name}"})
                pool.release_slice(name)
                return self._send(204)
        self._send(404, {"error": f"no redfish route for {method} /{'/'.join(parts)}"})

    def _redfish_blocks(self, node: str) -> List[dict]:
        pool = self.fabric.pool
        by_resource: Dict[str, dict] = {}
        for d in pool.get_resources():
            if d.node != node:
                continue
            owner = _owner_of(pool, d.device_id)
            rec_name = owner or d.device_id
            block = by_resource.setdefault(
                rec_name,
                # Leaked devices (no owning attachment) get an UNLABELED
                # block — a "" Resource must read as "unowned", never as a
                # resource coincidentally named like a device id.
                {"Resource": owner or "", "Model": d.model,
                 "Slice": d.slice_name, "Type": d.type,
                 "DeviceIds": [], "CDIDeviceId": "",
                 "Status": {"Health": "OK", "Detail": ""}},
            )
            block["DeviceIds"].append(d.device_id)
            rank = {"OK": 0, "Warning": 1, "Critical": 2}
            # Unknown states rank Critical on BOTH sides (conformance:
            # a non-standard health string must never read as healthy —
            # defaulting to 0 here collapsed it to OK before the client
            # could rank it).
            if rank.get(d.health.state, 2) > rank.get(
                block["Status"]["Health"], 2
            ):
                block["Status"] = {"Health": d.health.state, "Detail": d.health.detail}
            rec = pool.attachment_record(rec_name)
            if rec:
                block["CDIDeviceId"] = rec["cdi_device_id"]
        return list(by_resource.values())

    def _redfish_patch(self, node: str, body: dict) -> None:
        pool = self.fabric.pool
        acc = body.get("Accelerators", {})
        if "AddMembers" in acc or "RemoveMembers" in acc:
            return self._redfish_patch_members(node, acc)
        if "Add" in acc:
            add = acc["Add"]
            resource = _resource_from_body(
                add.get("Resource", ""),
                {"node": node, "model": add.get("Model", ""),
                 "chip_count": add.get("Count", 1), "slice": add.get("Slice", ""),
                 "worker_id": add.get("WorkerId", 0)},
            )
            try:
                result = pool.add_resource(resource)
            except WaitingDeviceAttaching:
                return self._send(202, {})
            except FabricError as e:
                return self._send(400, {"error": str(e)})
            return self._send(200, {"Id": node, "Accelerators": [{
                "Resource": resource.metadata.name,
                "Model": resource.spec.model,
                "DeviceIds": result.device_ids,
                "CDIDeviceId": result.cdi_device_id,
                "Slice": resource.spec.slice_name,
                "Status": {"Health": "OK"},
            }]})
        if "Remove" in acc:
            rm = acc["Remove"]
            resource = _dummy_resource(
                rm.get("Resource", ""), node=node,
                device_ids=list(rm.get("DeviceIds", [])),
            )
            try:
                pool.remove_resource(resource)
            except WaitingDeviceDetaching:
                return self._send(202, {})
            except FabricError as e:
                return self._send(400, {"error": str(e)})
            return self._send(200, {"Id": node})
        self._send(400, {"error": "PATCH body needs Accelerators.Add or .Remove"})

    def _redfish_patch_members(self, node: str, acc: dict) -> None:
        """Member-batch composition (redfish.py add_resources/
        remove_resources): one PATCH carries a per-node wave; the 200
        response reports PER-MEMBER outcome records so one bad accelerator
        degrades one member, never the wave."""
        pool = self.fabric.pool
        adding = "AddMembers" in acc
        members = acc.get("AddMembers" if adding else "RemoveMembers", [])
        self._tag(
            "redfish-add" if adding else "redfish-remove",
            [m.get("Resource", "") for m in members],
        )
        results: List[dict] = []
        for m in acc.get("AddMembers" if adding else "RemoveMembers", []):
            name = m.get("Resource", "")
            try:
                if adding:
                    resource = _resource_from_body(name, {
                        "node": node, "model": m.get("Model", ""),
                        "chip_count": m.get("Count", 1),
                        "slice": m.get("Slice", ""),
                        "worker_id": m.get("WorkerId", 0),
                        "nonce": m.get("Nonce", ""),
                    })
                    result = pool.add_resource(resource)
                    results.append({
                        "Resource": name,
                        "DeviceIds": result.device_ids,
                        "CDIDeviceId": result.cdi_device_id,
                        "Slice": resource.spec.slice_name,
                        "Status": {"Health": "OK"},
                    })
                else:
                    pool.remove_resource(_dummy_resource(
                        name, node=node,
                        device_ids=list(m.get("DeviceIds", [])),
                        nonce=str(m.get("Nonce", "")),
                    ))
                    results.append({"Resource": name, "Removed": True})
            except WaitingDeviceAttaching:
                results.append({"Resource": name, "State": "attaching"})
            except WaitingDeviceDetaching:
                results.append({"Resource": name, "State": "detaching"})
            except TransientFabricError as e:
                results.append({"Resource": name, "Error": str(e),
                                "Transient": True})
            except FabricError as e:
                results.append({"Resource": name, "Error": str(e),
                                "Transient": False})
        self._send(200, {"Id": node, "Results": results})


# -- helpers ----------------------------------------------------------------

def _resource_from_body(name: str, body: dict) -> ComposableResource:
    # The wire nonce (the client's durable intent id) rides into
    # status.pending_op so the pool's op_completed events carry it back —
    # the event-plane completion key.
    status = ComposableResourceStatus()
    if body.get("nonce"):
        status.pending_op = PendingOp(verb="add", nonce=str(body["nonce"]))
    return ComposableResource(
        metadata=ObjectMeta(name=name),
        spec=ComposableResourceSpec(
            type=body.get("type", "tpu"),
            model=body.get("model", ""),
            target_node=body.get("node", ""),
            chip_count=int(body.get("chip_count", 1)),
            slice_name=body.get("slice", ""),
            worker_id=int(body.get("worker_id", 0)),
            topology=body.get("topology", ""),
        ),
        status=status,
    )


def _dummy_resource(
    name: str, node: str = "", device_ids: Optional[List[str]] = None,
    nonce: str = "",
) -> ComposableResource:
    status = ComposableResourceStatus(device_ids=device_ids or [])
    if nonce:
        status.pending_op = PendingOp(verb="remove", nonce=nonce)
    return ComposableResource(
        metadata=ObjectMeta(name=name),
        spec=ComposableResourceSpec(model="any", target_node=node or "any"),
        status=status,
    )


def _maybe_wait(fn, wait: bool, sentinel: type, max_polls: int = 1000):
    """wait=true (FM-style): drive the pool's async steps to completion
    inline instead of surfacing 202s."""
    while True:
        try:
            return fn()
        except sentinel:
            if not wait:
                raise
            max_polls -= 1
            if max_polls <= 0:
                raise


def _owner_of(pool: InMemoryPool, device_id: str) -> Optional[str]:
    with pool._lock:
        for name, att in pool._attachments.items():
            if device_id in att.device_ids:
                return name
    return None
