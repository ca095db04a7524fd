"""REST TPU pool-manager client — the primary remote fabric backend.

Port of ``tpu_composer/fabric/rest.py``: the same wire format, defaults,
error classes and metric names.

Reference analogs: the FTI Cluster-Manager client (internal/cdi/fti/cm/
client.go) and Fabric-Manager client (internal/cdi/fti/fm/client.go). Those
speak a machine-resize API ("this machine now owns N+1 GPUs"); a TPU pool
manager instead deals in *slices* (atomic ICI-connected reservations) and
*chip-group attachments*, so the wire API here is designed around those
nouns rather than translated:

    PUT    /v1/slices/{name}            {model, topology, nodes}   reserve
    DELETE /v1/slices/{name}                                       release
    PUT    /v1/attachments/{resource}   {node, model, ...}         attach
    DELETE /v1/attachments/{resource}   {device_ids: [...]}        detach
    GET    /v1/attachments/{resource}/health                       health
    GET    /v1/attachments                                         list all

(with an optional /v1/tenants/{t}/clusters/{c} path prefix mirroring the
reference's multi-tenant URL layout, cm/client.go:95-97).

The CM/FM split survives as one flag, because it is really one semantic bit:
- ``synchronous=False`` (CM-style, fti/cm/client.go:140-186): attach/detach
  return 202 while the fabric works; the client raises the wait sentinels
  and the controller requeues — completion is observed by a later idempotent
  re-PUT (the ADD_COMPLETE re-scan, cm/client.go:445-472).
- ``synchronous=True`` (FM-style, fti/fm/client.go:100-214): the request is
  sent with ``?wait=true`` asking the server to complete inline, with the
  reference FM's longer 180s timeout (fm/client.go:47).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.events import FabricEvent
from tpu_composer_torch.fabric.httpx import HttpStatusError, JsonHttpClient, fabric_timeout
from tpu_composer_torch.fabric.poolapi import PoolApiMixin
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    FabricError,
    FabricProvider,
    TransientFabricError,
    UnsupportedBatch,
    UnsupportedEvents,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
    classify_fabric_error,
    intent_nonce as _intent_nonce,
)
from tpu_composer_torch.fabric.token import TokenCache

# Reference HTTP timeouts: CM 60s (cm/client.go:50), FM 180s (fm/client.go:47).
CM_TIMEOUT_S = 60.0
FM_TIMEOUT_S = 180.0


class RestPoolClient(PoolApiMixin, FabricProvider):
    def __init__(
        self,
        endpoint: str,
        tenant_id: str = "",
        cluster_id: str = "",
        synchronous: bool = False,
        token_cache: Optional[TokenCache] = None,
        timeout: Optional[float] = None,
    ) -> None:
        if timeout is None:
            timeout = fabric_timeout(FM_TIMEOUT_S if synchronous else CM_TIMEOUT_S)
        if token_cache is None:
            token_cache = TokenCache.from_env()
        self.synchronous = synchronous
        prefix = ""
        if tenant_id and cluster_id:
            prefix = f"/v1/tenants/{tenant_id}/clusters/{cluster_id}"
        else:
            prefix = "/v1"
        self._http = JsonHttpClient(
            endpoint.rstrip("/") + prefix, token_cache=token_cache, timeout=timeout
        )

    # (slices, health, listing come from PoolApiMixin)

    # -- attachment lifecycle ---------------------------------------------
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        spec = resource.spec
        name = resource.metadata.name
        body: Dict[str, object] = {
            "type": spec.type,
            "node": spec.target_node,
            "model": spec.model,
            "chip_count": spec.chip_count,
        }
        if spec.slice_name:
            body["slice"] = spec.slice_name
            body["worker_id"] = spec.worker_id
            body["topology"] = spec.topology
        # The durable intent nonce rides the mutation so the pool's
        # op_completed event (GET /v1/events) can key the completion back
        # to this exact logical op.
        nonce = _intent_nonce(resource)
        if nonce:
            body["nonce"] = nonce
        try:
            status, payload = self._http.request(
                "PUT", f"/attachments/{name}" + self._wait_qs(), body
            )
        except HttpStatusError as e:
            raise classify_fabric_error(e, f"attach {name}: {e}") from e
        if status == 202:
            raise WaitingDeviceAttaching(
                f"{name}: attach in progress ({payload.get('state', 'attaching')})"
            )
        device_ids = list(payload.get("device_ids", []))
        cdi = payload.get("cdi_device_id", "")
        if not device_ids:
            raise FabricError(f"attach {name}: fabric returned no device ids")
        return AttachResult(device_ids=device_ids, cdi_device_id=cdi)

    def remove_resource(self, resource: ComposableResource) -> None:
        name = resource.metadata.name
        # DELETE carries the known device ids so the pool can release an
        # orphaned attachment recorded under a different resource name (the
        # syncer's ready-to-detach flow); the reference FM likewise sends a
        # DELETE body naming the device (fm/client.go:250-311).
        body = (
            {"device_ids": list(resource.status.device_ids)}
            if resource.status.device_ids
            else None
        )
        nonce = _intent_nonce(resource)
        if nonce:
            body = dict(body or {})
            body["nonce"] = nonce
        try:
            status, payload = self._http.request(
                "DELETE", f"/attachments/{name}" + self._wait_qs(), body
            )
        except HttpStatusError as e:
            if e.code == 404:
                return  # unknown attachment: idempotent no-op
            raise classify_fabric_error(e, f"detach {name}: {e}") from e
        if status == 202:
            raise WaitingDeviceDetaching(
                f"{name}: detach in progress ({payload.get('state', 'detaching')})"
            )

    # -- group verbs (fabric I/O pipeline) --------------------------------
    # One POST carries a whole per-node wave:
    #
    #     POST /v1/attachments:batch   {op: add|remove, items: [...]}
    #
    # and the 200 response reports PER-MEMBER outcomes ({device_ids,...} |
    # {state: attaching|detaching} | {error, transient}), so one bad device
    # degrades one member, not the wave. A pool service without the route
    # (404/405/501) surfaces as UnsupportedBatch and the dispatcher falls
    # back to per-item calls; a transport fault fails the whole call and
    # the dispatcher split-retries member-by-member.
    def add_resources(self, resources: List[ComposableResource]) -> List[object]:
        return self._batch("add", resources)

    def remove_resources(self, resources: List[ComposableResource]) -> List[object]:
        return self._batch("remove", resources)

    def _batch(self, op: str, resources: List[ComposableResource]) -> List[object]:
        items: List[Dict[str, object]] = []
        for r in resources:
            if op == "add":
                spec = r.spec
                item: Dict[str, object] = {
                    "name": r.metadata.name,
                    "type": spec.type,
                    "node": spec.target_node,
                    "model": spec.model,
                    "chip_count": spec.chip_count,
                }
                if spec.slice_name:
                    item["slice"] = spec.slice_name
                    item["worker_id"] = spec.worker_id
                    item["topology"] = spec.topology
            else:
                item = {
                    "name": r.metadata.name,
                    "device_ids": list(r.status.device_ids),
                }
            nonce = _intent_nonce(r)
            if nonce:
                item["nonce"] = nonce
            items.append(item)
        try:
            _, payload = self._http.request(
                "POST", "/attachments:batch" + self._wait_qs(),
                {"op": op, "items": items},
            )
        except HttpStatusError as e:
            if e.code in (404, 405, 501):
                raise UnsupportedBatch(
                    f"pool service has no batch endpoint ({e.code})"
                ) from None
            raise classify_fabric_error(e, f"batch {op}: {e}") from e
        results = {
            rec.get("name"): rec
            for rec in payload.get("results", [])
            if isinstance(rec, dict)
        }
        return [
            self._batch_outcome(op, r.metadata.name, results.get(r.metadata.name))
            for r in resources
        ]

    @staticmethod
    def _batch_outcome(op: str, name: str, rec: Optional[Dict]) -> object:
        if rec is None:
            # A member the service silently dropped is retryable — the
            # dispatcher's next pass re-submits it individually.
            return TransientFabricError(
                f"batch {op} {name}: pool service returned no result"
            )
        if rec.get("error"):
            cls = TransientFabricError if rec.get("transient") else FabricError
            return cls(f"{op} {name}: {rec['error']}")
        state = rec.get("state", "")
        if state == "attaching":
            return WaitingDeviceAttaching(f"{name}: attach in progress")
        if state == "detaching":
            return WaitingDeviceDetaching(f"{name}: detach in progress")
        if op == "remove":
            return None
        device_ids = list(rec.get("device_ids", []))
        if not device_ids:
            return FabricError(f"attach {name}: fabric returned no device ids")
        return AttachResult(
            device_ids=device_ids, cdi_device_id=rec.get("cdi_device_id", "")
        )

    # -- event plane (fabric event session) -------------------------------
    # One persistent subscription per endpoint:
    #
    #     GET /v1/events?cursor=N&timeout=T
    #
    # long-polls the pool service's sequence-numbered event stream and
    # answers {"events": [...], "cursor": M} — a batch of everything past
    # the resume cursor, or an empty batch after T seconds of silence (the
    # FabricSession immediately re-polls, so the connection is logically
    # persistent). A pool service without the route (404/405/501) surfaces
    # as UnsupportedEvents: the session goes dormant and the dispatcher's
    # poll timers stay primary.
    def poll_events(self, cursor: int, timeout: float = 5.0):
        try:
            _, payload = self._http.request(
                "GET", f"/events?cursor={int(cursor)}&timeout={timeout:g}"
            )
        except HttpStatusError as e:
            if e.code in (404, 405, 501):
                raise UnsupportedEvents(
                    f"pool service has no event stream ({e.code})"
                ) from None
            raise classify_fabric_error(e, f"poll_events: {e}") from e
        events = [
            FabricEvent.from_wire(d)
            for d in payload.get("events", [])
            if isinstance(d, dict)
        ]
        try:
            next_cursor = int(payload.get("cursor", cursor))
        except (TypeError, ValueError):
            next_cursor = cursor
        return events, next_cursor

    def _wait_qs(self) -> str:
        return "?wait=true" if self.synchronous else ""


def from_env() -> RestPoolClient:
    """Convenience constructor mirroring the adapter's env contract."""
    endpoint = os.environ.get("FABRIC_ENDPOINT", "")
    if not endpoint:
        raise FabricError("FABRIC_ENDPOINT not set")
    return RestPoolClient(
        endpoint=endpoint,
        tenant_id=os.environ.get("FABRIC_TENANT_ID", ""),
        cluster_id=os.environ.get("FABRIC_CLUSTER_ID", ""),
        synchronous=os.environ.get("FABRIC_SYNCHRONOUS", "") == "true",
    )
