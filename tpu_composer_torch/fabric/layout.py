"""Layout-apply fabric client — procedure-graph pool managers.

Port of ``tpu_composer/fabric/layout.py``: the same wire format, defaults,
error classes and metric names.

Reference analog: the NEC CDIM client (internal/cdi/nec/client.go), whose
fabric applies *layout changes* (connect/disconnect procedure graphs) rather
than direct attach calls: POST /layout-apply (nec/client.go:559-571), poll
the apply status up to 6 x 10s mapping COMPLETED/IN_PROGRESS/FAILED
(nec/client.go:352-377), and treat a 409 "apply already running" as
wait-and-requeue (nec/client.go:379-387).

TPU-first deltas:
- one procedure connects a whole chip group (and names its slice/worker), so
  a multi-host slice is N procedures, not N independent GPus;
- completion is read back from the attachment record itself (GET
  /v1/attachments/{name}) instead of trusting the apply status — the apply
  succeeding and the device being usable are separate facts;
- no NEC_PROVISIONAL_GPU_UUID hack (nec/client.go:186-194, 712-723): the
  pool reports real chip ids in the attachment record.

Wire API:
    GET  /v1/attachments/{resource}         existing attachment (idempotency)
    POST /v1/layout-apply                   {resource, operation, ...} -> id
    GET  /v1/layout-apply/{id}              {status: COMPLETED|IN_PROGRESS|FAILED}
    GET  /v1/attachments[...]/health        shared with the REST backend
"""

from __future__ import annotations

import time
from typing import List, Optional

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.httpx import HttpStatusError, JsonHttpClient, fabric_timeout
from tpu_composer_torch.fabric.poolapi import PoolApiMixin
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    FabricError,
    FabricProvider,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
    classify_fabric_error,
)
from tpu_composer_torch.fabric.token import TokenCache

# Reference polling envelope: 10s x 6 attempts (nec/client.go:26-28).
POLL_INTERVAL_S = 10.0
POLL_ATTEMPTS = 6
# 409 body code meaning another layout apply is still running (the
# reference's E40010, nec/client.go:379-387).
CODE_APPLY_IN_PROGRESS = "APPLY_IN_PROGRESS"


class LayoutApplyClient(PoolApiMixin, FabricProvider):
    def __init__(
        self,
        endpoint: str,
        token_cache: Optional[TokenCache] = None,
        poll_interval: float = POLL_INTERVAL_S,
        poll_attempts: int = POLL_ATTEMPTS,
        timeout: Optional[float] = None,
    ) -> None:
        if token_cache is None:
            token_cache = TokenCache.from_env()
        if timeout is None:
            timeout = fabric_timeout(60.0)
        self._http = JsonHttpClient(
            endpoint.rstrip("/") + "/v1", token_cache=token_cache, timeout=timeout
        )
        self.poll_interval = poll_interval
        self.poll_attempts = poll_attempts

    # -- attachment lifecycle ---------------------------------------------
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        name = resource.metadata.name
        existing = self._get_attachment(name)
        if existing is not None:
            return existing
        spec = resource.spec
        body = {
            "resource": name,
            "operation": "connect",
            "type": spec.type,
            "node": spec.target_node,
            "model": spec.model,
            "chip_count": spec.chip_count,
            "slice": spec.slice_name,
            "worker_id": spec.worker_id,
        }
        apply_id = self._submit_apply(body, WaitingDeviceAttaching)
        self._poll_apply(apply_id, name, WaitingDeviceAttaching)
        done = self._get_attachment(name)
        if done is None:
            raise FabricError(
                f"{name}: layout apply {apply_id} completed but no attachment exists"
            )
        return done

    def remove_resource(self, resource: ComposableResource) -> None:
        name = resource.metadata.name
        if self._get_attachment(name) is None and not resource.status.device_ids:
            return  # idempotent: nothing to disconnect
        body = {
            "resource": name,
            "operation": "disconnect",
            "node": resource.spec.target_node,
            "device_ids": list(resource.status.device_ids),
        }
        apply_id = self._submit_apply(body, WaitingDeviceDetaching)
        self._poll_apply(apply_id, name, WaitingDeviceDetaching)

    # (slices, health, listing come from PoolApiMixin — same /v1 wire shape)

    # -- internals ---------------------------------------------------------
    def _get_attachment(self, name: str) -> Optional[AttachResult]:
        try:
            _, payload = self._http.request("GET", f"/attachments/{name}")
        except HttpStatusError as e:
            if e.code == 404:
                return None
            raise classify_fabric_error(e, f"get attachment {name}: {e}") from e
        ids = list(payload.get("device_ids", []))
        if not ids:
            return None
        return AttachResult(device_ids=ids, cdi_device_id=payload.get("cdi_device_id", ""))

    def _submit_apply(self, body: dict, sentinel: type) -> str:
        try:
            _, payload = self._http.request("POST", "/layout-apply", body)
        except HttpStatusError as e:
            if e.code == 409 and e.body.get("code") == CODE_APPLY_IN_PROGRESS:
                # Another apply holds the fabric; requeue (nec 409/E40010).
                raise sentinel(f"{body['resource']}: fabric busy, apply in progress") from e
            raise classify_fabric_error(
                e, f"layout-apply {body['resource']}: {e}"
            ) from e
        apply_id = payload.get("apply_id", "")
        if not apply_id:
            raise FabricError(f"layout-apply {body['resource']}: no apply_id returned")
        return str(apply_id)

    def _poll_apply(self, apply_id: str, name: str, sentinel: type) -> None:
        """Poll until COMPLETED; raise the wait sentinel when the polling
        budget runs out (the controller requeues and idempotency takes over),
        FabricError on FAILED — the reference's exact status mapping
        (nec/client.go:352-377)."""
        for attempt in range(self.poll_attempts):
            try:
                _, payload = self._http.request("GET", f"/layout-apply/{apply_id}")
            except HttpStatusError as e:
                raise classify_fabric_error(
                    e, f"{name}: apply {apply_id} status: {e}"
                ) from e
            status = payload.get("status", "")
            if status == "COMPLETED":
                return
            if status == "FAILED":
                raise FabricError(
                    f"{name}: layout apply {apply_id} failed: "
                    f"{payload.get('detail', 'no detail')}"
                )
            if attempt + 1 < self.poll_attempts:
                time.sleep(self.poll_interval)
        raise sentinel(f"{name}: layout apply {apply_id} still in progress")
