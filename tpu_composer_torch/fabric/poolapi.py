"""Shared pool-API operations for backends speaking the /v1 wire shape.

Port of ``tpu_composer/fabric/poolapi.py``: the same wire format, defaults,
error classes and metric names.

rest.py and layout.py differ only in how an attach/detach *mutation* travels
(direct PUT/DELETE vs layout-apply procedures); slices, health and the
attachment listing are byte-identical wire calls. They live here once so the
dialects cannot drift.
"""

from __future__ import annotations

from typing import List

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.httpx import HttpStatusError, JsonHttpClient
from tpu_composer_torch.fabric.provider import (
    DeviceHealth,
    FabricDevice,
    FabricError,
    UnsupportedResize,
    classify_fabric_error,
)


class PoolApiMixin:
    """Requires ``self._http: JsonHttpClient`` rooted at the /v1 prefix."""

    _http: JsonHttpClient

    def reserve_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        status, _ = self._http.request(
            "PUT",
            f"/slices/{slice_name}",
            {"model": model, "topology": topology, "nodes": list(nodes)},
        )
        if status not in (200, 201):
            raise FabricError(f"reserve_slice {slice_name}: HTTP {status}")

    def release_slice(self, slice_name: str) -> None:
        try:
            self._http.request("DELETE", f"/slices/{slice_name}")
        except HttpStatusError as e:
            if e.code == 404:
                return  # unknown slice: idempotent no-op (InMemoryPool parity)
            raise

    def resize_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        """Live grow/shrink over the wire: PATCH the slice with the new
        shape; the pool service keeps surviving hosts' chip groups (same
        contract as InMemoryPool.resize_slice). A pool service without the
        endpoint (404/405/501) surfaces as UnsupportedResize so the
        controller falls back to dissolve-and-rebuild instead of tearing
        survivors down via release+reserve."""
        try:
            status, _ = self._http.request(
                "PATCH",
                f"/slices/{slice_name}",
                {"model": model, "topology": topology, "nodes": list(nodes)},
            )
        except HttpStatusError as e:
            if e.code in (405, 501):
                raise UnsupportedResize(
                    f"pool service has no live-resize endpoint ({e.code})"
                ) from None
            if e.code == 404:
                # Ambiguous: unknown slice (InMemoryPool contract says
                # resize-of-unknown reserves it) OR a service without the
                # PATCH route. Reserving disambiguates — a service that
                # actually holds the slice 409s the PUT, which means the
                # 404 was the missing route. ONLY the conflict proves that;
                # a transport failure or 5xx from the fallback PUT is
                # transient and must stay retryable — UnsupportedResize is
                # permanent (the controller answers it by dissolving the
                # slice and tearing down surviving workers).
                try:
                    return self.reserve_slice(slice_name, model, topology, nodes)
                except HttpStatusError as re:
                    if re.code == 409:
                        raise UnsupportedResize(
                            f"pool service 404s resize of {slice_name} and"
                            " the slice already exists — no live-resize"
                            " support"
                        ) from None
                    raise classify_fabric_error(
                        re, f"resize_slice {slice_name}: fallback reserve: {re}"
                    ) from re
            raise classify_fabric_error(e, f"resize_slice {slice_name}: {e}") from e
        if not 200 <= status < 300:
            raise FabricError(f"resize_slice {slice_name}: HTTP {status}")

    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        name = resource.metadata.name
        try:
            _, payload = self._http.request("GET", f"/attachments/{name}/health")
        except HttpStatusError as e:
            if e.code == 404:
                return DeviceHealth("Critical", "not attached")
            raise classify_fabric_error(e, f"check {name}: {e}") from e
        return DeviceHealth(
            state=payload.get("state", "Critical"), detail=payload.get("detail", "")
        )

    def get_resources(self) -> List[FabricDevice]:
        try:
            _, payload = self._http.request("GET", "/attachments")
        except HttpStatusError as e:
            raise classify_fabric_error(e, f"get_resources: {e}") from e
        return [
            FabricDevice(
                device_id=item.get("device_id", ""),
                node=item.get("node", ""),
                model=item.get("model", ""),
                slice_name=item.get("slice", ""),
                health=DeviceHealth(
                    state=item.get("health", {}).get("state", "OK"),
                    detail=item.get("health", {}).get("detail", ""),
                ),
                # Optional fields newer pool services report; "" from older
                # ones keeps the model-sniffing fallbacks in play.
                type=item.get("type", ""),
                resource_name=item.get("resource", ""),
            )
            for item in payload.get("attachments", [])
        ]
