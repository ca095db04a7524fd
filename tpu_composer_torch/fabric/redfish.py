"""Redfish-style composition client — Sunfish-flavored pool managers.

Port of ``tpu_composer/fabric/redfish.py``: the same wire format, defaults,
error classes and metric names.

Reference analog: internal/cdi/sunfish/client.go, which PATCHes a Redfish
``ComputerSystem`` with a processor request (client.go:~100) and leaves
CheckResource/GetResources as no-ops (client.go:140-146). This backend keeps
the Redfish nouns (Systems collection, resource blocks, Redfish
``Status.Health`` = OK/Warning/Critical — which maps 1:1 onto our
DeviceHealth states) but implements the full provider contract, because the
syncer and Online-state health polling need real answers.

Wire API (Redfish-style):
    GET    /redfish/v1/Systems                        Members list
    GET    /redfish/v1/Systems/{node}                 system + accelerators
    PATCH  /redfish/v1/Systems/{node}                 {"Accelerators": {"Add"|"Remove": ...}}
    PATCH  /redfish/v1/Systems/{node}                 {"Accelerators": {"AddMembers"|"RemoveMembers": [...]}}

The member-batch PATCH carries a whole per-node wave in ONE composition
request and answers per-member outcome records (``Results``), closing the
gap where this backend silently rode the dispatcher's UnsupportedBatch
per-item fallback — N accelerators on one host cost N PATCHes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.httpx import HttpStatusError, JsonHttpClient, fabric_timeout
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    FabricDevice,
    FabricError,
    FabricProvider,
    TransientFabricError,
    UnsupportedBatch,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
    classify_fabric_error,
    intent_nonce,
)
from tpu_composer_torch.fabric.token import TokenCache


class RedfishClient(FabricProvider):
    def __init__(
        self,
        endpoint: str,
        token_cache: Optional[TokenCache] = None,
        timeout: Optional[float] = None,
    ) -> None:
        if token_cache is None:
            token_cache = TokenCache.from_env()
        if timeout is None:
            timeout = fabric_timeout(60.0)
        self._http = JsonHttpClient(
            endpoint.rstrip("/") + "/redfish/v1", token_cache=token_cache, timeout=timeout
        )
        # Member-batch capability memory: services without the batch PATCH
        # shape typically reject it with 400, so 400 maps to
        # UnsupportedBatch — but only until the FIRST successful batch has
        # proven the shape is understood. After that a 400 is a real
        # (semantic) whole-call failure: the dispatcher split-retries that
        # wave per-item WITHOUT permanently latching batching off.
        self._member_batch_ok = False

    def add_resource(self, resource: ComposableResource) -> AttachResult:
        name = resource.metadata.name
        node = resource.spec.target_node
        existing = self._find_blocks(node, name)
        if existing:
            return self._to_result(existing)
        body = {
            "Accelerators": {
                "Add": {
                    "Resource": name,
                    "Model": resource.spec.model,
                    "Count": resource.spec.chip_count,
                    "Slice": resource.spec.slice_name,
                    "WorkerId": resource.spec.worker_id,
                }
            }
        }
        try:
            status, payload = self._http.request("PATCH", f"/Systems/{node}", body)
        except HttpStatusError as e:
            raise classify_fabric_error(e, f"attach {name}: {e}") from e
        if status == 202:
            raise WaitingDeviceAttaching(f"{name}: composition task accepted")
        # Only blocks labeled with OUR resource name count — aggregating
        # unlabeled blocks could hand us a co-located group's devices. If the
        # PATCH response omits labels, re-read the system record.
        mine = [b for b in payload.get("Accelerators", [])
                if b.get("Resource") == name]
        if not mine:
            mine = self._find_blocks(node, name)
        if not mine:
            raise FabricError(
                f"attach {name}: system reports no resource block for it"
            )
        return self._to_result(mine)

    def remove_resource(self, resource: ComposableResource) -> None:
        name = resource.metadata.name
        node = resource.spec.target_node
        body = {
            "Accelerators": {
                "Remove": {
                    "Resource": name,
                    "DeviceIds": list(resource.status.device_ids),
                }
            }
        }
        try:
            status, _ = self._http.request("PATCH", f"/Systems/{node}", body)
        except HttpStatusError as e:
            if e.code == 404:
                return  # system or block gone: idempotent
            raise classify_fabric_error(e, f"detach {name}: {e}") from e
        if status == 202:
            raise WaitingDeviceDetaching(f"{name}: decomposition task accepted")

    # -- group verbs (one PATCH per per-node wave) ------------------------
    def add_resources(self, resources: List[ComposableResource]) -> List[object]:
        return self._batch("Add", resources)

    def remove_resources(self, resources: List[ComposableResource]) -> List[object]:
        return self._batch("Remove", resources)

    def _batch(self, action: str, resources: List[ComposableResource]) -> List[object]:
        """Member-batch composition PATCH: per-member outcome records come
        back in ``Results`` so one bad accelerator degrades one member.
        A service without the member-batch shape (405/501, or a 400 shape
        rejection) surfaces as UnsupportedBatch — the dispatcher probes
        once and falls back to transparent per-item PATCHes; a transport
        fault raises whole-call and triggers member-by-member split retry."""
        if not resources:
            return []
        node = resources[0].spec.target_node
        members: List[Dict[str, object]] = []
        for r in resources:
            if action == "Add":
                member: Dict[str, object] = {
                    "Resource": r.metadata.name,
                    "Model": r.spec.model,
                    "Count": r.spec.chip_count,
                    "Slice": r.spec.slice_name,
                    "WorkerId": r.spec.worker_id,
                }
            else:
                member = {
                    "Resource": r.metadata.name,
                    "DeviceIds": list(r.status.device_ids),
                }
            nonce = intent_nonce(r)
            if nonce:
                member["Nonce"] = nonce
            members.append(member)
        try:
            _, payload = self._http.request(
                "PATCH", f"/Systems/{node}",
                {"Accelerators": {f"{action}Members": members}},
            )
        except HttpStatusError as e:
            if e.code in (405, 501) or (
                e.code == 400 and not self._member_batch_ok
            ):
                raise UnsupportedBatch(
                    f"redfish service has no member-batch PATCH ({e.code})"
                ) from None
            if e.code == 404 and action == "Remove":
                # System gone: every member's detach is an idempotent no-op
                # (single-verb parity).
                return [None] * len(resources)
            raise classify_fabric_error(e, f"batch {action} {node}: {e}") from e
        self._member_batch_ok = True
        results = {
            rec.get("Resource"): rec
            for rec in payload.get("Results", [])
            if isinstance(rec, dict)
        }
        return [
            self._member_outcome(action, r.metadata.name,
                                 results.get(r.metadata.name))
            for r in resources
        ]

    @staticmethod
    def _member_outcome(action: str, name: str, rec: Optional[dict]) -> object:
        if rec is None:
            # Silently dropped member: retryable — the dispatcher's next
            # pass re-submits it individually.
            return TransientFabricError(
                f"batch {action} {name}: service returned no result record"
            )
        if rec.get("Error"):
            cls = TransientFabricError if rec.get("Transient") else FabricError
            return cls(f"{action.lower()} {name}: {rec['Error']}")
        state = str(rec.get("State", "")).lower()
        if state == "attaching":
            return WaitingDeviceAttaching(f"{name}: composition task accepted")
        if state == "detaching":
            return WaitingDeviceDetaching(f"{name}: decomposition task accepted")
        if action == "Remove":
            return None
        ids = list(rec.get("DeviceIds", []))
        if not ids:
            return FabricError(
                f"attach {name}: result record carries no device ids"
            )
        return AttachResult(
            device_ids=ids, cdi_device_id=rec.get("CDIDeviceId", "")
        )

    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        name = resource.metadata.name
        blocks = self._find_blocks(resource.spec.target_node, name)
        if not blocks:
            return DeviceHealth("Critical", "not attached")
        worst = DeviceHealth("OK")
        rank = {"OK": 0, "Warning": 1, "Critical": 2}
        for b in blocks:
            state = b.get("Status", {}).get("Health", "OK")
            # Unknown Redfish health states rank as Critical (rank.get
            # default on BOTH sides: a non-standard state must neither crash
            # nor read as healthy).
            if rank.get(state, 2) > rank.get(worst.state, 2):
                worst = DeviceHealth(state, b.get("Status", {}).get("Detail", ""))
        return worst

    def get_resources(self) -> List[FabricDevice]:
        try:
            _, payload = self._http.request("GET", "/Systems")
        except HttpStatusError as e:
            raise classify_fabric_error(e, f"get_resources: {e}") from e
        out: List[FabricDevice] = []
        for member in payload.get("Members", []):
            node = member.get("Id") or member.get("@odata.id", "").rsplit("/", 1)[-1]
            if not node:
                continue
            for b in self._system_blocks(node):
                for dev in b.get("DeviceIds", []):
                    out.append(
                        FabricDevice(
                            device_id=dev,
                            node=node,
                            model=b.get("Model", ""),
                            slice_name=b.get("Slice", ""),
                            health=DeviceHealth(
                                state=b.get("Status", {}).get("Health", "OK"),
                                detail=b.get("Status", {}).get("Detail", ""),
                            ),
                            # Listing fidelity (conformance: owner
                            # attribution): blocks are labeled with the
                            # attaching resource, so adoption/syncer get
                            # exact ownership instead of "".
                            type=b.get("Type", ""),
                            resource_name=b.get("Resource", ""),
                        )
                    )
        return out

    def reserve_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        status, _ = self._http.request(
            "PUT",
            f"/CompositionService/ResourceZones/{slice_name}",
            {"Model": model, "Topology": topology, "Nodes": list(nodes)},
        )
        if status not in (200, 201):
            raise FabricError(f"reserve_slice {slice_name}: HTTP {status}")

    def release_slice(self, slice_name: str) -> None:
        try:
            self._http.request(
                "DELETE", f"/CompositionService/ResourceZones/{slice_name}"
            )
        except HttpStatusError as e:
            if e.code == 404:
                return  # unknown zone: idempotent no-op
            raise

    # -- internals ---------------------------------------------------------
    def _system_blocks(self, node: str) -> List[dict]:
        try:
            _, payload = self._http.request("GET", f"/Systems/{node}")
        except HttpStatusError as e:
            if e.code == 404:
                return []
            raise classify_fabric_error(e, f"get system {node}: {e}") from e
        return list(payload.get("Accelerators", []))

    def _find_blocks(self, node: str, resource_name: str) -> List[dict]:
        return [
            b for b in self._system_blocks(node) if b.get("Resource") == resource_name
        ]

    @staticmethod
    def _to_result(blocks: List[dict]) -> AttachResult:
        ids: List[str] = []
        cdi = ""
        for b in blocks:
            ids.extend(b.get("DeviceIds", []))
            cdi = cdi or b.get("CDIDeviceId", "")
        if not ids:
            raise FabricError("resource block carries no device ids")
        return AttachResult(device_ids=ids, cdi_device_id=cdi)
