"""Validating admission for ComposabilityRequest and NodeMaintenance (port
of ``tpu_composer/admission/validating.py``).

Rules mirror composabilityrequest_webhook.go:91-128:
1. ``target_node`` cannot be combined with ``allocation_policy:
   differentnode`` (:91-93);
2. two ``differentnode`` requests for the same (type, model) conflict — they
   would race for the same spread (:97-107);
3. two ``samenode`` requests for the same (type, model) pinned (explicitly or
   by allocation) to the same node conflict (:108-128).

Runs in-process through the store's admission chain; the same callable backs
the HTTP webhook endpoint when deployed against a real K8s API server.
"""

from __future__ import annotations

from typing import Optional

from tpu_composer_torch.api.types import ComposabilityRequest, ValidationError
from tpu_composer_torch.runtime.store import Store


class AdmissionDenied(ValidationError):
    pass


def _effective_target(req: ComposabilityRequest) -> str:
    """Explicit target_node, else the node the allocator already chose
    (the webhook's status fallback, :113-122)."""
    if req.spec.resource.target_node:
        return req.spec.resource.target_node
    for rs in req.status.resources.values():
        if rs.node_name:
            return rs.node_name
    return ""


def validate_request(store: Store, req: ComposabilityRequest) -> None:
    res = req.spec.resource

    if req.being_deleted:
        # Deletion-path updates (finalizer removal PUTs) must never be
        # denied: a conflict verdict here would wedge the object in
        # Deleting forever. The allocator likewise stops counting
        # terminating requests, so there is nothing left to protect.
        return

    if res.allocation_policy == "differentnode" and res.target_node:
        raise AdmissionDenied(
            "target_node cannot be specified when allocation_policy is 'differentnode'"
        )

    for other in store.list(ComposabilityRequest):
        if other.name == req.name or other.being_deleted:
            continue
        o = other.spec.resource
        if o.type != res.type or o.model != res.model:
            continue
        if res.allocation_policy == "differentnode":
            if o.allocation_policy == "differentnode":
                raise AdmissionDenied(
                    f"composabilityRequest {other.name} with type {res.type} and"
                    f" model {res.model} already exists"
                )
        elif res.allocation_policy == "samenode":
            # Deliberate deviation from composabilityrequest_webhook.go:
            # 108-128, which compares against the incoming SPEC target_node
            # only (so two unpinned never-allocated requests collide on
            # "" == "" and an allocated-unpinned update is checked at "").
            # Here BOTH sides resolve spec-then-status: an unpinned,
            # never-allocated request has no node yet — no conflict to
            # detect — while updates are checked at the node the request
            # actually occupies (the JAX package's docs/PARITY.md, row 15).
            mine = _effective_target(req)
            if mine and _effective_target(other) == mine:
                raise AdmissionDenied(
                    f"composabilityRequest {other.name} with type {res.type} and"
                    f" model {res.model} already targets {mine}"
                )


def validate_maintenance(store: Store, obj, old=None) -> None:
    """NodeMaintenance admission: schema validation, node_name
    immutability (retargeting a live drain would orphan the old node's
    cordon marker and evacuation marks — delete and recreate instead),
    and one-drain-per-node — two live drains for the same host would race
    each other's cordon marker and double-claim the same members."""
    if obj.being_deleted:
        return
    obj.validate()
    if old is not None and old.spec.node_name != obj.spec.node_name:
        raise AdmissionDenied(
            "spec.node_name is immutable: delete the NodeMaintenance"
            " (uncordoning the old node) and create a new one"
        )
    from tpu_composer_torch.api.maintenance import NodeMaintenance

    for other in store.list(NodeMaintenance):
        if other.name == obj.name or other.being_deleted:
            continue
        if other.spec.node_name == obj.spec.node_name:
            raise AdmissionDenied(
                f"nodeMaintenance {other.name} already drains"
                f" {obj.spec.node_name}"
            )


def register_validating_webhooks(store: Store) -> None:
    """Hook the rules into create/update, like SetupWebhookWithManager
    (cmd/main.go:196-201)."""

    def hook(op: str, new, old) -> None:
        if op in ("CREATE", "UPDATE"):
            validate_request(store, new)

    store.register_admission("ComposabilityRequest", hook)

    def maint_hook(op: str, new, old) -> None:
        if op in ("CREATE", "UPDATE"):
            validate_maintenance(store, new, old=old)

    store.register_admission("NodeMaintenance", maint_hook)
