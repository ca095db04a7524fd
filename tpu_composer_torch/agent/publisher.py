"""DevicePublisher — keep one ResourceSlice per node in cluster state.

The scheduler-visible half of the DRA path: after the
fabric attaches a chip group and the CDI spec is written, the resource
controller publishes the group's chips into the node's ResourceSlice; on
detach it retracts them. Quarantine is a DeviceTaintRule per device uuid
created before the drain and removed after invisibility — the exact ordering
the reference uses (composableresource_controller.go:333-420: taint →
drain → remove → untaint; rule objects at utils/gpus.go:894-975).

Works against both the in-proc Store and KubeStore (conflict-retried CAS on
the per-node slice object).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from tpu_composer_torch.api.dra import (
    DeviceTaintRule,
    DeviceTaintRuleSpec,
    ResourceSlice,
    ResourceSliceSpec,
    SliceDevice,
    taint_rule_name,
)
from tpu_composer_torch.api.meta import ObjectMeta
from tpu_composer_torch.runtime.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
)


def slice_object_name(node: str) -> str:
    return f"{node}-tpu.composer.dev"


def node_quarantine_name(node: str) -> str:
    """Deterministic DeviceTaintRule name for a whole-node quarantine
    (device_uuid empty, node_name set — the 'whole node' arm the
    DeviceTaintRuleSpec docstring reserves)."""
    return "quarantine-node-" + node.replace("/", "-").lower()


def is_node_quarantine_marker(rule) -> bool:
    """THE whole-node quarantine marker shape test (node_name set,
    device_uuid empty): the allocator gate, the syncer's stale-marker
    sweep and quarantined_nodes() all consume this one predicate so the
    encoding can't drift between them."""
    return bool(rule.spec.node_name) and not rule.spec.device_uuid


def retire_node(fabric, publisher, node: str) -> None:
    """Host-left-the-fleet retirement: forget its circuit breaker (no-op
    for providers without per-node breakers) and delete its durable
    quarantine marker, so a recreated same-name node starts allocatable.
    Shared by the resource controller's node-DELETED mapper, its
    _gc_node_gone retry and the syncer's stale-marker sweep — one ritual,
    no drift (same reason is_node_quarantine_marker exists)."""
    forget = getattr(fabric, "forget_node", None)
    if callable(forget):
        forget(node)
    publisher.clear_node_quarantine(node)


def node_quarantined(store, node: str) -> bool:
    """Point check for ONE node's quarantine marker. Allocation-path code
    deliberately does NOT use this — it calls quarantined_nodes() once per
    pass to avoid per-candidate wire GETs; this is for single-node probes
    (publisher API, operators, tests)."""
    return store.try_get(DeviceTaintRule, node_quarantine_name(node)) is not None


def quarantined_nodes(store) -> set:
    """Every host under a whole-node quarantine marker, in one list call
    (shape test: is_node_quarantine_marker) — the request allocator and
    the resource controller's quarantine gate both consume this so the
    encoding can't drift."""
    return {
        r.spec.node_name
        for r in store.list(DeviceTaintRule)
        if is_node_quarantine_marker(r)
    }


class DevicePublisher:
    def __init__(self, store, retries: int = 5) -> None:
        self.store = store
        self.retries = retries
        self.log = logging.getLogger("DevicePublisher")

    # ------------------------------------------------------------------
    # publication
    # ------------------------------------------------------------------
    def publish_group(
        self,
        node: str,
        group: str,
        device_ids: List[str],
        model: str,
        cdi_device_id: str = "",
        dev_paths: Optional[List[str]] = None,
    ) -> None:
        """Add (or refresh) one composed group's chips on the node's slice."""
        devices = [
            SliceDevice(
                name=f"{group}-{i}",
                uuid=uid,
                model=model,
                slice_name=group,
                cdi_device_id=cdi_device_id,
                dev_path=(dev_paths[i] if dev_paths and i < len(dev_paths) else ""),
            )
            for i, uid in enumerate(device_ids)
        ]
        self._mutate_slice(node, group, devices)

    def retract_group(self, node: str, group: str) -> None:
        """Remove a group's chips from the node's slice."""
        self._mutate_slice(node, group, [])

    def _mutate_slice(
        self, node: str, group: str, new_devices: List[SliceDevice]
    ) -> None:
        name = slice_object_name(node)
        for _ in range(self.retries):
            existing = self.store.try_get(ResourceSlice, name)
            if existing is None:
                if not new_devices:
                    return
                try:
                    self.store.create(
                        ResourceSlice(
                            metadata=ObjectMeta(name=name),
                            spec=ResourceSliceSpec(
                                node_name=node, pool=node, devices=new_devices
                            ),
                        )
                    )
                    return
                except AlreadyExistsError:
                    continue  # raced another publisher — retry as update
            kept = [d for d in existing.spec.devices if d.slice_name != group]
            existing.spec.devices = kept + new_devices
            try:
                if existing.spec.devices:
                    self.store.update(existing)
                else:
                    # empty slice → delete the object (kubelet plugins do the
                    # same; an empty slice advertises nothing)
                    self.store.delete(ResourceSlice, name)
                return
            except (ConflictError, NotFoundError):
                continue
        self.log.warning("slice update for %s kept conflicting; giving up", name)

    # ------------------------------------------------------------------
    # visibility (the reference's CheckGPUVisible DRA arm, gpus.go:207-239)
    # ------------------------------------------------------------------
    def devices_visible(self, node: str, device_ids: List[str]) -> bool:
        sl = self.store.try_get(ResourceSlice, slice_object_name(node))
        if sl is None:
            return False
        present = {d.uuid for d in sl.spec.devices}
        return all(uid in present for uid in device_ids)

    def devices_invisible(self, node: str, device_ids: List[str]) -> bool:
        sl = self.store.try_get(ResourceSlice, slice_object_name(node))
        if sl is None:
            return True
        present = {d.uuid for d in sl.spec.devices}
        return not any(uid in present for uid in device_ids)

    # ------------------------------------------------------------------
    # quarantine (gpus.go:894-975)
    # ------------------------------------------------------------------
    def create_taints(self, node: str, device_ids: List[str], reason: str) -> None:
        for uid in device_ids:
            name = taint_rule_name(uid)
            if self.store.try_get(DeviceTaintRule, name) is not None:
                continue
            try:
                self.store.create(
                    DeviceTaintRule(
                        metadata=ObjectMeta(name=name),
                        spec=DeviceTaintRuleSpec(
                            device_uuid=uid, node_name=node, reason=reason
                        ),
                    )
                )
            except AlreadyExistsError:
                pass

    def delete_taints(self, device_ids: List[str]) -> None:
        for uid in device_ids:
            try:
                self.store.delete(DeviceTaintRule, taint_rule_name(uid))
            except NotFoundError:
                pass

    def tainted(self, device_uuid: str) -> bool:
        return self.store.try_get(DeviceTaintRule, taint_rule_name(device_uuid)) is not None

    # ------------------------------------------------------------------
    # node quarantine (fabric resilience layer, docs/RESILIENCE.md)
    # ------------------------------------------------------------------
    def quarantine_node(self, node: str, reason: str) -> None:
        """Durable node-level quarantine marker. Unlike the per-device
        detach taints, this survives the failing ComposableResource's
        deletion — it is what keeps the allocator from re-placing
        replacement capacity onto the host whose attach path just burned an
        entire budget. Cleared by an operator (or test) once the fabric
        path is repaired."""
        name = node_quarantine_name(node)
        if self.store.try_get(DeviceTaintRule, name) is not None:
            return
        try:
            self.store.create(
                DeviceTaintRule(
                    metadata=ObjectMeta(name=name),
                    spec=DeviceTaintRuleSpec(node_name=node, reason=reason),
                )
            )
        except AlreadyExistsError:
            pass

    def clear_node_quarantine(self, node: str) -> None:
        try:
            self.store.delete(DeviceTaintRule, node_quarantine_name(node))
        except NotFoundError:
            pass

    def node_quarantined(self, node: str) -> bool:
        return node_quarantined(self.store, node)

    def claimable(self, node: str) -> List[SliceDevice]:
        """What a scheduler could still place on: published and untainted.
        (Used by tests' scheduler simulation and the syncer's accounting.)"""
        sl = self.store.try_get(ResourceSlice, slice_object_name(node))
        if sl is None:
            return []
        return [d for d in sl.spec.devices if not self.tainted(d.uuid)]


class InventoryPublisher:
    """Event-fed ResourceSlice drift repair (wire plane v2, part c).

    The publication writes themselves ride the attach/detach paths; what
    used to require a poll is noticing that a node's published slice no
    longer matches what the fabric actually has attached (slice object
    deleted by an operator, publication lost to a crash between attach and
    publish). This runnable re-checks on fabric *inventory events* — the
    push signal that composed capacity changed — with the timed pass
    demoted to a ``period × fallback_multiplier`` safety net while the
    event session streams (the same shape as UpstreamSyncer's relist
    demotion). At constant cluster state it performs zero wire ops beyond
    the cache-fed reads: visibility checks go through the informer cache,
    and ``get_resources()`` runs only when an event or the safety net
    fires.

    Repair policy is deliberately conservative: only a group whose chips
    are *entirely* unpublished on its node is re-published (a partial set
    is an in-flight controller mutation, not drift), and only when its
    owning ComposableResource is findable, Online, not terminating, and
    has no pending fabric op. A repaired entry carries no CDI device id —
    the controller's own publication (which knows it) wins on the next
    reconcile since _mutate_slice replaces the group's entries wholesale.
    """

    def __init__(
        self,
        store,
        fabric,
        session=None,
        period: float = 60.0,
        fallback_multiplier: float = 20.0,
    ) -> None:
        self.store = store
        self.fabric = fabric
        self.publisher = DevicePublisher(store)
        self.session = session
        self.period = period
        self.fallback_multiplier = max(1.0, fallback_multiplier)
        self.log = logging.getLogger("InventoryPublisher")
        self.repairs = 0  # introspection (tests / debug)
        self._wake = threading.Event()
        if session is not None:
            from tpu_composer_torch.fabric.events import EVENT_INVENTORY

            def _on_event(evt, _kind=EVENT_INVENTORY):
                if evt.type == _kind:
                    self._wake.set()

            session.on_event(_on_event)
            session.on_gap(self._wake.set)

    def effective_period(self) -> float:
        if self.session is not None and self.session.healthy():
            return self.period * self.fallback_multiplier
        return self.period

    def reconcile_once(self) -> int:
        """One repair pass; returns how many groups were re-published."""
        from tpu_composer_torch.api.types import (
            ComposableResource,
            RESOURCE_STATE_ONLINE,
        )
        from tpu_composer_torch.fabric.provider import FabricError

        try:
            devices = self.fabric.get_resources()
            resources = {r.name: r for r in self.store.list(ComposableResource)}
        except FabricError:
            return 0  # fabric outage: nothing to diff against
        groups: dict = {}
        for dev in devices:
            if dev.node and dev.slice_name and dev.resource_name:
                groups.setdefault(
                    (dev.node, dev.slice_name, dev.resource_name), []
                ).append(dev)
        repaired = 0
        for (node, group, owner_name), devs in sorted(groups.items()):
            owner = resources.get(owner_name)
            if (
                owner is None
                or owner.being_deleted
                or owner.status.state != RESOURCE_STATE_ONLINE
                or owner.status.pending_op is not None
            ):
                continue  # mid-flight or dying: the controller owns this
            ids = [d.device_id for d in devs]
            if not self.publisher.devices_invisible(node, ids):
                continue  # fully or partially published: not our drift
            self.publisher.publish_group(node, group, ids, devs[0].model)
            self.log.warning(
                "republished %d chip(s) of %s on %s (slice publication had"
                " vanished while the fabric still reports the attachment)",
                len(ids), group, node,
            )
            repaired += 1
        self.repairs += repaired
        return repaired

    # Manager runnable entry point (same contract as UpstreamSyncer).
    def __call__(self, stop_event: threading.Event) -> None:
        from tpu_composer_torch.fabric.events import doorbell_wait
        from tpu_composer_torch.runtime.store import StoreError

        last_pass = float("-inf")
        while not stop_event.is_set():
            # Same burst coalescing as the syncer: churn rings the
            # inventory doorbell once per attach/detach, so repair
            # passes are floored at the base period instead of running
            # once per event.
            doorbell_wait(
                stop_event, self._wake,
                deadline=time.monotonic() + self.effective_period(),
                floor=last_pass + self.period,
            )
            if stop_event.is_set():
                return
            self._wake.clear()
            last_pass = time.monotonic()
            try:
                self.reconcile_once()
            except StoreError as e:
                self.log.warning("slice repair pass failed: %s", e)
