"""In-memory chip pool manager — the mock fabric backend (port of
``tpu_composer/fabric/inmem.py``, with an NVIDIA H100 row).

Dual role, mirroring how the reference treats its fake fabric:
- the default provider for standalone/bench runs (BASELINE.json config[0]
  "mock fabric backend, CPU-only");
- the fault-injection surface for tests, replacing the reference's
  ~50-URL-path httptest persona server
  (composableresource_controller_test.go:737-998) with explicit injection
  methods.

Models a disaggregated chip pool: free chips per TPU model, per-host
attachment ports (Node.status.tpu_slots is enforced by the allocator; the
pool enforces its own chip inventory), slice reservations that carve
ICI-adjacent chip groups atomically (for the H100, one host's
NVSwitch-joined GPUs per worker), and optionally *asynchronous* attach —
``async_steps > 0`` makes add_resource raise WaitingDeviceAttaching for the
first N polls, emulating the reference's CM resize flow
(fti/cm/client.go:140-186: POST resize then ErrWaitingDeviceAttaching until a
later pass finds ADD_COMPLETE); ``async_steps == 0`` emulates the synchronous
FM flow (fti/fm/client.go:100-214).
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from tpu_composer_torch.agent.cdi import CDI_CLASS_GPU, CDI_VENDOR
from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.events import (
    EVENT_HEALTH,
    EVENT_INVENTORY,
    EVENT_OP_COMPLETED,
    FabricEvent,
)
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    FabricDevice,
    FabricError,
    FabricProvider,
    HEALTH_OK,
    WaitingDeviceAttaching,
    WaitingDeviceDetaching,
    intent_nonce as _intent_nonce,
)
from tpu_composer_torch.runtime.contention import ObservedLock
from tpu_composer_torch.topology.slices import (
    _parse_dims,
    is_gpu_model,
    is_tpu_model,
    solve_slice,
)


@dataclass
class _Attachment:
    resource_name: str
    node: str
    model: str
    device_ids: List[str]
    cdi_device_id: str
    slice_name: str = ""
    type: str = ""  # explicit device type from the attaching spec


@dataclass
class _SliceReservation:
    model: str
    topology: str
    nodes: List[str]
    # worker_id -> chip ids reserved for that host
    groups: Dict[int, List[str]] = field(default_factory=dict)


class InMemoryPool(FabricProvider):
    def __init__(
        self,
        chips: Optional[Dict[str, int]] = None,
        async_steps: int = 0,
        async_delay: float = 0.0,
        event_buffer: int = 4096,
    ) -> None:
        # Default inventory: enough v4 chips for a 32-chip pod slice, two
        # 8-GPU H100 hosts, plus some loose gpu-compat devices.
        self._chips = dict(chips or {"tpu-v4": 64, "tpu-v5e": 32,
                                     "nvidia-h100-sxm": 16, "gpu-a100": 8})
        self._async_steps = async_steps
        # Server-side async (the event plane's natural habitat): with
        # async_delay > 0 an attach/detach is ACCEPTED (wait sentinel) and
        # completes ``async_delay`` seconds later on the pool's own timer,
        # emitting the op_completed event at that moment — unlike
        # async_steps, where completion only happens when a client poll
        # drives it. This is what a real pool manager does: the work
        # finishes whether or not anyone is polling.
        self._async_delay = async_delay
        # Contention telemetry: every attach/detach/listing serializes on
        # this lock — the pool-side twin of the store lock. The event
        # Condition below shares it (ObservedLock implements the RLock
        # save/restore protocol, so long-poll parks are not counted as
        # hold or wait time).
        self._lock = ObservedLock("inmem_pool", reentrant=True)
        self._free: Dict[str, List[str]] = {
            model: [f"{model}-chip-{i:04d}" for i in range(n)]
            for model, n in self._chips.items()
        }
        self._attachments: Dict[str, _Attachment] = {}  # resource_name -> attachment
        self._slices: Dict[str, _SliceReservation] = {}
        self._pending_attach: Dict[str, int] = {}  # resource_name -> polls remaining
        self._pending_detach: Dict[str, int] = {}
        # async_delay mode: resource_name -> monotonic completion deadline.
        self._attach_ready: Dict[str, float] = {}
        self._detach_ready: Dict[str, float] = {}
        # Event plane: bounded sequence-numbered ring + long-poll wakeup.
        # The Condition shares the pool lock, so emission is atomic with
        # the state change it reports and waiters release the lock while
        # parked.
        self._event_seq = 0
        self._events: Deque[FabricEvent] = collections.deque(maxlen=event_buffer)
        self._event_cond = threading.Condition(self._lock)
        self._health: Dict[str, DeviceHealth] = {}  # device_id -> health override
        self._add_failures: Dict[str, int] = {}  # resource_name -> remaining failures
        self._remove_failures: Dict[str, int] = {}
        self._leaked: List[FabricDevice] = []
        # Dead-chip tracking (self-healing data plane): a killed chip reports
        # Critical health forever and is never handed back out — chips that
        # would return to the free pool land in the graveyard instead (the
        # real-fabric analog: an RMA queue, not free inventory).
        self._dead_ids: set = set()
        self._graveyard: Dict[str, List[str]] = {}  # model -> retired dead chips

    # ------------------------------------------------------------------
    # slice transactions
    # ------------------------------------------------------------------
    def reserve_slice(self, slice_name: str, model: str, topology: str, nodes: List[str]) -> None:
        with self._lock:
            if slice_name in self._slices:
                return  # idempotent
            shape = solve_slice(model, _chips_in(topology), topology)
            if len(nodes) != shape.num_hosts:
                raise FabricError(
                    f"slice {slice_name}: topology {topology} needs {shape.num_hosts}"
                    f" hosts, got {len(nodes)}"
                )
            free = self._free.get(model, [])
            if len(free) < shape.num_chips:
                raise FabricError(
                    f"slice {slice_name}: pool has {len(free)} free {model} chips,"
                    f" need {shape.num_chips}"
                )
            # Carve ICI-adjacent chips: the pool hands out a contiguous run,
            # split into per-host groups in worker order.
            taken = [free.pop(0) for _ in range(shape.num_chips)]
            groups = {
                w: taken[w * shape.chips_per_host : (w + 1) * shape.chips_per_host]
                for w in range(shape.num_hosts)
            }
            self._slices[slice_name] = _SliceReservation(
                model=model, topology=topology, nodes=list(nodes), groups=groups
            )

    def resize_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        """Live grow/shrink: keep the chip groups of surviving workers
        (stable prefix of `nodes`), carve or free only the delta. Attached
        chips on a removed worker are a caller bug — the controller drains
        those members first — and raise rather than silently leak."""
        with self._lock:
            resv = self._slices.get(slice_name)
            if resv is None:
                return self.reserve_slice(slice_name, model, topology, nodes)
            shape = solve_slice(model, _chips_in(topology), topology)
            if len(nodes) != shape.num_hosts:
                raise FabricError(
                    f"slice {slice_name}: topology {topology} needs"
                    f" {shape.num_hosts} hosts, got {len(nodes)}"
                )
            old_cph = len(next(iter(resv.groups.values()), []))
            if old_cph and old_cph != shape.chips_per_host:
                raise FabricError(
                    f"slice {slice_name}: resize cannot change chips_per_host"
                    f" ({old_cph} -> {shape.chips_per_host}); dissolve instead"
                )
            survivors = 0
            while (
                survivors < len(nodes)
                and survivors < len(resv.nodes)
                and nodes[survivors] == resv.nodes[survivors]
            ):
                survivors += 1
            attached_ids = {
                d for a in self._attachments.values() if a.slice_name == slice_name
                for d in a.device_ids
            }
            # Validate EVERYTHING before mutating: a raise mid-mutation
            # would leak popped chip groups from inventory.
            removed = range(survivors, len(resv.nodes))
            for w in removed:
                if any(c in attached_ids for c in resv.groups.get(w, [])):
                    raise FabricError(
                        f"slice {slice_name}: worker {w} still has attached"
                        " chips; drain before resize"
                    )
            new_workers = range(survivors, shape.num_hosts)
            need = len(new_workers) * shape.chips_per_host
            free = self._free.get(model, [])
            if len(free) < need:
                raise FabricError(
                    f"slice {slice_name}: pool has {len(free)} free {model}"
                    f" chips, resize needs {need} more"
                )
            # Commit: free the dropped workers' groups, carve the new ones.
            for w in removed:
                self._free[resv.model].extend(resv.groups.pop(w, []))
            for w in new_workers:
                resv.groups[w] = [free.pop(0) for _ in range(shape.chips_per_host)]
            resv.topology = topology
            resv.nodes = list(nodes)

    def repair_slice_member(
        self, slice_name: str, worker_id: int, node: str
    ) -> None:
        """Swap one worker's chip group for fresh chips on `node` without
        touching any other worker (provider.py contract). The retired chips
        stay with the failed member's live attachment until it detaches —
        _remove_one_locked frees only chips no longer in the reservation,
        routing dead ones to the graveyard."""
        with self._lock:
            resv = self._slices.get(slice_name)
            if resv is None:
                raise FabricError(f"slice {slice_name} not reserved")
            old = resv.groups.get(worker_id)
            if old is None:
                raise FabricError(
                    f"slice {slice_name} has no worker {worker_id}"
                )
            need = len(old)
            free = self._free.get(resv.model, [])
            if len(free) < need:
                raise FabricError(
                    f"slice {slice_name}: pool has {len(free)} free"
                    f" {resv.model} chips, repair needs {need}"
                )
            attached_ids = {
                d for a in self._attachments.values() for d in a.device_ids
            }
            resv.groups[worker_id] = [free.pop(0) for _ in range(need)]
            if 0 <= worker_id < len(resv.nodes):
                resv.nodes[worker_id] = node
            for c in old:
                if c not in attached_ids:
                    self._release_chip(resv.model, c)

    def release_slice(self, slice_name: str) -> None:
        with self._lock:
            resv = self._slices.pop(slice_name, None)
            if resv is None:
                return
            attached_ids = {
                d for a in self._attachments.values() if a.slice_name == slice_name
                for d in a.device_ids
            }
            for chips in resv.groups.values():
                for c in chips:
                    if c not in attached_ids:
                        self._release_chip(resv.model, c)

    # ------------------------------------------------------------------
    # provider interface
    # ------------------------------------------------------------------
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        with self._lock:
            return self._add_one_locked(resource)

    def add_resources(self, resources: List[ComposableResource]) -> List[object]:
        """Group attach: every member processed inside ONE lock acquisition
        (one fabric 'RPC'), per-member outcomes reported in place so one
        bad device cannot poison its group (provider.py group-verb
        contract). Async pools make per-member progress on every group
        poll, exactly as per-member re-polls would."""
        out: List[object] = []
        with self._lock:
            for r in resources:
                try:
                    out.append(self._add_one_locked(r))
                except FabricError as e:
                    out.append(e)
        return out

    def _add_one_locked(self, resource: ComposableResource) -> AttachResult:
        name = resource.metadata.name
        spec = resource.spec
        existing = self._attachments.get(name)
        if existing is not None:
            # Idempotent completion re-read (CM ADD_COMPLETE re-scan).
            return AttachResult(list(existing.device_ids), existing.cdi_device_id)

        if self._add_failures.get(name, 0) > 0:
            self._add_failures[name] -= 1
            raise FabricError(f"injected attach failure for {name}")

        if self._async_delay > 0:
            ready = self._attach_ready.get(name)
            if ready is None:
                self._attach_ready[name] = time.monotonic() + self._async_delay
                self._spawn_async_completion("add", resource)
                raise WaitingDeviceAttaching(
                    f"{name}: attach accepted, in progress"
                )
            if time.monotonic() < ready:
                raise WaitingDeviceAttaching(f"{name}: attach in progress")
        else:
            pending = self._pending_attach.get(name)
            if pending is None and self._async_steps > 0:
                self._pending_attach[name] = self._async_steps
                raise WaitingDeviceAttaching(f"{name}: attach accepted, in progress")
            if pending is not None and pending > 0:
                self._pending_attach[name] = pending - 1
                if self._pending_attach[name] > 0:
                    raise WaitingDeviceAttaching(f"{name}: attach in progress")

        if _chip_group(spec) and spec.slice_name:
            att = self._attach_slice_member(resource)
        else:
            att = self._attach_loose(resource)
        self._attachments[name] = att
        self._pending_attach.pop(name, None)
        self._attach_ready.pop(name, None)
        self._emit_locked(
            EVENT_OP_COMPLETED, resource=name, verb="add",
            nonce=_intent_nonce(resource), node=att.node,
            device_ids=list(att.device_ids), outcome="ok",
        )
        self._emit_locked(
            EVENT_INVENTORY, resource=name, node=att.node,
            device_ids=list(att.device_ids), detail="attached",
        )
        return AttachResult(list(att.device_ids), att.cdi_device_id)

    def _attach_slice_member(self, resource: ComposableResource) -> _Attachment:
        spec = resource.spec
        resv = self._slices.get(spec.slice_name)
        if resv is None:
            raise FabricError(
                f"{resource.metadata.name}: slice {spec.slice_name} not reserved"
            )
        chips = resv.groups.get(spec.worker_id)
        if chips is None:
            raise FabricError(
                f"{resource.metadata.name}: slice {spec.slice_name} has no worker"
                f" {spec.worker_id}"
            )
        if len(chips) != spec.chip_count:
            raise FabricError(
                f"{resource.metadata.name}: reservation has {len(chips)} chips,"
                f" spec wants {spec.chip_count}"
            )
        if is_gpu_model(spec.model):
            # The group's CDI device, as CdiSpec.qualified_name names it.
            cdi_device_id = (f"{CDI_VENDOR}/{CDI_CLASS_GPU}="
                             f"{spec.slice_name}-worker{spec.worker_id}")
        else:
            cdi_device_id = (f"tpu.composer.dev/slice={spec.slice_name}"
                             f"/worker={spec.worker_id}")
        return _Attachment(
            resource_name=resource.metadata.name,
            node=spec.target_node,
            model=spec.model,
            device_ids=list(chips),
            cdi_device_id=cdi_device_id,
            slice_name=spec.slice_name,
            type=spec.type,
        )

    def _attach_loose(self, resource: ComposableResource) -> _Attachment:
        """gpu/cxlmemory compat path, and a chip group without a slice."""
        spec = resource.spec
        free = self._free.get(spec.model)
        if free is None:
            raise FabricError(f"unknown device model {spec.model!r}")
        count = spec.chip_count if _chip_group(spec) else 1
        if len(free) < count:
            raise FabricError(
                f"pool exhausted for {spec.model}: need {count}, free {len(free)}"
            )
        chips = [free.pop(0) for _ in range(count)]
        return _Attachment(
            resource_name=resource.metadata.name,
            node=spec.target_node,
            model=spec.model,
            device_ids=chips,
            cdi_device_id=f"tpu.composer.dev/device={chips[0]}",
            type=spec.type,
        )

    def remove_resource(self, resource: ComposableResource) -> None:
        with self._lock:
            self._remove_one_locked(resource)

    def remove_resources(self, resources: List[ComposableResource]) -> List[object]:
        """Group detach twin of :meth:`add_resources` (None = detached)."""
        out: List[object] = []
        with self._lock:
            for r in resources:
                try:
                    self._remove_one_locked(r)
                    out.append(None)
                except FabricError as e:
                    out.append(e)
        return out

    def _remove_one_locked(self, resource: ComposableResource) -> None:
        name = resource.metadata.name
        if self._remove_failures.get(name, 0) > 0:
            self._remove_failures[name] -= 1
            raise FabricError(f"injected detach failure for {name}")
        att = self._attachments.get(name)
        if att is None:
            self._drop_leaked(resource)
            return  # idempotent
        if self._async_delay > 0:
            ready = self._detach_ready.get(name)
            if ready is None:
                self._detach_ready[name] = time.monotonic() + self._async_delay
                self._spawn_async_completion("remove", resource)
                raise WaitingDeviceDetaching(
                    f"{name}: detach accepted, in progress"
                )
            if time.monotonic() < ready:
                raise WaitingDeviceDetaching(f"{name}: detach in progress")
        else:
            pending = self._pending_detach.get(name)
            if pending is None and self._async_steps > 0:
                self._pending_detach[name] = self._async_steps
                raise WaitingDeviceDetaching(f"{name}: detach accepted, in progress")
            if pending is not None and pending > 0:
                self._pending_detach[name] = pending - 1
                if self._pending_detach[name] > 0:
                    raise WaitingDeviceDetaching(f"{name}: detach in progress")
        del self._attachments[name]
        self._pending_detach.pop(name, None)
        self._detach_ready.pop(name, None)
        self._emit_locked(
            EVENT_OP_COMPLETED, resource=name, verb="remove",
            nonce=_intent_nonce(resource), node=att.node,
            device_ids=list(att.device_ids), outcome="ok",
        )
        self._emit_locked(
            EVENT_INVENTORY, resource=name, node=att.node,
            device_ids=list(att.device_ids), detail="detached",
        )
        resv = self._slices.get(att.slice_name) if att.slice_name else None
        still_reserved = (
            {c for grp in resv.groups.values() for c in grp}
            if resv is not None else set()
        )
        for d in att.device_ids:
            if d not in still_reserved:
                # Not part of the reservation (loose device, or retired by
                # repair_slice_member) — back to inventory. Chips still in
                # the reservation return with release_slice.
                self._release_chip(att.model, d)
        for d in att.device_ids:
            if d not in self._dead_ids:
                self._health.pop(d, None)

    def _drop_leaked(self, resource: ComposableResource) -> None:
        """A detach-CR created by the syncer targets an orphaned attachment by
        device id (the ready-to-detach flow, upstreamsyncer_controller.go:140-165).
        Orphans come in two forms: test-injected leaks (_leaked) and real
        attachments whose owning CR was purged (e.g. node-gone GC) — both must
        release by device id, since the detach-CR's name never matches the
        original attachment key."""
        ids = set(resource.status.device_ids)
        if not ids:
            return
        kept = []
        for dev in self._leaked:
            if dev.device_id in ids:
                self._release_chip(dev.model, dev.device_id)
            else:
                kept.append(dev)
        self._leaked = kept
        for name, att in list(self._attachments.items()):
            hit = ids & set(att.device_ids)
            if not hit:
                continue
            att.device_ids = [d for d in att.device_ids if d not in hit]
            if not (att.slice_name and att.slice_name in self._slices):
                # (chips of a still-reserved slice return via release_slice)
                for d in sorted(hit):
                    self._release_chip(att.model, d)
            for d in hit:
                if d not in self._dead_ids:
                    self._health.pop(d, None)
            if not att.device_ids:
                del self._attachments[name]

    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        with self._lock:
            att = self._attachments.get(resource.metadata.name)
            if att is None:
                return DeviceHealth("Critical", "not attached")
            worst = DeviceHealth(HEALTH_OK)
            rank = {"OK": 0, "Warning": 1, "Critical": 2}
            for d in att.device_ids:
                h = self._health.get(d)
                # Unknown states rank as Critical rather than crashing.
                if h is not None and rank.get(h.state, 2) > rank.get(worst.state, 2):
                    worst = h
            return worst

    def get_resources(self) -> List[FabricDevice]:
        with self._lock:
            out = [
                FabricDevice(
                    device_id=d,
                    node=a.node,
                    model=a.model,
                    slice_name=a.slice_name,
                    health=self._health.get(d, DeviceHealth()),
                    type=a.type,
                    resource_name=a.resource_name,
                )
                for a in self._attachments.values()
                for d in a.device_ids
            ]
            out.extend(FabricDevice(
                device_id=l.device_id, node=l.node, model=l.model,
                slice_name=l.slice_name, health=l.health, type=l.type,
            ) for l in self._leaked)
            return out

    # ------------------------------------------------------------------
    # event plane (server-push; fabric/events.py)
    # ------------------------------------------------------------------
    def _emit_locked(self, type_: str, **fields) -> None:
        """Append one sequence-numbered event and wake long-pollers.
        Caller holds the pool lock, so the event is atomic with the state
        change it reports."""
        self._event_seq += 1
        self._events.append(FabricEvent(seq=self._event_seq, type=type_, **fields))
        self._event_cond.notify_all()

    def poll_events(
        self, cursor: int, timeout: float = 5.0
    ) -> Tuple[List[FabricEvent], int]:
        """Long-poll the pool's event ring (provider.py contract): events
        with seq > cursor, or an empty batch after ``timeout`` seconds of
        silence. cursor=-1 tails (head seq, no backlog). A cursor older
        than the ring's oldest retained event surfaces as a sequence gap
        to the session, which resyncs via get_resources."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._event_cond:
            if cursor < 0:
                return [], self._event_seq
            while True:
                out = [e for e in self._events if e.seq > cursor]
                if out:
                    return out, out[-1].seq
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], cursor
                self._event_cond.wait(remaining)

    def _spawn_async_completion(self, verb: str, resource: ComposableResource) -> None:
        """async_delay mode: the pool finishes the accepted op on its own
        timer — re-driving the idempotent verb materializes the result and
        emits the op_completed event, whether or not any client is
        polling. Caller holds the lock; the timer runs without it."""
        # Small margin past the deadline so clock granularity can't make
        # the timer's own completion call observe "not ready yet".
        t = threading.Timer(
            self._async_delay + 0.005, self._complete_async, args=(verb, resource)
        )
        t.daemon = True
        t.start()

    def _complete_async(self, verb: str, resource: ComposableResource) -> None:
        try:
            if verb == "add":
                self.add_resource(resource)
            else:
                self.remove_resource(resource)
        except (WaitingDeviceAttaching, WaitingDeviceDetaching):
            pass  # a racing injected reset; client polls finish it
        except FabricError as e:
            # The op failed at materialization time: push the bad news too.
            # The event is a doorbell — the dispatcher's immediate re-poll
            # reads the authoritative error through the idempotent verb
            # (the ready-deadline entry stays put, so that re-poll falls
            # through to the same terminal error instead of re-accepting).
            with self._lock:
                self._emit_locked(
                    EVENT_OP_COMPLETED, resource=resource.metadata.name,
                    verb=verb, nonce=_intent_nonce(resource),
                    node=resource.spec.target_node, outcome="error",
                    error=str(e),
                )

    def _node_of_device(self, device_id: str) -> str:
        """Best-effort node attribution for health events (caller holds
        the lock); '' for chips not currently attached anywhere."""
        for att in self._attachments.values():
            if device_id in att.device_ids:
                return att.node
        for dev in self._leaked:
            if dev.device_id == device_id:
                return dev.node
        return ""

    def _release_chip(self, model: str, device_id: str) -> None:
        """Return one chip to inventory — free pool for healthy chips, the
        graveyard for killed ones (a dead chip must never be carved into a
        later reservation and immediately re-degrade it). Caller holds the
        lock."""
        if device_id in self._dead_ids:
            self._graveyard.setdefault(model, []).append(device_id)
        else:
            self._free.setdefault(model, []).append(device_id)

    # ------------------------------------------------------------------
    # test/bench instrumentation (replaces URL-persona fault injection)
    # ------------------------------------------------------------------
    def kill_device(self, device_id: str, detail: str = "device dead") -> None:
        """Scripted post-Ready device death: the chip reports Critical
        health forever (check_resource / get_resources) and leaves the
        allocatable pool — free now if loose, via the graveyard when its
        attachment detaches."""
        with self._lock:
            self._dead_ids.add(device_id)
            self._health[device_id] = DeviceHealth("Critical", detail)
            self._emit_locked(
                EVENT_HEALTH, device_ids=[device_id],
                node=self._node_of_device(device_id),
                state="Critical", detail=detail,
            )
            for model, lst in self._free.items():
                if device_id in lst:
                    lst.remove(device_id)
                    self._graveyard.setdefault(model, []).append(device_id)
                    break

    def revive_device(self, device_id: str) -> None:
        """Undo kill_device (the repaired-hardware case): health clears and
        a graveyard chip returns to the free pool."""
        with self._lock:
            self._dead_ids.discard(device_id)
            self._health.pop(device_id, None)
            self._emit_locked(
                EVENT_HEALTH, device_ids=[device_id],
                node=self._node_of_device(device_id),
                state=HEALTH_OK, detail="revived",
            )
            for model, lst in self._graveyard.items():
                if device_id in lst:
                    lst.remove(device_id)
                    self._free.setdefault(model, []).append(device_id)
                    break

    def dead_chips(self, model: str) -> int:
        """Graveyard size for one model (kill_device victims already retired
        from circulation; soak accounting: free + graveyard + attached +
        still-reserved == total inventory)."""
        with self._lock:
            return len(self._graveyard.get(model, []))

    def inject_add_failure(self, resource_name: str, times: int = 1) -> None:
        with self._lock:
            self._add_failures[resource_name] = times

    def inject_remove_failure(self, resource_name: str, times: int = 1) -> None:
        with self._lock:
            self._remove_failures[resource_name] = times

    def set_health(self, device_id: str, health: DeviceHealth) -> None:
        with self._lock:
            self._health[device_id] = health
            self._emit_locked(
                EVENT_HEALTH, device_ids=[device_id],
                node=self._node_of_device(device_id),
                state=health.state, detail=health.detail,
            )

    def leak_attachment(self, node: str, model: str, type: str = "") -> str:
        """Create a fabric-side attachment with no local CR (drift source)."""
        with self._lock:
            free = self._free[model]
            if not free:
                raise FabricError(f"no free {model} chips to leak")
            dev = free.pop(0)
            self._leaked.append(FabricDevice(
                device_id=dev, node=node, model=model,
                type=type or ("tpu" if is_tpu_model(model) else "gpu"),
            ))
            self._emit_locked(
                EVENT_INVENTORY, node=node, device_ids=[dev],
                detail="attached",
            )
            return dev

    def attachment_record(self, resource_name: str) -> Optional[Dict[str, object]]:
        """Public read of one attachment (used by the HTTP fabric fake and
        any pool-manager frontend serving this pool over the wire)."""
        with self._lock:
            att = self._attachments.get(resource_name)
            if att is None:
                return None
            return {
                "resource": att.resource_name,
                "node": att.node,
                "model": att.model,
                "device_ids": list(att.device_ids),
                "cdi_device_id": att.cdi_device_id,
                "slice": att.slice_name,
            }

    def has_slice(self, slice_name: str) -> bool:
        with self._lock:
            return slice_name in self._slices

    def free_chips(self, model: str) -> int:
        with self._lock:
            return len(self._free.get(model, []))

    def attached_to(self, node: str) -> List[str]:
        with self._lock:
            return sorted(
                d for a in self._attachments.values() if a.node == node
                for d in a.device_ids
            )


def _chip_group(spec) -> bool:
    """A TPU group or an H100 group: ``chip_count`` chips carved as one
    slice member. Other gpu/cxlmemory models attach one loose device."""
    return spec.type == "tpu" or is_gpu_model(spec.model)


def _chips_in(topology: str) -> int:
    n = 1
    for d in _parse_dims(topology):  # raises TopologyError on malformed input
        n *= d
    return n
