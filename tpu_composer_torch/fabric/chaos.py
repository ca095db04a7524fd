"""Chaos fabric provider — fault injection for any FabricProvider.

Port of ``tpu_composer/fabric/chaos.py``: the same wire format, defaults,
error classes and metric names.

The fault-injection surface for the resilience layer's tests: where
``InMemoryPool.inject_add_failure`` scripts failures *inside* the mock pool,
this decorator injects them *between* the controllers and ANY provider
(mock, breaker-wrapped, or a real remote client in a staging soak), which is
where real fabric flakes live — on the wire, before the pool ever sees the
call. Reference contrast: the reference's fault injection is ~50 scenario
URLs baked into an httptest persona server
(composableresource_controller_test.go:737-998); this is the explicit-knob
equivalent with probabilistic, scripted, and blackout modes.

Knobs (all thread-safe, all injectable mid-run):

- ``failure_rate`` + seeded rng: each verb call fails with probability p
  (soak tests: "10% transient failure rate");
- ``fail_node(node, times)``: the next ``times`` node-scoped calls
  (add/remove/check) targeting ``node`` fail; ``times=-1`` = until healed
  (the "one persistently flaky chip" scenario driving quarantine);
- ``fail_op(op, times)``: scripted failures for one verb by name;
- ``blackout()`` / ``heal()``: every call fails (dead fabric manager) until
  healed — what trips the endpoint-level breaker;
- ``latency`` (seconds, or (lo, hi) range): injected delay per call;
- event-plane faults (the fabric event session's failure modes):
  ``kill_session(times)`` fails the next ``times`` poll_events calls
  (``-1`` = until healed — the mid-wave session drop), ``drop_events`` /
  ``duplicate_events`` / ``reorder_events`` mutate the delivered stream.
  A dropped event is dropped FOREVER (its seq is remembered), modeling a
  lossy stream rather than a retryable fetch — exactly what the session's
  gap-detection + resync machinery exists for.

All injected failures raise ``TransientFabricError`` — chaos models
reachability faults; terminal semantics (pool exhausted, bad model) still
come from the real provider underneath.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    FabricDevice,
    FabricProvider,
    TransientFabricError,
)


class ChaosFabricProvider(FabricProvider):
    def __init__(
        self,
        inner: FabricProvider,
        failure_rate: float = 0.0,
        latency: Union[float, Tuple[float, float]] = 0.0,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self._inner = inner
        self.failure_rate = failure_rate
        self.latency = latency
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._blackout = False
        self._node_failures: Dict[str, int] = {}  # node -> remaining (-1 = forever)
        self._op_failures: Dict[str, int] = {}  # verb name -> remaining
        # Post-Ready failure modes (self-healing data plane): these shape
        # what health the fabric REPORTS rather than raising errors —
        # a degraded chip is a successful call carrying bad news.
        self._degraded_nodes: set = set()  # node blackout after Ready
        self._flapping: Dict[str, int] = {}  # device_id -> probe counter
        self._vanished: set = set()  # device ids omitted from get_resources
        # Event-plane chaos (fabric event session failure modes).
        self._session_kills = 0  # poll_events calls to fail (-1 = forever)
        self._event_drop_rate = 0.0
        self._event_drop_next = 0  # scripted: drop the next N events
        self._event_dup_rate = 0.0
        self._event_reorder_rate = 0.0
        self._dropped_seqs: set = set()  # lost for good (lossy stream)
        self._event_stash: List = []  # held back one batch (cross-batch reorder)
        self.calls = 0
        self.injected = 0  # failures actually raised

    # ------------------------------------------------------------------
    # injection control
    # ------------------------------------------------------------------
    def blackout(self) -> None:
        """Dead-endpoint mode: every call fails until heal()."""
        with self._lock:
            self._blackout = True

    def heal(self) -> None:
        """Clear the blackout, all scripted failures, the post-Ready
        health-shaping modes (degraded nodes, flapping, vanished) AND the
        event-stream faults (already-dropped seqs stay lost — healing the
        wire cannot resurrect a lost message)."""
        with self._lock:
            self._blackout = False
            self._node_failures.clear()
            self._op_failures.clear()
            self._degraded_nodes.clear()
            self._flapping.clear()
            self._vanished.clear()
            self._session_kills = 0
            self._event_drop_rate = 0.0
            self._event_drop_next = 0
            self._event_dup_rate = 0.0
            self._event_reorder_rate = 0.0

    def fail_node(self, node: str, times: int = -1) -> None:
        """Fail node-scoped calls targeting `node`; -1 = until healed."""
        with self._lock:
            self._node_failures[node] = times

    def heal_node(self, node: str) -> None:
        with self._lock:
            self._node_failures.pop(node, None)

    def fail_op(self, op: str, times: int = 1) -> None:
        """Fail the next `times` calls of one verb (e.g. 'get_resources')."""
        with self._lock:
            self._op_failures[op] = times

    # -- event-plane faults ---------------------------------------------
    def kill_session(self, times: int = -1) -> None:
        """Fail the next `times` poll_events calls (-1 = until healed):
        the persistent event session drops mid-stream and must reconnect
        with its resume cursor — or, while dead, the dispatcher must fall
        back to polling with zero missed completions."""
        with self._lock:
            self._session_kills = times

    def restore_session(self) -> None:
        with self._lock:
            self._session_kills = 0

    def drop_events(self, rate: float = 0.0, next_n: int = 0) -> None:
        """Lose events: each delivered event dropped with probability
        `rate`, plus the next `next_n` events dropped deterministically.
        A dropped seq never re-delivers — the consumer sees a sequence
        gap and must resync, not wait."""
        with self._lock:
            self._event_drop_rate = rate
            self._event_drop_next += next_n

    def duplicate_events(self, rate: float) -> None:
        """Re-deliver events with probability `rate` (at-least-once
        stream): consumers must dedupe on seq."""
        with self._lock:
            self._event_dup_rate = rate

    def reorder_events(self, rate: float) -> None:
        """Hold events back one batch with probability `rate`, so newer
        seqs arrive first (cross-batch reorder): consumers must tolerate
        late duplicates and transient gaps."""
        with self._lock:
            self._event_reorder_rate = rate

    # -- post-Ready failure modes (health-shaping, not call failures) ----
    def degrade_node(self, node: str) -> None:
        """Node blackout after Ready: every health probe for resources on
        `node` answers Critical (and get_resources reports its devices
        Critical) until restore_node. Calls still SUCCEED — a brownout is
        the fabric answering with bad news, which is what must drive the
        repair breaker rather than the error-path machinery."""
        with self._lock:
            self._degraded_nodes.add(node)

    def restore_node(self, node: str) -> None:
        with self._lock:
            self._degraded_nodes.discard(node)

    def flap_device(self, device_id: str) -> None:
        """Flapping health: probes of a resource holding `device_id`
        alternate Critical/OK per call — the signal the detection damping
        must absorb without a single status write."""
        with self._lock:
            self._flapping.setdefault(device_id, 0)

    def heal_device(self, device_id: str) -> None:
        with self._lock:
            self._flapping.pop(device_id, None)

    def vanish_device(self, device_id: str) -> None:
        """Listing drift: get_resources omits the device while everything
        else still works — the syncer's device-vanished detection path."""
        with self._lock:
            self._vanished.add(device_id)

    def unvanish_device(self, device_id: str) -> None:
        with self._lock:
            self._vanished.discard(device_id)

    # ------------------------------------------------------------------
    def _chaos(self, op: str, node: str = "") -> None:
        if self.latency:
            lo, hi = (
                self.latency if isinstance(self.latency, tuple)
                else (self.latency, self.latency)
            )
            with self._lock:
                delay = self._rng.uniform(lo, hi)
            if delay > 0:
                self._sleep(delay)
        with self._lock:
            self.calls += 1
            if self._blackout:
                self.injected += 1
                raise TransientFabricError(f"chaos: endpoint blackout ({op})")
            if node and self._node_failures.get(node, 0) != 0:
                if self._node_failures[node] > 0:
                    self._node_failures[node] -= 1
                self.injected += 1
                raise TransientFabricError(
                    f"chaos: injected {op} failure on {node}"
                )
            if self._op_failures.get(op, 0) != 0:
                if self._op_failures[op] > 0:
                    self._op_failures[op] -= 1
                self.injected += 1
                raise TransientFabricError(f"chaos: injected {op} failure")
            if self.failure_rate > 0 and self._rng.random() < self.failure_rate:
                self.injected += 1
                raise TransientFabricError(
                    f"chaos: random {op} failure"
                    + (f" on {node}" if node else "")
                )

    def __getattr__(self, name: str):
        # Pool instrumentation (free_chips, attachment_record, inject_*...)
        # passes through so tests can assert on the wrapped provider.
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # -- provider interface ---------------------------------------------
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        self._chaos("add_resource", resource.spec.target_node)
        return self._inner.add_resource(resource)

    def remove_resource(self, resource: ComposableResource) -> None:
        self._chaos("remove_resource", resource.spec.target_node)
        return self._inner.remove_resource(resource)

    # Group verbs fail as a WHOLE call (one wire RPC = one reachability
    # fault), which is exactly what drives the dispatcher's failure
    # splitting: the member-by-member retries then hit the single-verb
    # injection above, so per-resource accounting is what gets exercised.
    def add_resources(self, resources: List[ComposableResource]) -> List[object]:
        node = resources[0].spec.target_node if resources else ""
        self._chaos("add_resources", node)
        return self._inner.add_resources(resources)

    def remove_resources(self, resources: List[ComposableResource]) -> List[object]:
        node = resources[0].spec.target_node if resources else ""
        self._chaos("remove_resources", node)
        return self._inner.remove_resources(resources)

    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        self._chaos("check_resource", resource.spec.target_node)
        with self._lock:
            if resource.spec.target_node in self._degraded_nodes:
                return DeviceHealth(
                    "Critical",
                    f"chaos: node {resource.spec.target_node} blackout",
                )
            for dev in resource.status.device_ids:
                if dev in self._flapping:
                    self._flapping[dev] += 1
                    if self._flapping[dev] % 2 == 1:
                        return DeviceHealth(
                            "Critical", f"chaos: {dev} health flap"
                        )
        return self._inner.check_resource(resource)

    def get_resources(self) -> List[FabricDevice]:
        self._chaos("get_resources")
        out = self._inner.get_resources()
        with self._lock:
            degraded, vanished = set(self._degraded_nodes), set(self._vanished)
        if vanished:
            out = [d for d in out if d.device_id not in vanished]
        if degraded:
            out = [
                FabricDevice(
                    device_id=d.device_id, node=d.node, model=d.model,
                    slice_name=d.slice_name,
                    health=DeviceHealth(
                        "Critical", f"chaos: node {d.node} blackout"
                    ),
                    type=d.type, resource_name=d.resource_name,
                ) if d.node in degraded else d
                for d in out
            ]
        return out

    def poll_events(self, cursor: int, timeout: float = 5.0):
        """Event stream with injected faults. UnsupportedEvents from the
        inner provider passes through untouched (a capability probe must
        stay a capability probe); the session-kill knob and the general
        chaos gate model wire faults; drop/duplicate/reorder mutate the
        delivered batch while the inner cursor advances normally — which
        is exactly how a lossy transport looks to the subscriber."""
        with self._lock:
            if self._session_kills != 0:
                if self._session_kills > 0:
                    self._session_kills -= 1
                self.injected += 1
                raise TransientFabricError("chaos: event session killed")
        self._chaos("poll_events")
        events, next_cursor = self._inner.poll_events(cursor, timeout)
        with self._lock:
            if not (
                self._event_drop_rate or self._event_drop_next
                or self._event_dup_rate or self._event_reorder_rate
                or self._dropped_seqs or self._event_stash
            ):
                return events, next_cursor
            out: List = []
            stash, self._event_stash = self._event_stash, []
            for ev in events:
                if ev.seq in self._dropped_seqs:
                    continue  # lost for good
                if self._event_drop_next > 0 or (
                    self._event_drop_rate > 0
                    and self._rng.random() < self._event_drop_rate
                ):
                    if self._event_drop_next > 0:
                        self._event_drop_next -= 1
                    self._dropped_seqs.add(ev.seq)
                    self.injected += 1
                    continue
                if (
                    self._event_reorder_rate > 0
                    and self._rng.random() < self._event_reorder_rate
                ):
                    self._event_stash.append(ev)
                    continue
                out.append(ev)
                if (
                    self._event_dup_rate > 0
                    and self._rng.random() < self._event_dup_rate
                ):
                    out.append(ev)
            # Last batch's stashed events arrive AFTER this batch's newer
            # seqs — the cross-batch reorder consumers must absorb.
            out.extend(stash)
            return out, next_cursor

    def reserve_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        self._chaos("reserve_slice")
        return self._inner.reserve_slice(slice_name, model, topology, nodes)

    def release_slice(self, slice_name: str) -> None:
        self._chaos("release_slice")
        return self._inner.release_slice(slice_name)

    def resize_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        self._chaos("resize_slice")
        return self._inner.resize_slice(slice_name, model, topology, nodes)

    def repair_slice_member(
        self, slice_name: str, worker_id: int, node: str
    ) -> None:
        self._chaos("repair_slice_member", node)
        return self._inner.repair_slice_member(slice_name, worker_id, node)
