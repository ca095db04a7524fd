"""Circuit breaker for fabric providers.

Port of ``tpu_composer/fabric/breaker.py``: the same wire format, defaults,
error classes and metric names.

No reference analog: the reference operator retries every fabric failure on
a fixed 30s requeue and burns a full HTTP timeout per reconcile against a
dead endpoint (composableresource_controller.go requeueOnErr path). Here a
classic closed → open → half-open breaker sits between the controllers and
any FabricProvider:

- CLOSED: calls pass through; ``failure_threshold`` *consecutive* transient
  failures trip the breaker (terminal errors and wait sentinels mean the
  endpoint answered — they reset the streak, they never trip);
- OPEN: calls are rejected immediately with ``BreakerOpenError`` (itself a
  ``TransientFabricError``, so controllers take their normal backoff path
  at microsecond cost instead of a 60s timeout) until ``reset_timeout``
  (jittered ±20% so a fleet of breakers doesn't re-probe in lockstep);
- HALF_OPEN: up to ``half_open_max`` probe calls may pass; the first
  success closes the breaker, the first transient failure re-opens it.

``BreakerFabricProvider`` applies breakers at two granularities:

- one **endpoint** breaker over every call — a dead fabric manager fails
  everything fast;
- one **node** breaker per target node for the node-scoped verbs
  (add/remove/check) — a single flaky host trips only its own breaker, so
  the allocator can route replacement capacity to healthy nodes while the
  sick one fails fast (the attach-budget/quarantine path rides on this).

State transitions are exported via ``fabric_breaker_state`` /
``fabric_breaker_trips_total`` (runtime/metrics.py).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tpu_composer_torch.api.types import ComposableResource
from tpu_composer_torch.fabric.provider import (
    AttachResult,
    DeviceHealth,
    FabricDevice,
    FabricError,
    FabricProvider,
    TransientFabricError,
)
from tpu_composer_torch.runtime.metrics import (
    fabric_breaker_rejections_total,
    fabric_breaker_state,
    fabric_breaker_trips_total,
)

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"

_STATE_VALUES = {STATE_CLOSED: 0.0, STATE_OPEN: 1.0, STATE_HALF_OPEN: 2.0}


class BreakerOpenError(TransientFabricError):
    """The breaker is open — the call was rejected without touching the
    fabric. Transient by definition: the next backoff retry may find the
    breaker half-open and probe through. ``scope`` names the breaker that
    rejected ('' = the endpoint-wide one): consumers that attribute blame
    per node (the attach budget) must ignore endpoint-scoped rejections —
    a dead fabric manager is not evidence against any particular host."""

    def __init__(self, message: str, scope: str = "") -> None:
        super().__init__(message)
        self.scope = scope


@dataclass
class BreakerConfig:
    failure_threshold: int = 5  # consecutive transient failures to trip
    reset_timeout: float = 30.0  # seconds open before half-open probing
    half_open_max: int = 1  # concurrent probes admitted while half-open
    # The endpoint-wide breaker needs a HIGHER threshold than the per-node
    # ones: a single flaky host must trip only its own breaker (so the
    # allocator reroutes), while a true endpoint blackout — failures across
    # many nodes plus list/slice calls — still trips fast. None = 3×.
    endpoint_failure_threshold: Optional[int] = None

    def for_scope(self, scope: str) -> "BreakerConfig":
        if scope:
            return self
        threshold = self.endpoint_failure_threshold
        if threshold is None:
            threshold = self.failure_threshold * 3
        return BreakerConfig(
            failure_threshold=threshold,
            reset_timeout=self.reset_timeout,
            half_open_max=self.half_open_max,
            endpoint_failure_threshold=threshold,
        )


class CircuitBreaker:
    """One breaker instance; thread-safe. ``clock``/``rng`` injectable for
    deterministic tests."""

    def __init__(
        self,
        endpoint: str,
        scope: str = "",
        config: Optional[BreakerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.endpoint = endpoint
        self.scope = scope
        self.config = config or BreakerConfig()
        self._clock = clock
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0  # consecutive transient failures while closed
        self._open_until = 0.0
        self._probes = 0  # calls admitted since entering half-open
        self._publish()

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def acquire(self) -> None:
        """Admit one call or raise BreakerOpenError. Every successful
        acquire MUST be balanced by success()/failure()/cancel()."""
        with self._lock:
            if self._state == STATE_OPEN:
                if self._clock() < self._open_until:
                    self._reject()
                self._set_state(STATE_HALF_OPEN)
            if self._state == STATE_HALF_OPEN:
                if self._probes >= self.config.half_open_max:
                    self._reject()
                self._probes += 1

    def cancel(self) -> None:
        """Undo an acquire whose call never ran (a sibling breaker rejected
        it) — without this a half-open probe slot would leak and the
        breaker could starve with no outcome ever recorded."""
        with self._lock:
            if self._state == STATE_HALF_OPEN and self._probes > 0:
                self._probes -= 1

    def success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != STATE_CLOSED:
                self._set_state(STATE_CLOSED)

    def failure(self) -> None:
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._trip()
                return
            self._failures += 1
            if self._failures >= self.config.failure_threshold:
                self._trip()

    # -- internals (caller holds the lock) ------------------------------
    def _reject(self) -> None:
        fabric_breaker_rejections_total.inc(
            endpoint=self.endpoint, scope=self.scope
        )
        raise BreakerOpenError(
            f"circuit breaker open for {self.endpoint}"
            + (f" (node {self.scope})" if self.scope else ""),
            scope=self.scope,
        )

    def _trip(self) -> None:
        self._failures = 0
        # ±20% jitter keeps a fleet of breakers tripped by one blackout
        # from re-probing the healed endpoint in the same instant.
        self._open_until = self._clock() + self.config.reset_timeout * (
            0.8 + 0.4 * self._rng.random()
        )
        self._set_state(STATE_OPEN)
        fabric_breaker_trips_total.inc(endpoint=self.endpoint, scope=self.scope)

    def _set_state(self, state: str) -> None:
        self._state = state
        self._probes = 0
        self._publish()

    def _publish(self) -> None:
        fabric_breaker_state.set(
            _STATE_VALUES[self._state], endpoint=self.endpoint, scope=self.scope
        )

    def dispose(self) -> None:
        """Retire this breaker's metric series (its node left the fleet)."""
        labels = {"endpoint": self.endpoint, "scope": self.scope}
        fabric_breaker_state.remove(**labels)
        fabric_breaker_trips_total.remove(**labels)
        fabric_breaker_rejections_total.remove(**labels)


class BreakerFabricProvider(FabricProvider):
    """Wrap any FabricProvider with endpoint + per-node circuit breakers.

    Outcome classification: only TransientFabricError counts as a breaker
    failure. Wait sentinels and terminal FabricErrors prove the endpoint is
    alive and reset the failure streak.
    """

    def __init__(
        self,
        inner: FabricProvider,
        endpoint: str = "fabric",
        config: Optional[BreakerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._inner = inner
        self.endpoint = endpoint
        self.config = config or BreakerConfig()
        self._clock = clock
        self._rng = rng
        self._lock = threading.Lock()
        self._endpoint_breaker = self._new_breaker("")
        self._node_breakers: Dict[str, CircuitBreaker] = {}

    def _new_breaker(self, scope: str) -> CircuitBreaker:
        return CircuitBreaker(
            self.endpoint, scope, self.config.for_scope(scope),
            clock=self._clock, rng=self._rng,
        )

    def breaker(self, node: str = "") -> CircuitBreaker:
        if not node:
            return self._endpoint_breaker
        with self._lock:
            b = self._node_breakers.get(node)
            if b is None:
                b = self._node_breakers[node] = self._new_breaker(node)
            return b

    def forget_node(self, node: str) -> None:
        """Drop a deleted node's breaker + metric series. Without this a
        churning (autoscaled/preemptible) fleet grows _node_breakers and
        /metrics cardinality forever. The resource controller calls this
        from its Node-DELETED watch; a recreated same-name node simply
        gets a fresh closed breaker on first use."""
        with self._lock:
            b = self._node_breakers.pop(node, None)
        if b is not None:
            b.dispose()

    def __getattr__(self, name: str):
        # Non-verb attributes (test pools' free_chips, inject_* hooks...)
        # pass through so the wrapper is transparent to instrumentation.
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # ------------------------------------------------------------------
    def _call(self, node: str, fn: Callable, *args):
        # Node breaker first: if the node is open, the endpoint breaker's
        # half-open probe slot must not be consumed by a call that never
        # runs (the mirrored order plus cancel() covers the other case).
        breakers: List[CircuitBreaker] = (
            [self.breaker(node)] if node else []
        ) + [self._endpoint_breaker]
        acquired: List[CircuitBreaker] = []
        for b in breakers:
            try:
                b.acquire()
            except BreakerOpenError:
                for a in acquired:
                    a.cancel()
                raise
            acquired.append(b)
        try:
            out = fn(*args)
        except TransientFabricError:
            for b in breakers:
                b.failure()
            raise
        except Exception:
            # Wait sentinels, terminal FabricError, bugs: the endpoint
            # answered (or the fault is ours) — not a reachability failure.
            for b in breakers:
                b.success()
            raise
        for b in breakers:
            b.success()
        return out

    # -- provider interface ---------------------------------------------
    def add_resource(self, resource: ComposableResource) -> AttachResult:
        return self._call(
            resource.spec.target_node, self._inner.add_resource, resource
        )

    def remove_resource(self, resource: ComposableResource) -> None:
        return self._call(
            resource.spec.target_node, self._inner.remove_resource, resource
        )

    # Group verbs: one batch is one wire call against one node, guarded by
    # that node's breaker + the endpoint breaker. Per-member outcomes
    # travel INSIDE a successful response (never raised), so only a
    # whole-call reachability fault counts as a breaker failure — the
    # dispatcher's split retries then run through the single verbs with
    # normal per-node accounting. UnsupportedBatch is a capability probe,
    # not an outcome: it must not consume a half-open probe slot's verdict
    # (_call already treats non-transient raises as endpoint-alive).
    def add_resources(self, resources: List[ComposableResource]) -> List[object]:
        node = resources[0].spec.target_node if resources else ""
        return self._call(node, self._inner.add_resources, resources)

    def remove_resources(self, resources: List[ComposableResource]) -> List[object]:
        node = resources[0].spec.target_node if resources else ""
        return self._call(node, self._inner.remove_resources, resources)

    def poll_events(self, cursor: int, timeout: float = 5.0):
        """Deliberately UN-breakered delegation. Two reasons it must exist
        explicitly: (1) the base class defines poll_events (raising
        UnsupportedEvents), so ``__getattr__`` never fires for it — without
        this override the breaker wrapper would silently disable the event
        plane for every remote backend it guards; (2) the session has its
        own reconnect backoff, and a long-poll's routine timeouts/failures
        must not consume breaker failure streaks or half-open probe slots
        meant for the mutation path."""
        return self._inner.poll_events(cursor, timeout)

    def check_resource(self, resource: ComposableResource) -> DeviceHealth:
        return self._call(
            resource.spec.target_node, self._inner.check_resource, resource
        )

    def get_resources(self) -> List[FabricDevice]:
        return self._call("", self._inner.get_resources)

    def reserve_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        return self._call(
            "", self._inner.reserve_slice, slice_name, model, topology, nodes
        )

    def release_slice(self, slice_name: str) -> None:
        return self._call("", self._inner.release_slice, slice_name)

    def resize_slice(
        self, slice_name: str, model: str, topology: str, nodes: List[str]
    ) -> None:
        return self._call(
            "", self._inner.resize_slice, slice_name, model, topology, nodes
        )

    def repair_slice_member(
        self, slice_name: str, worker_id: int, node: str
    ) -> None:
        # Node-scoped: the re-carve lands on the replacement's node.
        return self._call(
            node, self._inner.repair_slice_member, slice_name, worker_id, node
        )
