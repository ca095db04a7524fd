"""ChaosStore — store-layer fault injection for any Store-shaped client
(port of ``tpu_composer/runtime/chaosstore.py``).

The apiserver twin of ``fabric/chaos.py``: where ChaosFabricProvider
injects faults between the controllers and the pool manager, this wraps the
OBJECT STORE (the in-proc ``Store`` or any Store-shaped client) and injects the failure
modes a real kube-apiserver serves up under load — exactly the surface the
crash-consistency machinery (durable intent, adoption, conflict-requeue)
has to absorb:

- ``failure_rate``: each CRUD call fails with probability p as a
  ``StoreError`` ("transient 5xx"); injected BEFORE the inner call, so the
  request never commits (the retryable-loss model);
- ``conflict_rate``: mutating calls (update/update_status/delete) fail as
  ``ConflictError`` — the optimistic-concurrency 409 every controller must
  already requeue on;
- ``latency`` (seconds or (lo, hi) range): injected per call, outside any
  store lock, like real RTTs;
- ``watch_drop_rate``: each delivered watch event is dropped with
  probability p, modeling a lossy watch stream. NOTE: the in-proc informer
  cache has no periodic resync — combine this knob with uncached reads
  (level-triggered poll requeues repair missed events; a permanently
  stale informer cannot);
- ``fail_verb(verb, times)`` / ``blackout()`` / ``heal()``: scripted and
  total-outage modes, mirroring the fabric chaos knobs;
- ``blackout_for(seconds)`` / ``script_blackouts(windows)`` /
  ``script_random_blackouts(...)``: TIMED outage windows on an injectable
  clock, so an outage test scripts duration instead of counting mutations
  — the dark-store brownout soak's instrument. ``heal()`` clears every
  scripted fault (timed windows included), parity with
  ``ChaosFabricProvider.heal``.

All injections count into ``tpuc_store_chaos_injected_total{verb,mode}``.
Off unless a caller wraps the store in it; the CachedClient stacks on top unchanged (reads then come
from the informer and only writes traverse the chaos layer — the same
asymmetry a real deployment has).
"""

from __future__ import annotations

import queue as _queue
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Type, TypeVar, Union

from tpu_composer_torch.api.meta import ApiObject
from tpu_composer_torch.runtime.metrics import store_chaos_injected_total
from tpu_composer_torch.runtime.store import (
    ConflictError,
    NotFoundError,
    StoreError,
    WatchEvent,
)

T = TypeVar("T", bound=ApiObject)

_MUTATING = frozenset({"create", "update", "update_status", "delete"})


class _DroppingWatch:
    """Queue proxy that loses WatchEvents with probability ``rate``.

    Control items (None wake-up sentinels, informer barriers) always pass —
    chaos models event loss, not transport deadlock."""

    def __init__(self, inner: "_queue.Queue", chaos: "ChaosStore") -> None:
        self._q = inner
        self._chaos = chaos

    def get(self, block: bool = True, timeout: Optional[float] = None):
        while True:
            item = self._q.get(block, timeout)
            if isinstance(item, WatchEvent) and self._chaos._drop_event():
                continue  # swallowed by the wire
            return item

    def put(self, item, *args, **kwargs) -> None:
        self._q.put(item, *args, **kwargs)

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()


class ChaosStore:
    def __init__(
        self,
        inner,
        failure_rate: float = 0.0,
        conflict_rate: float = 0.0,
        latency: Union[float, Tuple[float, float]] = 0.0,
        watch_drop_rate: float = 0.0,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._inner = inner
        self.failure_rate = failure_rate
        self.conflict_rate = conflict_rate
        self.latency = latency
        self.watch_drop_rate = watch_drop_rate
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        self._blackout = False
        #: timed blackout windows: absolute (start, end) on self._clock.
        #: blackout_for() appends one starting now; script_blackouts()
        #: appends future ones. Expired windows are pruned lazily.
        self._blackout_windows: List[Tuple[float, float]] = []
        self._verb_failures: Dict[str, int] = {}  # verb -> remaining (-1 forever)
        self.calls = 0
        self.injected = 0

    # ------------------------------------------------------------------
    # injection control (mirrors ChaosFabricProvider)
    # ------------------------------------------------------------------
    def blackout(self) -> None:
        """Dead-apiserver mode: every CRUD call fails until heal()."""
        with self._lock:
            self._blackout = True

    def blackout_for(self, seconds: float) -> None:
        """Timed outage: every CRUD call fails for ``seconds`` from now,
        then the store heals itself (no explicit heal() needed) — tests
        script outage DURATION instead of counting mutations."""
        now = self._clock()
        with self._lock:
            self._blackout_windows.append((now, now + seconds))

    def script_blackouts(
        self, windows: List[Tuple[float, float]]
    ) -> List[Tuple[float, float]]:
        """Schedule blackout windows ``[(start_in_s, duration_s), ...]``
        relative to now; returns the absolute (start, end) schedule."""
        now = self._clock()
        sched = [(now + start, now + start + dur) for start, dur in windows]
        with self._lock:
            self._blackout_windows.extend(sched)
        return sched

    def script_random_blackouts(
        self,
        count: int,
        min_s: float = 5.0,
        max_s: float = 8.0,
        min_gap_s: float = 1.0,
        max_gap_s: float = 3.0,
    ) -> List[Tuple[float, float]]:
        """Randomized outage script (what the brownout soak runs): ``count``
        windows of U(min_s, max_s) seconds separated by U(min_gap_s,
        max_gap_s) gaps, drawn from the seeded rng; returns the absolute
        (start, end) schedule so the test knows exactly when the store is
        dark."""
        rel: List[Tuple[float, float]] = []
        at = 0.0
        with self._lock:
            for _ in range(count):
                dur = self._rng.uniform(min_s, max_s)
                rel.append((at, dur))
                at += dur + self._rng.uniform(min_gap_s, max_gap_s)
        return self.script_blackouts(rel)

    def blackout_active(self) -> bool:
        """True while any blackout (switched or timed) is in force."""
        with self._lock:
            return self._blackout_now(self._clock())

    def _blackout_now(self, now: float) -> bool:
        # caller holds the lock; prunes expired windows as it goes
        if self._blackout:
            return True
        if self._blackout_windows:
            self._blackout_windows = [
                (s, e) for s, e in self._blackout_windows if e > now
            ]
            return any(s <= now for s, _ in self._blackout_windows)
        return False

    def heal(self) -> None:
        """Clear every injected fault: the blackout switch, all timed and
        scripted blackout windows, and scripted verb failures — parity
        with ``ChaosFabricProvider.heal()`` (rate-based knobs stay; they
        are configuration, not state)."""
        with self._lock:
            self._blackout = False
            self._blackout_windows.clear()
            self._verb_failures.clear()

    def fail_verb(self, verb: str, times: int = 1) -> None:
        """Fail the next ``times`` calls of one verb; -1 = until healed."""
        with self._lock:
            self._verb_failures[verb] = times

    # ------------------------------------------------------------------
    def _chaos(self, verb: str, kind: str) -> None:
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
            if self._blackout_now(self._clock()):
                self.injected += 1
                store_chaos_injected_total.inc(verb=verb, mode="transient")
                raise StoreError(f"chaos: apiserver blackout ({verb} {kind})")
            if self._verb_failures.get(verb, 0) != 0:
                if self._verb_failures[verb] > 0:
                    self._verb_failures[verb] -= 1
                self.injected += 1
                store_chaos_injected_total.inc(verb=verb, mode="transient")
                raise StoreError(f"chaos: injected {verb} failure ({kind})")
            if self.failure_rate > 0 and self._rng.random() < self.failure_rate:
                self.injected += 1
                store_chaos_injected_total.inc(verb=verb, mode="transient")
                raise StoreError(
                    f"chaos: transient apiserver 5xx ({verb} {kind})"
                )
            if (
                verb in _MUTATING and verb != "create"
                and self.conflict_rate > 0
                and self._rng.random() < self.conflict_rate
            ):
                self.injected += 1
                store_chaos_injected_total.inc(verb=verb, mode="conflict")
                raise ConflictError(
                    f"chaos: injected write conflict ({verb} {kind})"
                )

    def _drop_event(self) -> bool:
        if self.watch_drop_rate <= 0:
            return False
        with self._lock:
            if self._rng.random() < self.watch_drop_rate:
                self.injected += 1
                store_chaos_injected_total.inc(verb="watch", mode="watch_drop")
                return True
        return False

    # ------------------------------------------------------------------
    # Store interface (CRUD traverses _chaos; plumbing delegates)
    # ------------------------------------------------------------------
    @property
    def scheme(self):
        return self._inner.scheme

    def register_admission(self, kind, hook) -> None:
        self._inner.register_admission(kind, hook)

    def create(self, obj: T) -> T:
        self._chaos("create", obj.KIND)
        return self._inner.create(obj)

    def get(self, cls: Type[T], name: str) -> T:
        self._chaos("get", cls.KIND)
        return self._inner.get(cls, name)

    def try_get(self, cls: Type[T], name: str) -> Optional[T]:
        try:
            return self.get(cls, name)  # through chaos: flaky reads flake
        except NotFoundError:
            return None

    def list(self, cls: Type[T], label_selector=None) -> List[T]:
        self._chaos("list", cls.KIND)
        return self._inner.list(cls, label_selector)

    def update(self, obj: T) -> T:
        self._chaos("update", obj.KIND)
        return self._inner.update(obj)

    def update_status(self, obj: T) -> T:
        self._chaos("update_status", obj.KIND)
        return self._inner.update_status(obj)

    def delete(self, cls: Type[T], name: str) -> None:
        self._chaos("delete", cls.KIND)
        return self._inner.delete(cls, name)

    # ------------------------------------------------------------------
    # watches
    # ------------------------------------------------------------------
    def watch(self, kind=None):
        q = self._inner.watch(kind)
        if self.watch_drop_rate <= 0:
            return q
        return _DroppingWatch(q, self)

    def stop_watch(self, q) -> None:
        if isinstance(q, _DroppingWatch):
            return self._inner.stop_watch(q._q)
        return self._inner.stop_watch(q)

    # ------------------------------------------------------------------
    # passthrough plumbing (keys/len/persistence/informer shutdown)
    # ------------------------------------------------------------------
    def keys(self):
        return self._inner.keys()

    def __len__(self) -> int:
        return len(self._inner)

    def __getattr__(self, name: str):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)
