"""Controller base: watch → work queue → reconcile loop.

Reference analog: controller-runtime's Builder/Controller as wired in
SetupWithManager (composabilityrequest_controller.go:681-690 — For(primary) +
Watches(secondary, mapper, predicate)). Semantics preserved:

- events are collapsed to object-name keys; reconciles are level-triggered and
  per-key serialized (a key never runs concurrently with itself);
- a reconcile returns ``Result(requeue_after=...)`` or raises — errors write
  backoff requeues, mirroring requeueOnErr
  (composableresource_controller.go:436-446);
- secondary watches map events to primary keys via a mapper fn and can be
  filtered by a predicate (the reference's status-change-only predicate,
  composabilityrequest_controller.go:658-678).

Tests drive ``reconcile`` directly, one state transition at a time, exactly
like the reference's suites (SURVEY.md §4 "Tests invoke Reconcile directly").
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.contention import BusyTracker
from tpu_composer_torch.runtime.queue import RateLimitingQueue
from tpu_composer_torch.runtime.store import ConflictError, Store, WatchEvent


@dataclass
class Result:
    requeue_after: float = 0.0  # seconds; 0 = done until next event


# mapper: WatchEvent -> list of primary keys to enqueue
EventMapper = Callable[[WatchEvent], List[str]]
# predicate: WatchEvent -> bool (False drops the event)
EventPredicate = Callable[[WatchEvent], bool]


class Controller:
    """Subclass and implement ``reconcile(self, name) -> Result``."""

    #: KIND string of the primary watched type; subclasses set this.
    primary_kind: str = ""

    #: Exception types that are expected operational outcomes (already
    #: surfaced in status.error by the reconciler) — retried with backoff but
    #: logged without a traceback.
    quiet_exceptions: tuple = ()

    #: Fleet identity tagging trace events from this controller's threads
    #: (set by the owning Manager when it has a replica_id): N in-proc
    #: replicas sharing one trace ring render as N Perfetto processes.
    replica_id: Optional[str] = None

    def __init__(
        self, store: Store, name: Optional[str] = None, ownership=None
    ) -> None:
        self.store = store
        self.name = name or type(self).__name__
        self.log = logging.getLogger(self.name)
        # Shard ownership (runtime.shards.ShardOwnership) — None means
        # unsharded: every key is this replica's to reconcile (the
        # single-leader default, bit-identical to the pre-shard path).
        # With an ownership view, keys whose shard this replica does not
        # hold are dropped at enqueue AND at dequeue (dequeue too because
        # ownership can flip while a key sits queued); the shard's new
        # owner re-enqueues them via the manager resync hook.
        self.ownership = ownership
        # Liveness + load-shedding hooks (wired by cmd/main when enabled):
        # workers beat the watchdog under their thread name every queue
        # wake, and the request controller's shed_gate defers low-priority
        # keys while the overload governor is shedding.
        self.watchdog = None
        self.shed_gate: Optional[Callable[[str], Optional[float]]] = None
        self.queue = RateLimitingQueue(name=self.name)
        # Saturation telemetry: workers report per-turn busy seconds and
        # the tracker level-sets tpuc_worker_busy_ratio{pool=<name>}.
        self._busy = BusyTracker(self.name)
        self._watches: List[Tuple[str, Optional[EventMapper], Optional[EventPredicate]]] = []
        self._watch_queues: List = []
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        if self.primary_kind:
            self.watch(self.primary_kind)

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def watch(
        self,
        kind: str,
        mapper: Optional[EventMapper] = None,
        predicate: Optional[EventPredicate] = None,
    ) -> None:
        self._watches.append((kind, mapper, predicate))

    def reconcile(self, name: str) -> Result:  # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------
    def start(self, workers: int = 1) -> None:
        self._stop.clear()
        # A stopped queue never accepts again; restart gets a fresh one.
        self.queue = RateLimitingQueue(name=self.name)
        self._busy.workers = max(1, workers)
        for kind, mapper, predicate in self._watches:
            q = self.store.watch(kind)
            self._watch_queues.append(q)
            t = threading.Thread(
                target=self._dispatch_loop,
                args=(q, mapper, predicate),
                name=f"{self.name}-dispatch-{kind}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        # Initial reconcile wave over pre-existing primaries (cache-sync analog;
        # this is what makes operator restart resume mid-state-machine).
        if self.primary_kind:
            cls = self.store.scheme.lookup(self.primary_kind)
            for obj in self.store.list(cls):  # type: ignore[type-var]
                if self._owned(obj.metadata.name):
                    self.queue.add(obj.metadata.name)
        for i in range(workers):
            t = threading.Thread(
                target=self._worker_loop, name=f"{self.name}-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shutdown()
        for q in self._watch_queues:
            self.store.stop_watch(q)
        self._watch_queues.clear()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _dispatch_loop(
        self,
        q,
        mapper: Optional[EventMapper],
        predicate: Optional[EventPredicate],
    ) -> None:
        if self.replica_id:
            tracing.bind_thread(self.replica_id)
        while not self._stop.is_set():
            try:
                # Only the expected timeout is absorbed: a bare `except
                # Exception` here used to swallow real mapper/store bugs
                # into a silent 0.2 s spin loop.
                event: WatchEvent = q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if event is None:
                continue  # wake-up sentinel some feeders use on shutdown
            try:
                if predicate is not None and not predicate(event):
                    continue
                keys = mapper(event) if mapper else [event.obj.metadata.name]
            except Exception:
                # A mapper/predicate bug must not kill the dispatch thread
                # (events would silently stop flowing) — log loudly, drop
                # the one event, keep dispatching.
                self.log.exception("dispatch: mapper/predicate failed for %s",
                                   getattr(event, "type", event))
                continue
            for key in keys:
                if self._owned(key):
                    self.queue.add(key)

    def _owned(self, key) -> bool:
        return self.ownership is None or self.ownership.owns_key(key)

    def _worker_loop(self) -> None:
        if self.replica_id:
            tracing.bind_thread(self.replica_id)
        wd, wd_name = self.watchdog, threading.current_thread().name
        try:
            while not self._stop.is_set():
                key = self.queue.get(timeout=0.2)
                if wd is not None:
                    # Every wake — idle or not — is progress: a healthy
                    # worker beats ≥5x/s (get timeout 0.2s), so the
                    # default stall threshold has huge margin.
                    wd.beat(wd_name)
                if key is None:
                    self._busy.add(0.0)  # idle wake still advances the window
                    continue
                self._work_one(key)
        finally:
            if wd is not None:
                # A clean shutdown must not race the final scan into a
                # phantom stall.
                wd.unregister(wd_name)

    def _work_one(self, key: str) -> None:
        turn_t0 = time.monotonic()
        if not self._owned(key):
            # Shard moved (or was never ours) while the key sat
            # queued: drop it without reconciling — the shard's owner
            # serves it. pop_context first so the parked trace handoff
            # can't leak; done() releases the processing mark.
            self.queue.pop_context(key)
            self.queue.done(key)
            return
        if self.shed_gate is not None:
            # Overload shed: the gate (runtime.overload.request_shed_gate)
            # returns a defer delay for low-priority keys while the
            # governor is shedding, or None to proceed. Deferral re-parks
            # the key WITHOUT counting a rate-limit failure — the work is
            # healthy, the control plane isn't. Gate bugs fail open.
            try:
                delay = self.shed_gate(key)
            except Exception:
                delay = None
            if delay is not None and delay > 0:
                self.queue.pop_context(key)
                self.queue.add_after(key, delay)
                self.queue.done(key)
                self._busy.add(0.0)
                return
        # Cross-thread causality: an add() made inside a traced span (a
        # dispatcher completion latch, a sibling reconcile) parked a
        # TraceContext for this key — joining it here draws the Chrome
        # flow arrow from that span into this reconcile and makes the
        # trace_id (the pending_op nonce) this thread's active trace.
        ctx = self.queue.pop_context(key)
        try:
            with tracing.span(
                "reconcile", cat="controller",
                controller=self.name, object=key, ctx=ctx,
            ) as sp:
                result = self.reconcile(key)  # type: ignore[arg-type]
                sp["outcome"] = (
                    f"requeue:{result.requeue_after:g}s"
                    if result and result.requeue_after > 0 else "done"
                )
        except ConflictError:
            # Stale read — immediate retry with fresh state (controller-
            # runtime requeues conflicts without logging an error).
            self.queue.add_rate_limited(key)
        except Exception as e:
            if isinstance(e, self.quiet_exceptions):
                self.log.warning("reconcile %s: %s", key, e)
            else:
                self.log.exception("reconcile %s failed", key)
            self.queue.add_rate_limited(key)
        else:
            self.queue.forget(key)
            if result and result.requeue_after > 0:
                self.queue.add_after(key, result.requeue_after)
        finally:
            self.queue.done(key)
            self._busy.add(time.monotonic() - turn_t0)
