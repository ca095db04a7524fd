"""Informer read cache + cached client for the in-process Store (port of
``tpu_composer/runtime/cache.py``).

The control loop is round-trip-bound, not compute-bound: under a 10 ms
apiserver RTT an attach pays about a dozen store round trips when every
read goes to the store. The reference operator never pays that read tax —
controller-runtime serves every ``Get``/``List`` from a watch-fed informer
cache and only writes hit the apiserver (the reference's
cmd/main.go:137-155; client-go SharedInformer). This module gives the
standalone in-proc ``Store`` the same split, so a reconcile costs
O(writes), not O(reads+writes):

- :class:`InformerCache` — per-kind local object maps, initial list sync,
  kept current by the store's own watch events (applied in stream order by
  one consumer thread, rv-guarded with deletion tombstones), thread-safe
  snapshot reads, and label-value indexers so the controllers'
  ``managed-by`` child lookups touch only the matching objects instead of
  scanning the kind.
- :class:`CachedClient` — Store-compatible facade: ``get``/``try_get``/
  ``list`` served from the cache with zero RTT; ``create``/``update``/
  ``update_status``/``delete`` pass through write-through, their responses
  folded back into the cache so a reconcile that writes then re-reads sees
  its own write. A stale cached resourceVersion surfaces as the existing
  ``ConflictError`` → rate-limited-requeue path, so correctness (level
  triggering + optimistic concurrency) is unchanged — identical to the
  consistency model every controller-runtime reconciler lives with.
- status-write coalescing — :func:`status_write_needed` skips
  ``update_status`` when the caller read current state (rv matches) and the
  status dict is byte-identical: a pure rv bump the watch would broadcast
  to every controller for nothing. The CachedClient drains the informer to
  a barrier before skipping, so a lagging cache (newer event still queued)
  falls through to the store and surfaces the same ConflictError cache-off
  mode would.

Escape hatch: a caller that does not wrap the store (``maybe_cached(store,
False)``) runs every read on the store directly — semantics are identical,
and the cache's twin tests converge either way.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List, Optional, Set, Tuple, Type, TypeVar

from tpu_composer_torch.api.meta import ApiObject
from tpu_composer_torch.api.types import LABEL_MANAGED_BY
from tpu_composer_torch.runtime.contention import ObservedLock
from tpu_composer_torch.runtime.metrics import (
    cached_reads_total,
    status_writes_coalesced_total,
)
from tpu_composer_torch.runtime.store import (
    DELETED,
    NotFoundError,
    Store,
    WatchEvent,
)

T = TypeVar("T", bound=ApiObject)

log = logging.getLogger("cache")

#: Kinds never served from cache. Leader-election Leases need linearizable
#: reads (client-go reads Leases through a direct client, never the
#: informer), and fleet
#: telemetry snapshots churn every publish period with no reconcile-path
#: reader — an informer per kind would pay watch fan-out for nothing.
UNCACHED_KINDS = frozenset({"Lease", "FleetTelemetry"})

#: Label keys maintained as secondary indexes on every informer. The
#: ``managed-by`` child lookup is the one selector on the reconcile hot
#: path (request controller `_children`, reference
#: composabilityrequest_controller.go:222-235).
DEFAULT_INDEX_KEYS = (LABEL_MANAGED_BY,)


def status_write_needed(cached: Optional[ApiObject], obj: ApiObject) -> bool:
    """Dirty check for ``update_status``: False when the write would be a
    pure no-op rv bump. Coalesces only when the caller's copy is CURRENT
    (rv matches the cached head) — a stale rv must still travel to the
    store so the conflict surfaces and the reconcile re-reads; and only
    when the status dict is identical, field for field."""
    if cached is None:
        return True
    if cached.metadata.resource_version != obj.metadata.resource_version:
        return True
    return cached.status.to_dict() != obj.status.to_dict()  # type: ignore[attr-defined]


class _Barrier:
    """Queue sentinel: the consumer sets the event when it drains past it,
    proving every watch event enqueued earlier has been applied."""

    __slots__ = ("event",)

    def __init__(self) -> None:
        self.event = threading.Event()


class _KindInformer:
    """One kind's watch-fed object map + label indexes.

    Sync protocol (client-go reflector order, adapted to the in-proc
    store's synchronous ``_notify``): subscribe the watch FIRST, then list
    — events racing the list are applied afterwards rv-guarded, so the
    newest state always wins regardless of interleaving. The store's rvs
    are globally monotonic ints, which makes the guard exact (no opaque-rv
    fallback needed here)."""

    def __init__(self, store: Store, kind: str, index_keys=DEFAULT_INDEX_KEYS) -> None:
        self._store = store
        self._kind = kind
        # Contention telemetry: every cached get/list and every watch-event
        # apply crosses this lock — the read-path hot lock
        # (tpuc_lock_wait_seconds{lock="informer:<kind>"}).
        self._lock = ObservedLock(f"informer:{kind}")
        self._objects: Dict[str, ApiObject] = {}
        # label_key -> label_value -> {names}
        self._index_keys = tuple(index_keys)
        self._index: Dict[str, Dict[str, Set[str]]] = {
            k: {} for k in self._index_keys
        }
        # name -> rv at deletion; blocks late write-response folds from
        # resurrecting a purged object.
        self._tombstones: Dict[str, int] = {}
        # Subscribed by start(), not here: __init__ must stay side-effect
        # free so a failed start() leaks no store watch.
        self._events: "queue.Queue" = queue.Queue()
        # Subscriber fan-out: CachedClient.watch routes controller watches
        # THROUGH the informer so every event a controller sees is already
        # applied to the cache it will read during the reconcile. Handing
        # controllers the store's raw queues instead races dispatch against
        # the consumer thread: a reconcile can run before the cache applies
        # its triggering ADDED and read a pre-create None — the event is
        # then consumed with nothing requeued, wedging the object forever.
        # (client-go orders identically: SharedInformer updates its
        # indexer, then calls handlers.)
        self._subs: List["queue.Queue[WatchEvent]"] = []
        self._stopped = threading.Event()
        self._consumer = threading.Thread(
            target=self._run, daemon=True, name=f"informer-{kind}"
        )

    def start(self) -> None:
        """Initial list sync (one store round trip), then stream. On any
        failure the watch subscription is released — a half-started
        informer must not leave an undrained queue on the store."""
        cls = self._store.scheme.lookup(self._kind)  # fail before subscribing
        self._events = self._store.watch(self._kind)
        try:
            for obj in self._store.list(cls):
                self._apply(obj)
        except BaseException:
            self._store.stop_watch(self._events)
            raise
        self._consumer.start()

    def stop(self) -> None:
        self._stopped.set()
        self._store.stop_watch(self._events)
        self._events.put(None)  # wake the consumer so it can observe _stopped
        self._consumer.join(timeout=5)

    # ------------------------------------------------------------------
    # event application (rv-guarded upserts; single consumer thread)
    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped.is_set():
            evt = self._events.get()
            if evt is None:
                continue
            if isinstance(evt, _Barrier):
                evt.event.set()
                continue
            if evt.type == DELETED:
                self._remove(evt.obj.metadata.name,
                             evt.obj.metadata.resource_version)
            else:
                self._apply(evt.obj)
            # Fan out only AFTER the cache applied the event (see __init__
            # note on ordering). Single consumer thread → subscribers see
            # events in stream order.
            with self._lock:
                subs = list(self._subs)
            for q in subs:
                q.put(WatchEvent(evt.type, evt.obj.deepcopy()))

    def subscribe(self, q: "queue.Queue[WatchEvent]") -> None:
        """No snapshot replay (in-proc Store.watch contract — controllers
        do their own initial list, which the cache serves)."""
        with self._lock:
            self._subs.append(q)

    def unsubscribe(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    def _index_add(self, obj: ApiObject) -> None:
        for key in self._index_keys:
            val = obj.metadata.labels.get(key)
            if val:
                self._index[key].setdefault(val, set()).add(obj.metadata.name)

    def _index_drop(self, obj: ApiObject) -> None:
        for key in self._index_keys:
            val = obj.metadata.labels.get(key)
            if val:
                names = self._index[key].get(val)
                if names is not None:
                    names.discard(obj.metadata.name)
                    if not names:
                        del self._index[key][val]

    def _apply(self, obj: ApiObject) -> None:
        name = obj.metadata.name
        rv = obj.metadata.resource_version
        with self._lock:
            if rv <= self._tombstones.get(name, -1):
                return  # raced a deletion the cache already observed
            cur = self._objects.get(name)
            if cur is not None and cur.metadata.resource_version > rv:
                return  # newer state already applied
            if cur is not None:
                self._index_drop(cur)
            self._objects[name] = obj
            self._index_add(obj)

    def _remove(self, name: str, rv: int) -> None:
        with self._lock:
            cur = self._objects.get(name)
            if cur is not None and cur.metadata.resource_version <= rv:
                del self._objects[name]
                self._index_drop(cur)
            # pop-then-set refreshes the dict position, so the eviction
            # below is LRU-by-refresh: a re-deleted same-name object gets a
            # fresh slot instead of inheriting its first deletion's ancient
            # position and being pruned while still hot.
            rv = max(rv, self._tombstones.pop(name, -1))
            self._tombstones[name] = rv
            if len(self._tombstones) > 4096:
                # Bounded memory: old tombstones only matter while writes
                # from that era can still be in flight (seconds).
                for key in list(self._tombstones)[:2048]:
                    del self._tombstones[key]

    # ------------------------------------------------------------------
    # write-through folding (CachedClient calls these synchronously)
    # ------------------------------------------------------------------
    def note_write(self, obj: ApiObject) -> None:
        """Fold a write *response* so read-your-writes holds within one
        reconcile. A response whose deletionTimestamp is set with no
        finalizers left means the store purged the object on this write
        (the remove-last-finalizer PUT)."""
        purged = (
            obj.metadata.deletion_timestamp is not None
            and not obj.metadata.finalizers
        )
        if purged:
            self._remove(obj.metadata.name, obj.metadata.resource_version)
        else:
            self._apply(obj.deepcopy())

    def barrier(self, timeout: float = 5.0) -> bool:
        """Block until every watch event already enqueued is applied. The
        in-proc store notifies watchers synchronously inside the mutating
        call, so a barrier placed after ``store.delete`` returns is
        ordered after the deletion's event — this is how delete's cache
        coherence stays read-your-writes without a wire re-read."""
        b = _Barrier()
        self._events.put(b)
        return b.event.wait(timeout)

    # ------------------------------------------------------------------
    # snapshot reads (deepcopies — cache state is never aliased out)
    # ------------------------------------------------------------------
    def get(self, name: str) -> Optional[ApiObject]:
        with self._lock:
            obj = self._objects.get(name)
        return obj.deepcopy() if obj is not None else None

    def list(
        self, label_selector: Optional[Dict[str, str]] = None
    ) -> List[ApiObject]:
        with self._lock:
            if label_selector:
                # Indexed path: any indexed key in the selector narrows the
                # candidate set to its posting list before the exact filter.
                names: Optional[Set[str]] = None
                for k, v in label_selector.items():
                    if k in self._index:
                        names = set(self._index[k].get(v, ()))
                        break
                candidates = (
                    [self._objects[n] for n in names if n in self._objects]
                    if names is not None
                    else list(self._objects.values())
                )
                out = [
                    o.deepcopy()
                    for o in candidates
                    if all(
                        o.metadata.labels.get(k) == v
                        for k, v in label_selector.items()
                    )
                ]
            else:
                out = [o.deepcopy() for o in self._objects.values()]
        out.sort(key=lambda o: o.metadata.name)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)


class InformerCache:
    """Per-kind informers over one in-proc Store, started lazily on first
    read of each kind (a lazy reflector per kind).

    Lock discipline: ``_lock`` is NEVER held across ``_KindInformer.start()``.
    start() calls ``store.watch()``/``store.list()``, which take
    ``Store._lock`` — and admission hooks (registered on the CachedClient
    by the operator's entry point) run INSIDE ``Store.create``/``update`` holding
    ``Store._lock`` and read back through this cache, taking ``_lock``.
    Holding ``_lock`` across start() therefore acquires the two locks in
    opposite orders on the two paths and a create racing any kind's lazy
    first read deadlocks every store operation (ABBA). Instead a lazy
    start runs a per-kind publish-after-start protocol: mark the kind as
    starting (under ``_lock``), release, run start(), then re-acquire to
    publish; concurrent callers either wait on the kind's start event
    (``wait=True``) or fall back to the raw store for this one read
    (``wait=False`` — required on any path that may already hold
    ``Store._lock``, where waiting on a starter that needs that same lock
    would re-create the deadlock as a wait cycle)."""

    def __init__(self, store: Store, index_keys=DEFAULT_INDEX_KEYS) -> None:
        self._store = store
        self._index_keys = tuple(index_keys)
        self._lock = threading.Lock()
        self._informers: Dict[str, _KindInformer] = {}
        # kind -> Event set when that kind's in-flight start() resolves
        # (published or failed).
        self._starting: Dict[str, threading.Event] = {}
        self._closed = False

    def informer(self, kind: str, wait: bool = True) -> Optional[_KindInformer]:
        """Running informer for ``kind``, starting one if needed.

        ``wait=False`` never blocks: if another thread is mid-start for
        this kind, returns None and the caller serves this read from the
        raw store (identical semantics, one extra RTT, no wait cycle).
        """
        while True:
            with self._lock:
                if self._closed:
                    return None
                inf = self._informers.get(kind)
                if inf is not None:
                    return inf
                ev = self._starting.get(kind)
                if ev is None:
                    ev = threading.Event()
                    self._starting[kind] = ev
                    break  # this thread starts it — with _lock RELEASED
            if not wait:
                return None
            ev.wait()
            # Starter published, failed, or lost to close — re-check.

        inf = _KindInformer(self._store, kind, self._index_keys)
        published = False
        try:
            # Publish only after a successful start: a failed start
            # (unregistered kind, store error mid-list) must not leave a
            # dead informer for later reads/watches to trust.
            inf.start()
            with self._lock:
                if not self._closed:
                    self._informers[kind] = inf
                    published = True
        finally:
            with self._lock:
                self._starting.pop(kind, None)
            ev.set()
        if not published:  # lost the race with stop()
            inf.stop()
            return None
        return inf

    def peek(self, kind: str) -> Optional[_KindInformer]:
        """Running informer for ``kind`` or None — never starts one."""
        with self._lock:
            return self._informers.get(kind)

    def stop(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
            self._informers.clear()
            self._closed = True
        for inf in informers:
            inf.stop()


class CachedClient:
    """Store-compatible client: cached reads, write-through writes.

    Drop-in for ``Store`` everywhere the controllers, scheduler, syncer and
    publisher take a store handle — ``scheme``/``watch``/``stop_watch``/
    ``register_admission`` delegate, so admission webhooks and controller
    watch wiring behave identically. The manager stops the informers on
    shutdown (runtime/manager.py)."""

    def __init__(
        self,
        store: Store,
        uncached_kinds: frozenset = UNCACHED_KINDS,
        index_keys=DEFAULT_INDEX_KEYS,
    ) -> None:
        self.store = store
        self.cache = InformerCache(store, index_keys)
        self._uncached = frozenset(uncached_kinds)
        self._lock = threading.Lock()
        # queue id -> (queue, informer), for informer-routed watches
        # (stop_watch must know where to unsubscribe). The entry holds the
        # queue itself: keying by id() alone would let an abandoned
        # queue's id be reused by a later (raw-store) queue, whose
        # stop_watch would then pop the stale route and never reach
        # store.stop_watch — a strong reference makes aliasing impossible.
        self._watch_routes: Dict[
            int, Tuple["queue.Queue[WatchEvent]", _KindInformer]
        ] = {}

    # -- delegated plumbing -------------------------------------------
    @property
    def scheme(self):
        return self.store.scheme

    def register_admission(self, kind, hook) -> None:
        self.store.register_admission(kind, hook)

    def watch(self, kind=None):
        """Store-compatible watch. Kind-scoped watches are routed THROUGH
        the informer (subscribers see an event only after the cache
        applied it), which is what makes event-triggered reconciles safe
        to read from the cache — the in-proc analog of client-go calling
        handlers after the indexer update. Any-kind and uncached-kind
        watches fall through to the raw store."""
        if kind is not None and kind not in self._uncached:
            from tpu_composer_torch.api.scheme import SchemeError

            try:
                inf = self.cache.informer(kind)
            except SchemeError:
                # Unregistered kind: no class to run the initial list with —
                # the raw store's watch accepts any kind string.
                inf = None
            if inf is not None:
                q: "queue.Queue[WatchEvent]" = queue.Queue()
                inf.subscribe(q)
                with self._lock:
                    self._watch_routes[id(q)] = (q, inf)
                return q
        return self.store.watch(kind)

    def stop_watch(self, q) -> None:
        inf = None
        with self._lock:
            entry = self._watch_routes.get(id(q))
            if entry is not None and entry[0] is q:
                del self._watch_routes[id(q)]
                inf = entry[1]
        if inf is not None:
            inf.unsubscribe(q)
        else:
            self.store.stop_watch(q)

    def keys(self):
        return self.store.keys()

    def __len__(self) -> int:
        return len(self.store)

    def stop_informers(self) -> None:
        self.cache.stop()

    # -- cached reads --------------------------------------------------
    def _informer(self, kind: str) -> Optional[_KindInformer]:
        """wait=False: reads may run inside admission hooks that already
        hold ``Store._lock`` (a validating webhook may be registered on
        this client) — blocking there on another thread's informer start,
        whose initial list needs ``Store._lock``, would deadlock. A read
        racing an in-flight start is served from the raw store instead
        (None), which is semantically identical."""
        if kind in self._uncached:
            return None
        return self.cache.informer(kind, wait=False)

    def get(self, cls: Type[T], name: str) -> T:
        inf = self._informer(cls.KIND)
        if inf is None:
            return self.store.get(cls, name)
        cached_reads_total.inc(verb="get", kind=cls.KIND)
        obj = inf.get(name)
        if obj is None:
            raise NotFoundError(f"{cls.KIND}/{name} not found (cache)")
        return obj  # type: ignore[return-value]

    def try_get(self, cls: Type[T], name: str) -> Optional[T]:
        try:
            return self.get(cls, name)
        except NotFoundError:
            return None

    def list(
        self,
        cls: Type[T],
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[T]:
        inf = self._informer(cls.KIND)
        if inf is None:
            return self.store.list(cls, label_selector)
        cached_reads_total.inc(verb="list", kind=cls.KIND)
        return inf.list(label_selector)  # type: ignore[return-value]

    # -- write-through writes ------------------------------------------
    def _fold(self, obj: ApiObject) -> None:
        inf = self.cache.peek(obj.KIND)
        if inf is not None:
            inf.note_write(obj)

    def create(self, obj: T) -> T:
        out = self.store.create(obj)
        self._fold(out)
        return out

    def update(self, obj: T) -> T:
        out = self.store.update(obj)
        self._fold(out)
        return out

    def update_status(self, obj: T) -> T:
        inf = self.cache.peek(obj.KIND)
        if inf is not None and not status_write_needed(
            inf.get(obj.metadata.name), obj
        ):
            # Identical status at the current rv: both controllers re-write
            # unchanged status on poll requeues; each skipped write saves a
            # wire RTT AND the MODIFIED broadcast that would wake every
            # watcher for nothing.
            #
            # But the cached head can LAG the store (the newer object's
            # event still queued): the raw store would answer this write
            # with ConflictError — forcing the re-read/requeue the
            # controllers rely on — so coalescing here would turn a
            # conflict into a reported success on a stale object. Drain
            # the informer to a barrier (in-proc queue sync, zero store
            # RTTs) and re-check against the drained head; any write that
            # completed before this call has its event applied by then, so
            # the stale case falls through to the store and conflicts
            # exactly like cache-off. (A write racing this call — landing
            # after the barrier — can still coalesce at the old head; raw
            # semantics could serialize our no-op first with the same
            # outcome minus the rv bump, so level triggering converges
            # identically and the racer sees one conflict fewer.)
            if inf.barrier() and not status_write_needed(
                inf.get(obj.metadata.name), obj
            ):
                status_writes_coalesced_total.inc(kind=obj.KIND)
                return obj.deepcopy()
        out = self.store.update_status(obj)
        self._fold(out)
        return out

    def delete(self, cls: Type[T], name: str) -> None:
        self.store.delete(cls, name)
        inf = self.cache.peek(cls.KIND)
        if inf is not None:
            # The store notified watchers synchronously inside delete();
            # draining to a barrier makes the cache reflect the deletion
            # (terminating MODIFIED or purging DELETED) before we return —
            # delete_tolerant's post-delete re-read is then served from
            # cache with the correct deletionTimestamp, zero extra RTT.
            if not inf.barrier():
                log.warning("cache barrier after delete %s/%s timed out",
                            cls.KIND, name)


def maybe_cached(store, enabled: bool):
    """Wrap an in-proc Store in a CachedClient when caching is on.

    Anything that is not an in-proc store (or a chaos/breaker wrapper of
    one) passes through unchanged; so does anything already wrapped. A ChaosStore over the in-proc store caches
    like the bare store would — the informer then sits ABOVE the fault
    injector, the same position it has over a flaky real apiserver."""
    from tpu_composer_torch.runtime.chaosstore import ChaosStore
    from tpu_composer_torch.runtime.storebreaker import BreakingStore

    def _inproc(s) -> bool:
        if isinstance(s, Store):
            return True
        # Fault injector / circuit breaker wrappers cache like the bare
        # store would — the informer sits ABOVE them, so reads keep
        # serving at zero RTT through an injected or real outage.
        if isinstance(s, (ChaosStore, BreakingStore)):
            return _inproc(s._inner)
        return False

    if enabled and _inproc(store):
        return CachedClient(store)
    return store
