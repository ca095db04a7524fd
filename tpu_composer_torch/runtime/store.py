"""In-process, watchable, persistent object store.

Plays the role the K8s API server + etcd play for the reference operator:

- optimistic concurrency via ``metadata.resource_version`` (update conflicts
  surface as ConflictError, the analog of a 409 that controller-runtime
  requeues on);
- a status subresource: ``update_status`` persists only ``status`` (the
  reference CRDs declare ``+kubebuilder:subresource:status``,
  composabilityrequest_types.go:82-84);
- finalizer-gated deletion: ``delete`` sets ``deletionTimestamp`` while
  finalizers remain, and the object is purged when the last finalizer is
  removed — exactly the lifecycle the reference's handleDeletingState relies
  on (composableresource_controller.go:418-434);
- label-selector listing (the reference lists children by
  ``app.kubernetes.io/managed-by``, composabilityrequest_controller.go:222-235);
- watches with ADDED/MODIFIED/DELETED events feeding controller work queues
  (analog of controller-runtime's source.Kind watches, cmd/main.go:167-194);
- optional file persistence, one JSON doc per object, making the object store
  itself the checkpoint/resume mechanism (SURVEY.md §5 "the CRDs *are* the
  checkpoint").

Objects handed out and accepted are deep-copied at the boundary, so callers
can mutate freely — same contract as client-go's cache + typed client.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type, TypeVar

from tpu_composer_torch.api.meta import ApiObject, new_uid, now_iso
from tpu_composer_torch.api.scheme import Scheme, default_scheme
from tpu_composer_torch.runtime.contention import ObservedLock
from tpu_composer_torch.runtime.metrics import (
    store_requests_total,
    store_watch_queue_depth,
)

T = TypeVar("T", bound=ApiObject)

#: Watcher queues are unbounded; past this depth the consumer is falling
#: behind and we say so (gauge + one warning per crossing) instead of
#: silently buffering events forever.
WATCH_QUEUE_WARN_DEPTH = 1024

_log = logging.getLogger("store")


class StoreError(Exception):
    pass


class NotFoundError(StoreError):
    pass


class AlreadyExistsError(StoreError):
    pass


class ConflictError(StoreError):
    """resourceVersion mismatch — caller must re-get and retry."""


ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


def delete_tolerant(store: "Store", cls, name: str):
    """Delete ``name`` tolerating a concurrent purge, then re-read.

    Returns the surviving (terminating, finalizer-bearing) object, or None
    when it is already gone — either the delete hit 404 or the object had no
    finalizer and purged outright. Deletion-path reconcile steps use this so
    an object vanishing between the cache read and the API call means "done",
    not an exception — the reference wraps every deletion-path call in
    client.IgnoreNotFound (composableresource_controller.go:87,143,160;
    composabilityrequest_controller.go:153-157)."""
    try:
        store.delete(cls, name)
    except NotFoundError:
        return None
    return store.try_get(cls, name)


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    obj: ApiObject


@dataclass
class _Watcher:
    """One subscription: its kind filter, queue, stable metric identity,
    and whether the depth warning already fired for the current backlog."""

    kind: Optional[str]
    q: "queue.Queue[WatchEvent]"
    label: str = ""
    warned: bool = field(default=False, compare=False)


# An admission hook runs inside create/update with (op, new_obj, old_obj) and
# may mutate new_obj or raise to reject. op ∈ {"CREATE", "UPDATE", "DELETE"}.
# Reference analog: the validating webhook registered at cmd/main.go:196-201.
AdmissionHook = Callable[[str, ApiObject, Optional[ApiObject]], None]


class Store:
    def __init__(
        self,
        scheme: Optional[Scheme] = None,
        persist_dir: Optional[str] = None,
        latency_s: float = 0.0,
    ) -> None:
        """``latency_s`` injects an apiserver-like round-trip delay at the
        entry of every CRUD call (outside the lock, so concurrent clients
        overlap their waits the way HTTP requests to a real apiserver do).
        Used by bench.py for the honest reference comparison: the reference
        pays a networked kube-apiserver on every store op, the in-proc store
        pays nanoseconds — the injected mode levels that."""
        self._scheme = scheme or default_scheme()
        self._latency_s = latency_s
        # Contention telemetry: the store lock serializes every CRUD call
        # and watch notification — wait/hold land in
        # tpuc_lock_wait_seconds{lock="store"} (reentrant: admission hooks
        # run inside create/update and may read back through the store).
        self._lock = ObservedLock("store", reentrant=True)
        # kind -> name -> object (all cluster-scoped, like the reference's
        # CRDs, +kubebuilder:resource:scope=Cluster). The per-kind secondary
        # index keeps ``list`` from scanning and sorting every kind's keys
        # on each call — list runs on every reconcile, caching on or off.
        self._by_kind: Dict[str, Dict[str, ApiObject]] = {}
        self._watchers: List[_Watcher] = []
        self._watch_seq = 0
        self._admission: List[Tuple[str, AdmissionHook]] = []  # (kind or "*", hook)
        self._rv_counter = 0
        self._persist_dir = persist_dir
        if persist_dir:
            self._load(persist_dir)

    @property
    def scheme(self) -> Scheme:
        return self._scheme

    # ------------------------------------------------------------------
    # persistence (checkpoint/resume)
    # ------------------------------------------------------------------
    def _obj_path(self, kind: str, name: str) -> str:
        assert self._persist_dir
        return os.path.join(self._persist_dir, kind, f"{name}.json")

    def _persist(self, obj: ApiObject) -> None:
        if not self._persist_dir:
            return
        path = self._obj_path(obj.KIND, obj.metadata.name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj.to_dict(), f, sort_keys=True)
        os.replace(tmp, path)

    def _unpersist(self, kind: str, name: str) -> None:
        if not self._persist_dir:
            return
        try:
            os.remove(self._obj_path(kind, name))
        except FileNotFoundError:
            pass

    def _load(self, persist_dir: str) -> None:
        if not os.path.isdir(persist_dir):
            return
        max_rv = 0
        for kind in os.listdir(persist_dir):
            kdir = os.path.join(persist_dir, kind)
            if not os.path.isdir(kdir):
                continue
            for fn in os.listdir(kdir):
                if not fn.endswith(".json"):
                    continue
                with open(os.path.join(kdir, fn)) as f:
                    obj = self._scheme.decode(json.load(f))
                self._by_kind.setdefault(obj.KIND, {})[obj.metadata.name] = obj
                max_rv = max(max_rv, obj.metadata.resource_version)
        self._rv_counter = max_rv

    # ------------------------------------------------------------------
    # admission + watch registration
    # ------------------------------------------------------------------
    def register_admission(self, kind: str, hook: AdmissionHook) -> None:
        """kind="*" applies to every kind."""
        with self._lock:
            self._admission.append((kind, hook))

    def watch(self, kind: Optional[str] = None) -> "queue.Queue[WatchEvent]":
        """Subscribe to events; kind=None receives everything.

        Returns an unbounded queue the caller drains. Existing objects are NOT
        replayed — controllers do their own initial list (same as
        controller-runtime's cache sync + initial reconcile wave, which our
        Controller base performs on start).
        """
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        with self._lock:
            self._watch_seq += 1
            self._watchers.append(
                _Watcher(kind, q, label=f"{kind or '*'}-{self._watch_seq}")
            )
        return q

    def stop_watch(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            kept = []
            for w in self._watchers:
                if w.q is q:
                    store_watch_queue_depth.remove(watcher=w.label)
                else:
                    kept.append(w)
            self._watchers = kept

    def _notify(self, event_type: str, obj: ApiObject) -> None:
        snap = obj.deepcopy()
        for w in self._watchers:
            if w.kind is None or w.kind == obj.KIND:
                w.q.put(WatchEvent(event_type, snap))
                depth = w.q.qsize()
                store_watch_queue_depth.set(float(depth), watcher=w.label)
                if depth > WATCH_QUEUE_WARN_DEPTH:
                    if not w.warned:
                        w.warned = True
                        _log.warning(
                            "watcher %s queue depth %d exceeds %d —"
                            " consumer is falling behind",
                            w.label, depth, WATCH_QUEUE_WARN_DEPTH,
                        )
                elif depth <= WATCH_QUEUE_WARN_DEPTH // 2:
                    w.warned = False

    def _run_admission(self, op: str, new: ApiObject, old: Optional[ApiObject]) -> None:
        for kind, hook in list(self._admission):
            if kind == "*" or kind == new.KIND:
                hook(op, new, old)

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------
    def _next_rv(self) -> int:
        self._rv_counter += 1
        return self._rv_counter

    def _rtt(self) -> None:
        if self._latency_s:
            import time

            time.sleep(self._latency_s)

    def create(self, obj: T) -> T:
        store_requests_total.inc(verb="create", kind=obj.KIND)
        self._rtt()
        obj = obj.deepcopy()
        if not obj.metadata.name:
            raise StoreError("metadata.name is required")
        with self._lock:
            kind_objs = self._by_kind.setdefault(obj.KIND, {})
            if obj.metadata.name in kind_objs:
                raise AlreadyExistsError(f"{obj.KIND}/{obj.metadata.name} already exists")
            # Admission (mutating) runs before schema validation, matching the
            # K8s admission chain the reference's webhook participates in.
            self._run_admission("CREATE", obj, None)
            if hasattr(obj, "validate"):
                obj.validate()
            obj.metadata.uid = obj.metadata.uid or new_uid()
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.generation = 1
            obj.metadata.creation_timestamp = obj.metadata.creation_timestamp or now_iso()
            obj.metadata.deletion_timestamp = None
            kind_objs[obj.metadata.name] = obj
            self._persist(obj)
            self._notify(ADDED, obj)
            return obj.deepcopy()

    def get(self, cls: Type[T], name: str) -> T:
        store_requests_total.inc(verb="get", kind=cls.KIND)
        self._rtt()
        with self._lock:
            try:
                obj = self._by_kind.get(cls.KIND, {})[name]
            except KeyError:
                raise NotFoundError(f"{cls.KIND}/{name} not found") from None
            return obj.deepcopy()  # type: ignore[return-value]

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
        store_requests_total.inc(verb="list", kind=cls.KIND)
        self._rtt()
        with self._lock:
            # Per-kind index: only this kind's objects are touched — list
            # runs on every reconcile, so the old all-kinds scan+sort cost
            # O(total objects log total) per call even with caching off.
            out: List[T] = []
            for _, obj in sorted(self._by_kind.get(cls.KIND, {}).items()):
                if label_selector and any(
                    obj.metadata.labels.get(k) != v for k, v in label_selector.items()
                ):
                    continue
                out.append(obj.deepcopy())  # type: ignore[arg-type]
            return out

    def _check_conflict(self, stored: ApiObject, incoming: ApiObject) -> None:
        if incoming.metadata.resource_version != stored.metadata.resource_version:
            raise ConflictError(
                f"{incoming.KIND}/{incoming.metadata.name}: resourceVersion"
                f" {incoming.metadata.resource_version} != {stored.metadata.resource_version}"
            )

    def update(self, obj: T) -> T:
        """Update spec + metadata; status is preserved from the stored copy.

        If the object is terminating and this update removes the last
        finalizer, the object is purged (DELETED event) — K8s semantics.
        """
        store_requests_total.inc(verb="update", kind=obj.KIND)
        self._rtt()
        obj = obj.deepcopy()
        with self._lock:
            kind_objs = self._by_kind.get(obj.KIND, {})
            stored = kind_objs.get(obj.metadata.name)
            if stored is None:
                raise NotFoundError(f"{obj.KIND}/{obj.metadata.name} not found")
            self._check_conflict(stored, obj)
            self._run_admission("UPDATE", obj, stored.deepcopy())
            if hasattr(obj, "validate"):
                obj.validate()

            spec_changed = stored.spec.to_dict() != obj.spec.to_dict()  # type: ignore[attr-defined]
            obj.status = copy.deepcopy(stored.status)  # type: ignore[attr-defined]
            # Immutable/system-owned fields
            obj.metadata.uid = stored.metadata.uid
            obj.metadata.creation_timestamp = stored.metadata.creation_timestamp
            obj.metadata.deletion_timestamp = stored.metadata.deletion_timestamp
            obj.metadata.generation = stored.metadata.generation + (1 if spec_changed else 0)
            obj.metadata.resource_version = self._next_rv()

            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                del kind_objs[obj.metadata.name]
                self._unpersist(obj.KIND, obj.metadata.name)
                self._notify(DELETED, obj)
                return obj.deepcopy()

            kind_objs[obj.metadata.name] = obj
            self._persist(obj)
            self._notify(MODIFIED, obj)
            return obj.deepcopy()

    def update_status(self, obj: T) -> T:
        """Persist only ``status`` (status subresource semantics)."""
        store_requests_total.inc(verb="update_status", kind=obj.KIND)
        self._rtt()
        obj = obj.deepcopy()
        with self._lock:
            kind_objs = self._by_kind.get(obj.KIND, {})
            stored = kind_objs.get(obj.metadata.name)
            if stored is None:
                raise NotFoundError(f"{obj.KIND}/{obj.metadata.name} not found")
            self._check_conflict(stored, obj)
            updated = stored.deepcopy()
            updated.status = obj.status  # type: ignore[attr-defined]
            updated.metadata.resource_version = self._next_rv()
            kind_objs[obj.metadata.name] = updated
            self._persist(updated)
            self._notify(MODIFIED, updated)
            return updated.deepcopy()  # type: ignore[return-value]

    def delete(self, cls: Type[T], name: str) -> None:
        """Finalizer-aware delete.

        With finalizers present: marks deletionTimestamp and emits MODIFIED so
        controllers run their teardown states (the reference's Cleaning /
        Detaching paths). Without: purges immediately.
        """
        store_requests_total.inc(verb="delete", kind=cls.KIND)
        self._rtt()
        with self._lock:
            kind_objs = self._by_kind.get(cls.KIND, {})
            stored = kind_objs.get(name)
            if stored is None:
                raise NotFoundError(f"{cls.KIND}/{name} not found")
            # Hooks get copies: a mutating hook must not corrupt canonical
            # state outside the rv/persist/notify path.
            self._run_admission("DELETE", stored.deepcopy(), stored.deepcopy())
            if stored.metadata.finalizers:
                if stored.metadata.deletion_timestamp is None:
                    updated = stored.deepcopy()
                    updated.metadata.deletion_timestamp = now_iso()
                    updated.metadata.resource_version = self._next_rv()
                    kind_objs[name] = updated
                    self._persist(updated)
                    self._notify(MODIFIED, updated)
                return
            del kind_objs[name]
            self._unpersist(cls.KIND, name)
            self._notify(DELETED, stored)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def keys(self) -> Iterable[Tuple[str, str]]:
        with self._lock:
            return [
                (kind, name)
                for kind, objs in self._by_kind.items()
                for name in objs
            ]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(objs) for objs in self._by_kind.values())
