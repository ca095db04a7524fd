"""Crash and clock helpers for the port's HA twins (tests/test_torch_
{lease_election,shards,crash_restart,shard_failover}.py): each builds the
same object for either package, so one scenario runs on both.

- ``recording_pool(tw, **kw)``: an ``InMemoryPool`` that logs every
  attachment materialization with the durable-intent nonce that caused
  it, and every release (tests/test_crash_restart.py's RecordingPool).
- ``CrashFuse(tw, inner, fuse)``: a store facade that models a process
  crash: after ``fuse`` mutating calls the failing write and every call
  after it raise the package's ``StoreError``.
- ``assert_no_double_attach(events)``: releases alternate with
  materializations and no nonce materializes twice.
- ``ElectorClock`` with ``elector_clock(tw)``: the lease electors'
  clocks (``time.monotonic`` and ``now_iso`` of ``runtime.leases`` and
  ``runtime.shards``, and ``LeaseElector._now``) replaced by one clock
  that moves only when stepped. A scenario then compares outcomes and
  step counts, never elapsed times.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from types import SimpleNamespace


def recording_pool(tw, **kw):
    class RecordingPool(tw.inmem.InMemoryPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.events = []  # ("attach", name, nonce) | ("release", name)

        def _add_one_locked(self, resource):
            name = resource.metadata.name
            before = name in self._attachments
            result = super()._add_one_locked(resource)
            if not before and name in self._attachments:
                po = resource.status.pending_op
                self.events.append(("attach", name, po.nonce if po else ""))
            return result

        def _remove_one_locked(self, resource):
            name = resource.metadata.name
            before = name in self._attachments
            super()._remove_one_locked(resource)
            if before and name not in self._attachments:
                self.events.append(("release", name))

    return RecordingPool(**kw)


def assert_no_double_attach(events):
    open_attach = {}
    seen = set()
    for ev in events:
        if ev[0] == "attach":
            _, name, nonce = ev
            assert name not in open_attach, f"double attach for {name}: {events}"
            open_attach[name] = nonce
            assert (name, nonce) not in seen, f"nonce {nonce!r} twice: {events}"
            seen.add((name, nonce))
        else:
            open_attach.pop(ev[1], None)


class CrashFuse:
    """Store facade: after ``fuse`` mutating calls (``None``: never),
    or from ``die()`` on, every call raises ``StoreError``."""

    _MUTATING = frozenset({"create", "update", "update_status", "delete"})

    def __init__(self, tw, inner, fuse=None):
        self._error = tw.store.StoreError
        self._inner = inner
        self._fuse = fuse
        self._lock = threading.Lock()
        self.mutations = 0
        self.dead = threading.Event()

    def die(self):
        self.dead.set()

    def _gate(self, verb):
        with self._lock:
            if self.dead.is_set():
                raise self._error("crash: process dead")
            if verb in self._MUTATING:
                self.mutations += 1
                if self._fuse is not None and self.mutations > self._fuse:
                    self.dead.set()
                    raise self._error("crash: process died mid-write")

    def create(self, obj):
        self._gate("create")
        return self._inner.create(obj)

    def get(self, cls, name):
        self._gate("get")
        return self._inner.get(cls, name)

    def try_get(self, cls, name):
        self._gate("get")
        return self._inner.try_get(cls, name)

    def list(self, cls, label_selector=None):
        self._gate("list")
        return self._inner.list(cls, label_selector)

    def update(self, obj):
        self._gate("update")
        return self._inner.update(obj)

    def update_status(self, obj):
        self._gate("update_status")
        return self._inner.update_status(obj)

    def delete(self, cls, name):
        self._gate("delete")
        return self._inner.delete(cls, name)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)


class ElectorClock:
    """Monotonic seconds and the wall stamps derived from them, moved
    only by ``step``."""

    def __init__(self):
        self.t = 1000.0
        self._wall0 = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

    def monotonic(self):
        return self.t

    def now_dt(self):
        return self._wall0 + datetime.timedelta(seconds=self.t)

    def now_iso(self):
        return self.now_dt().isoformat(timespec="microseconds").replace(
            "+00:00", "Z")

    def step(self, seconds):
        self.t += seconds


@contextlib.contextmanager
def elector_clock(tw):
    """Both electors' clocks and the fleet plane's observation clock in
    package ``tw`` replaced by a fresh ``ElectorClock`` for the
    duration."""
    clock = ElectorClock()
    fake_time = SimpleNamespace(monotonic=clock.monotonic, sleep=time.sleep)
    patches = [(tw.leases, "time", fake_time), (tw.leases, "now_iso", clock.now_iso),
               (tw.shards, "time", fake_time), (tw.shards, "now_iso", clock.now_iso),
               (tw.fleet, "time", fake_time), (tw.fleet, "now_iso", clock.now_iso),
               (tw.leases.LeaseElector, "_now", lambda self: clock.now_dt())]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    try:
        yield clock
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


def steps_until(clock, predicate, step=0.05, limit=400):
    """Step ``clock`` by ``step`` until ``predicate()`` holds; the number
    of steps taken, or None after ``limit`` steps."""
    for i in range(limit):
        if predicate():
            return i
        clock.step(step)
    return None
