"""The port's informer cache (tpu_composer_torch/runtime/cache.py) against
the JAX package's (tests/test_cache.py's twin).

Each scenario runs once per package (``run_both``) and returns what it
observed: cached objects, resourceVersions, store round-trip counts,
coalesced writes, raised error classes, index contents, log lines and the
end states of a threaded operator. The scenario also asserts the
reference test's own invariants on each package. Tolerance: exact.

Timing: the threaded scenarios (watch delivery, churn, the operators of
the e2e cases) compare outcomes and counts, never elapsed times; their
waits poll for a condition.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import pytest
import torch

from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)


def make_node(tw, store, name, slots=4):
    n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=name))
    n.status.tpu_slots = slots
    return store.create(n)


def make_child(tw, client, name, owner="", node="worker-0"):
    t = tw.types
    r = t.ComposableResource(metadata=tw.meta.ObjectMeta(name=name))
    if owner:
        r.metadata.labels[t.LABEL_MANAGED_BY] = owner
    r.spec.type = "tpu"
    r.spec.model = "tpu-v4"
    r.spec.target_node = node
    return client.create(r)


@contextlib.contextmanager
def world(tw, **store_kw):
    """A fresh Store and a CachedClient over it; the informers stop on
    exit."""
    store = tw.store.Store(**store_kw)
    client = tw.cache.CachedClient(store)
    try:
        yield store, client
    finally:
        client.stop_informers()


@contextlib.contextmanager
def captured(logger_name, level):
    """The messages logged to ``logger_name`` at ``level`` or above."""
    records = []

    class _H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger(logger_name)
    h = _H(level)
    old = lg.level
    lg.addHandler(h)
    lg.setLevel(min(level, old) if old else level)
    try:
        yield records
    finally:
        lg.removeHandler(h)
        lg.setLevel(old)


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def raised(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 - the class is compared
        return type(e).__name__
    return None


# -- cached reads --------------------------------------------------------------

def reads_served_from_cache_zero_store_rtts(tw):
    rtt = tw.metrics.store_requests_total
    with world(tw) as (store, client):
        make_node(tw, store, "worker-0")
        client.get(tw.types.Node, "worker-0")
        before = rtt.total()
        out = []
        for _ in range(25):
            out.append((client.get(tw.types.Node, "worker-0").status.tpu_slots,
                        len(client.list(tw.types.Node)),
                        client.try_get(tw.types.Node, "missing")))
        assert rtt.total() == before
        return [out[0], len(out), rtt.total() - before]


def read_your_writes_within_one_thread(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        make_child(tw, client, "c1", owner="req1")
        got = client.get(CR, "c1")
        got.status.state = "Attaching"
        out = client.update_status(got)
        again = client.get(CR, "c1")
        assert again.status.state == "Attaching"
        assert again.metadata.resource_version == out.metadata.resource_version
        return [again.status.state, again.metadata.resource_version]


def watch_events_ordered_after_cache_apply(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        q = client.watch("ComposableResource")
        try:
            for i in range(30):
                make_child(tw, client, f"obj-{i}")
            seen = []
            deadline = time.monotonic() + 10
            while len(seen) < 30 and time.monotonic() < deadline:
                try:
                    evt = q.get(timeout=1.0)
                except Exception:
                    break
                cached = client.try_get(CR, evt.obj.metadata.name)
                assert cached is not None
                assert (cached.metadata.resource_version
                        >= evt.obj.metadata.resource_version)
                seen.append((evt.type, evt.obj.metadata.name))
            assert len(seen) == 30
            return seen
        finally:
            client.stop_watch(q)


def direct_store_writes_converge_into_cache(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        client.list(CR)
        make_child(tw, store, "ext-1")
        a = wait_for(lambda: client.try_get(CR, "ext-1") is not None)
        store.delete(CR, "ext-1")
        b = wait_for(lambda: client.try_get(CR, "ext-1") is None)
        assert a and b
        return [a, b]


def delete_visible_to_next_cached_read(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        c = make_child(tw, client, "d1")
        c.metadata.finalizers = ["tpu.composer.dev/lifecycle"]
        client.update(c)
        surviving = tw.store.delete_tolerant(client, CR, "d1")
        assert surviving is not None and surviving.being_deleted
        surviving.metadata.finalizers = []
        client.update(surviving)
        gone = client.try_get(CR, "d1")
        make_child(tw, client, "d2")
        outright = tw.store.delete_tolerant(client, CR, "d2")
        assert gone is None and outright is None
        return [surviving.being_deleted, gone, outright]


def failed_informer_start_leaves_no_debris(tw):
    with world(tw) as (store, client):
        before = len(store._watchers)
        q = client.watch("NoSuchKind")
        peek = client.cache.peek("NoSuchKind")
        during = len(store._watchers) - before
        client.stop_watch(q)
        after = len(store._watchers) - before
        assert peek is None and during == 1 and after == 0
        return [peek, during, after]


def tombstone_refresh_survives_pruning(tw):
    with world(tw) as (store, client):
        inf = client.cache.informer("ComposableResource")
        with inf._lock:
            for i in range(4096):
                inf._tombstones[f"old-{i}"] = i
            inf._tombstones["hot"] = 1
        inf._remove("hot", 99999)
        with inf._lock:
            inf._tombstones["overflow"] = 100000
        inf._remove("trigger", 100001)
        with inf._lock:
            hot = inf._tombstones.get("hot")
            cold = "old-0" in inf._tombstones
            size = len(inf._tombstones)
        assert hot == 99999 and not cold
        return [hot, cold, size]


def uncached_kinds_pass_through(tw):
    rtt = tw.metrics.store_requests_total
    with world(tw) as (store, client):
        client.create(tw.lease.Lease(metadata=tw.meta.ObjectMeta(name="leader")))
        before = rtt.total()
        client.get(tw.lease.Lease, "leader")
        assert rtt.total() == before + 1
        return rtt.total() - before


# -- the conflict path ---------------------------------------------------------

def stale_cached_rv_conflicts_then_converges(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        make_child(tw, client, "c1")
        stale = client.get(CR, "c1")
        fresh = store.get(CR, "c1")
        fresh.status.state = "Attaching"
        store.update_status(fresh)
        stale.status.state = "Online"
        err = raised(client.update_status, stale)
        seen = wait_for(lambda: client.get(CR, "c1").status.state == "Attaching")
        retry = client.get(CR, "c1")
        retry.status.state = "Online"
        client.update_status(retry)
        final = store.get(CR, "c1").status.state
        assert err == "ConflictError" and seen and final == "Online"
        return [err, seen, final]


def conflict_error_requeues_and_reconcile_converges(tw):
    CR = tw.types.ComposableResource
    Store = tw.store.Store

    with world(tw) as (store, client):
        class Touch(tw.controller.Controller):
            primary_kind = "ComposableResource"

            def __init__(self, store_):
                super().__init__(store_)
                self.attempts = 0
                self.done = threading.Event()

            def reconcile(self, name):
                self.attempts += 1
                obj = self.store.try_get(CR, name)
                if obj is None:
                    return tw.controller.Result()
                if obj.status.state != "Online":
                    if self.attempts == 1:
                        racer = Store.get(store, CR, name)
                        store.update_status(racer)
                    obj.status.state = "Online"
                    self.store.update_status(obj)
                    self.done.set()
                return tw.controller.Result()

        ctrl = Touch(client)
        ctrl.start(workers=1)
        try:
            make_child(tw, client, "r1")
            done = ctrl.done.wait(10)
            online = wait_for(lambda: store.get(CR, "r1").status.state == "Online")
            assert done and online and ctrl.attempts >= 2
            return [done, online, ctrl.attempts >= 2]
        finally:
            ctrl.stop()


# -- status coalescing ---------------------------------------------------------

def identical_status_write_skipped(tw):
    CR = tw.types.ComposableResource
    rtt = tw.metrics.store_requests_total
    skipped = tw.metrics.status_writes_coalesced_total
    with world(tw) as (store, client):
        make_child(tw, client, "c1")
        cur = client.get(CR, "c1")
        r0, s0 = rtt.total(), skipped.total()
        out = client.update_status(cur)
        rec = [rtt.total() - r0, skipped.total() - s0,
               out.metadata.resource_version == cur.metadata.resource_version]
        assert rec == [0, 1, True]
        return rec


def changed_status_still_writes(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        make_child(tw, client, "c1")
        cur = client.get(CR, "c1")
        cur.status.state = "Attaching"
        out = client.update_status(cur)
        rec = [out.metadata.resource_version > cur.metadata.resource_version,
               store.get(CR, "c1").status.state]
        assert rec == [True, "Attaching"]
        return rec


def stale_rv_never_coalesced(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        make_child(tw, client, "c1")
        stale = client.get(CR, "c1")
        fresh = client.get(CR, "c1")
        fresh.status.state = "Attaching"
        client.update_status(fresh)
        stale.status.state = "Attaching"
        err = raised(client.update_status, stale)
        assert err == "ConflictError"
        return err


def lagging_cache_never_coalesces_a_conflict(tw):
    CR = tw.types.ComposableResource
    with world(tw) as (store, client):
        make_child(tw, client, "c1")
        stale = client.get(CR, "c1")
        inf = client.cache.peek("ComposableResource")
        orig_apply = inf._apply

        def slow_apply(obj):
            time.sleep(0.05)
            orig_apply(obj)

        inf._apply = slow_apply
        fresh = store.get(CR, "c1")
        fresh.status.state = "Attaching"
        store.update_status(fresh)
        err = raised(client.update_status, stale)
        assert err == "ConflictError"
        return err


# -- lazy informer start -------------------------------------------------------

def admission_hook_read_races_lazy_informer_start(tw):
    CRq = tw.types.ComposabilityRequest
    alive = []
    for _ in range(30):
        store = tw.store.Store(latency_s=0.002)
        client = tw.cache.CachedClient(store)

        def hook(op, new, old, client=client):
            client.list(CRq)

        client.register_admission("*", hook)
        barrier = threading.Barrier(2)

        def creator(client=client, barrier=barrier):
            barrier.wait()
            make_node(tw, client, "worker-0")

        def reader(client=client, barrier=barrier):
            barrier.wait()
            client.list(CRq)

        threads = [threading.Thread(target=creator, daemon=True),
                   threading.Thread(target=reader, daemon=True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        alive.append(any(t.is_alive() for t in threads))
        client.stop_informers()
    assert not any(alive), "lazy informer start deadlocked"
    return alive


def _slow_start(tw):
    orig = tw.cache._KindInformer.start
    entered, gate = threading.Event(), threading.Event()

    def slow_start(self):
        entered.set()
        assert gate.wait(10)
        orig(self)

    return slow_start, entered, gate


def reads_never_block_on_inflight_start(tw):
    rtt = tw.metrics.store_requests_total
    slow_start, entered, gate = _slow_start(tw)
    with world(tw) as (store, client), \
            patched(tw.cache._KindInformer, "start", slow_start):
        make_node(tw, store, "worker-0")
        starter = threading.Thread(target=lambda: client.cache.informer("Node"),
                                   daemon=True)
        starter.start()
        assert entered.wait(5)
        free = client.cache._lock.acquire(timeout=2)
        client.cache._lock.release()
        before = rtt.total()
        got = []
        reader = threading.Thread(
            target=lambda: got.append(client.get(tw.types.Node, "worker-0")),
            daemon=True)
        reader.start()
        reader.join(timeout=5)
        rec = [free, reader.is_alive(), [g.metadata.name for g in got],
               rtt.total() - before]
        gate.set()
        starter.join(timeout=10)
        rec += [starter.is_alive(), client.cache.peek("Node") is not None]
        assert rec == [True, False, ["worker-0"], 1, False, True]
        return rec


def waiters_observe_published_informer(tw):
    slow_start, entered, gate = _slow_start(tw)
    with world(tw) as (store, client), \
            patched(tw.cache._KindInformer, "start", slow_start):
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(client.cache.informer("Node")),
            daemon=True) for _ in range(3)]
        for t in threads:
            t.start()
        assert entered.wait(5)
        gate.set()
        for t in threads:
            t.join(timeout=10)
        rec = [any(t.is_alive() for t in threads), len(results),
               all(r is results[0] and r is not None for r in results)]
        assert rec == [False, 3, True]
        return rec


# -- watch routes --------------------------------------------------------------

def routes_hold_queue_strongly(tw):
    with world(tw) as (store, client):
        q = client.watch("Node")
        strong = client._watch_routes[id(q)][0] is q
        client.stop_watch(q)
        rec = [strong, id(q) in client._watch_routes]
        assert rec == [True, False]
        return rec


def stale_route_alias_still_stops_store_watch(tw):
    with world(tw) as (store, client):
        inf = client.cache.informer("Node")
        raw_q = client.watch("Lease")
        before = len(store._watchers)
        client._watch_routes[id(raw_q)] = (object(), inf)
        client.stop_watch(raw_q)
        delta = len(store._watchers) - before
        del client._watch_routes[id(raw_q)]
        assert delta == -1
        return delta


def dirty_check_helper(tw):
    need = tw.cache.status_write_needed
    with world(tw) as (store, client):
        obj = make_child(tw, client, "c1")
        same = obj.deepcopy()
        rec = [need(obj, same)]
        same.status.state = "Online"
        rec.append(need(obj, same))
        stale = obj.deepcopy()
        stale.metadata.resource_version -= 1
        rec += [need(obj, stale), need(None, obj)]
        assert rec == [False, True, True, True]
        return rec


# -- the indexer ---------------------------------------------------------------

def _by_owner(tw, client, owner):
    CR = tw.types.ComposableResource
    return sorted(o.name for o in client.list(
        CR, label_selector={tw.types.LABEL_MANAGED_BY: owner}))


def managed_by_selector_uses_index(tw):
    with world(tw) as (store, client):
        for i in range(10):
            make_child(tw, client, f"a-{i}", owner="req-a")
            make_child(tw, client, f"b-{i}", owner="req-b")
        make_child(tw, client, "orphan")
        rec = [_by_owner(tw, client, "req-a"), _by_owner(tw, client, "nope")]
        assert rec == [sorted(f"a-{i}" for i in range(10)), []]
        return rec


def index_follows_label_rewrites_and_deletes(tw):
    t = tw.types
    with world(tw) as (store, client):
        c = make_child(tw, client, "c1", owner="req-a")
        c.metadata.labels[t.LABEL_MANAGED_BY] = "req-b"
        client.update(c)
        rec = [_by_owner(tw, client, "req-b"), _by_owner(tw, client, "req-a")]
        client.delete(t.ComposableResource, "c1")
        rec.append(_by_owner(tw, client, "req-b"))
        assert rec == [["c1"], [], []]
        return rec


def indexer_under_concurrent_create_delete(tw):
    t = tw.types
    CR = t.ComposableResource
    with world(tw) as (store, client):
        client.list(CR)
        stop = threading.Event()
        errors = []

        def churn(owner, n):
            try:
                for i in range(n):
                    make_child(tw, client, f"{owner}-{i}", owner=owner)
                for i in range(0, n, 2):
                    client.delete(CR, f"{owner}-{i}")
            except Exception as e:  # pragma: no cover - surfaced via errors
                errors.append(e)

        def read():
            while not stop.is_set():
                for owner in ("req-x", "req-y"):
                    for o in client.list(
                            CR, label_selector={t.LABEL_MANAGED_BY: owner}):
                        if o.metadata.labels.get(t.LABEL_MANAGED_BY) != owner:
                            errors.append(AssertionError(f"leak: {o.name}"))

        threads = [threading.Thread(target=churn, args=("req-x", 30)),
                   threading.Thread(target=churn, args=("req-y", 30))]
        reader = threading.Thread(target=read)
        reader.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        stop.set()
        reader.join(10)
        assert not errors, errors[:3]
        assert wait_for(lambda: {o.name for o in client.list(CR)}
                        == {o.name for o in store.list(CR)})
        rec = {owner: _by_owner(tw, client, owner) for owner in ("req-x", "req-y")}
        for owner, names in rec.items():
            assert names == sorted(o.name for o in store.list(
                CR, label_selector={t.LABEL_MANAGED_BY: owner}))
        return rec


# -- the store's kind index, watch depth and dispatch loop ---------------------

def list_correct_across_kinds_and_mutations(tw):
    t = tw.types
    store = tw.store.Store()
    make_node(tw, store, "n1")
    make_child(tw, store, "c1", owner="r1")
    make_child(tw, store, "c2")
    rec = [[o.name for o in store.list(t.Node)],
           [o.name for o in store.list(t.ComposableResource)],
           [o.name for o in store.list(t.ComposableResource,
                                       label_selector={t.LABEL_MANAGED_BY: "r1"})]]
    store.delete(t.ComposableResource, "c1")
    rec += [[o.name for o in store.list(t.ComposableResource)],
            [o.name for o in store.list(t.Node)],
            sorted(store.keys()), len(store)]
    assert rec[-2] == [("ComposableResource", "c2"), ("Node", "n1")]
    return rec


def persistence_reload_keeps_kind_index(tw, root):
    t = tw.types
    path = str(root / tw.root / "state")
    s1 = tw.store.Store(persist_dir=path)
    make_node(tw, s1, "n1")
    make_child(tw, s1, "c1")
    s2 = tw.store.Store(persist_dir=path)
    rec = [[o.name for o in s2.list(t.Node)],
           [o.name for o in s2.list(t.ComposableResource)], len(s2)]
    assert rec == [["n1"], ["c1"], 2]
    return rec


def depth_gauge_and_warning(tw):
    depth = tw.metrics.store_watch_queue_depth
    store = tw.store.Store()
    with patched(tw.store, "WATCH_QUEUE_WARN_DEPTH", 10), \
            captured("store", logging.WARNING) as logs:
        q = store.watch("ComposableResource")
        label = store._watchers[-1].label
        for i in range(15):
            make_child(tw, store, f"c-{i}")
        rec = [depth.value(watcher=label),
               sum("falling behind" in m for m in logs)]
        store.stop_watch(q)
        rec.append(depth.value(watcher=label))
    assert rec == [15.0, 1, 0.0]
    return rec


def mapper_exception_logged_not_silent(tw):
    store = tw.store.Store()

    class Broken(tw.controller.Controller):
        primary_kind = ""

        def __init__(self, store_):
            super().__init__(store_)
            self.seen = threading.Event()
            self.watch("ComposableResource", mapper=self._boom)

        def _boom(self, ev):
            if ev.obj.metadata.name == "bad":
                raise RuntimeError("mapper bug")
            return [ev.obj.metadata.name]

        def reconcile(self, name):
            self.seen.set()
            return tw.controller.Result()

    ctrl = Broken(store)
    with captured("Broken", logging.ERROR) as logs:
        ctrl.start(workers=1)
        try:
            make_child(tw, store, "bad")
            logged = wait_for(lambda: any("mapper/predicate failed" in m
                                          for m in logs))
            make_child(tw, store, "good")
            seen = ctrl.seen.wait(5)
        finally:
            ctrl.stop()
    assert logged and seen
    return [logged, seen]


# -- e2e: the operator on cached reads and without them ------------------------

def _operator(tw, client, pool=None, fabric=None):
    pool = pool or tw.inmem.InMemoryPool()
    fabric = fabric or pool
    mgr = tw.manager.Manager(store=client)
    mgr.add_controller(tw.req.ComposabilityRequestReconciler(
        client, fabric,
        timing=tw.req.RequestTiming(updating_poll=0.05, cleaning_poll=0.05)))
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        client, fabric, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                    detach_poll=0.05, detach_fast=0.05,
                                    busy_poll=0.05)))
    mgr.start(workers_per_controller=2)
    return mgr, pool


def submit(tw, store, name, size=8):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=size))))


def _state(tw, store, name):
    r = store.try_get(tw.types.ComposabilityRequest, name)
    return None if r is None else r.status.state


def lifecycle_converges(tw, cached):
    t = tw.types
    store = tw.store.Store()
    for i in range(4):
        make_node(tw, store, f"worker-{i}")
    client = tw.cache.maybe_cached(store, cached)
    rec = [isinstance(client, tw.cache.CachedClient)]
    mgr, pool = _operator(tw, client)
    free0 = pool.free_chips("tpu-v4")
    try:
        for cycle in range(2):
            name = f"job-{cycle}"
            submit(tw, store, name)
            rec.append(wait_for(lambda: _state(tw, store, name) == "Running"))
            store.delete(t.ComposabilityRequest, name)
            rec.append(wait_for(lambda: _state(tw, store, name) is None))
        rec.append(wait_for(lambda: not store.list(t.ComposableResource)))
        rec.append(pool.free_chips("tpu-v4") == free0)
    finally:
        mgr.stop()
    assert rec == [cached, True, True, True, True, True, True]
    return rec


def resync_after_controller_stop_start(tw, cached):
    store = tw.store.Store()
    for i in range(4):
        make_node(tw, store, f"worker-{i}")
    mgr, pool = _operator(tw, tw.cache.maybe_cached(store, cached))
    try:
        submit(tw, store, "job-0")
        rec = [wait_for(lambda: _state(tw, store, "job-0") == "Running")]
    finally:
        mgr.stop()
    submit(tw, store, "job-1")
    mgr2, _ = _operator(tw, tw.cache.maybe_cached(store, cached), pool=pool)
    try:
        rec.append(wait_for(lambda: _state(tw, store, "job-1") == "Running"))
        rec.append(_state(tw, store, "job-0"))
    finally:
        mgr2.stop()
    assert rec == [True, True, "Running"]
    return rec


def chaos_attach_converges_on_cached_reads(tw):
    t = tw.types
    store = tw.store.Store()
    for i in range(4):
        make_node(tw, store, f"worker-{i}")
    client = tw.cache.CachedClient(store)
    pool = tw.inmem.InMemoryPool()
    chaos = tw.chaos.ChaosFabricProvider(pool, failure_rate=0.15, seed=7)
    mgr, _ = _operator(tw, client, pool=pool, fabric=chaos)
    free0 = pool.free_chips("tpu-v4")
    try:
        submit(tw, store, "chaos-job")
        rec = [wait_for(lambda: _state(tw, store, "chaos-job") == "Running",
                        timeout=30.0), chaos.injected > 0]
        store.delete(t.ComposabilityRequest, "chaos-job")
        rec.append(wait_for(lambda: _state(tw, store, "chaos-job") is None,
                            timeout=30.0))
        rec.append(wait_for(lambda: pool.free_chips("tpu-v4") == free0,
                            timeout=30.0))
    finally:
        mgr.stop()
    assert rec == [True, True, True, True]
    return rec


SCENARIOS = [
    reads_served_from_cache_zero_store_rtts,
    read_your_writes_within_one_thread,
    watch_events_ordered_after_cache_apply,
    direct_store_writes_converge_into_cache,
    delete_visible_to_next_cached_read,
    failed_informer_start_leaves_no_debris,
    tombstone_refresh_survives_pruning,
    uncached_kinds_pass_through,
    stale_cached_rv_conflicts_then_converges,
    conflict_error_requeues_and_reconcile_converges,
    identical_status_write_skipped,
    changed_status_still_writes,
    stale_rv_never_coalesced,
    lagging_cache_never_coalesces_a_conflict,
    admission_hook_read_races_lazy_informer_start,
    reads_never_block_on_inflight_start,
    waiters_observe_published_informer,
    routes_hold_queue_strongly,
    stale_route_alias_still_stops_store_watch,
    dirty_check_helper,
    managed_by_selector_uses_index,
    index_follows_label_rewrites_and_deletes,
    indexer_under_concurrent_create_delete,
    list_correct_across_kinds_and_mutations,
    depth_gauge_and_warning,
    mapper_exception_logged_not_silent,
    chaos_attach_converges_on_cached_reads,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port


def test_persistence_reload_keeps_kind_index(tmp_path):
    jax, port = run_both(persistence_reload_keeps_kind_index, tmp_path)
    assert jax == port


@pytest.mark.parametrize("cached", [True, False], ids=["cache-on", "cache-off"])
@pytest.mark.parametrize("scenario", [lifecycle_converges,
                                      resync_after_controller_stop_start],
                         ids=lambda f: f.__name__)
def test_e2e_matches_jax(scenario, cached):
    jax, port = run_both(scenario, cached)
    assert jax == port


def test_maybe_cached_wraps_the_store_wrappers():
    """``maybe_cached`` caches over the in-proc store, a ChaosStore or a
    BreakingStore around it, and passes anything else through."""
    def scenario(tw):
        store = tw.store.Store()
        chaos = tw.chaosstore.ChaosStore(store)
        brk = tw.storebreaker.BreakingStore(chaos)
        wrapped = [type(tw.cache.maybe_cached(s, True)).__name__
                   for s in (store, chaos, brk)]
        other = object()
        rec = wrapped + [tw.cache.maybe_cached(other, True) is other,
                         tw.cache.maybe_cached(store, False) is store]
        for c in (tw.cache.maybe_cached(s, True) for s in (store, chaos, brk)):
            c.stop_informers()
        return rec

    jax, port = run_both(scenario)
    assert jax == port == ["CachedClient"] * 3 + [True, True]
