"""The port's FabricDispatcher (tpu_composer_torch/fabric/dispatcher.py)
and the resource reconciler's dispatcher path against the JAX package's
(tests/test_dispatcher.py's twin).

Each scenario runs once per package and records the provider's call log
(verbs, group calls and their members, arrival order), op states, the
parked outcomes' results and error classes, the reconciler's streaks,
attempts, quarantine and CR states, and the pool's free chips; the two
packages' records must be equal. Tolerance: exact.

Timing: outcomes, verbs and group-call counts are compared, never
elapsed times. Where the reference relies on a 30 ms coalescing window
(one of its tests fails under a loaded 6-worker run), the twin opens a
wider window (0.3 s) so that every submission lands in its wave.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)

WINDOW = 0.3


def cr(tw, name, node="n0", model="gpu-a100"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="gpu", model=model,
                                      target_node=node))


def drain(disp, verb, name, timeout=10.0):
    """Wait until (verb, name) has a parked outcome or disappeared."""
    assert wait_for(lambda: disp.op_state(verb, name) in (None, "done"),
                    timeout=timeout, interval=0.002), (verb, name)
    return disp.op_state(verb, name)


def sentinel(tw, fn, *args, **kw):
    """The dispatch sentinel's class name (the submission's answer)."""
    try:
        fn(*args, **kw)
        return "returned"
    except tw.provider.FabricError as e:
        return type(e).__name__


def outcome(tw, fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__, str(e))
    return ("attach", list(out.device_ids)) if out is not None else None


def recording_pool(tw, group_verbs=True, **kw):
    class RecordingPool(tw.inmem.InMemoryPool):
        """Counts and orders provider calls; optional group-verb kill
        switch and whole-batch failures."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.log = []
            self._group = group_verbs
            self.group_failures = 0

        def add_resource(self, r):
            self.log.append(("add", [r.metadata.name]))
            return super().add_resource(r)

        def remove_resource(self, r):
            self.log.append(("remove", [r.metadata.name]))
            return super().remove_resource(r)

        def add_resources(self, rs):
            if not self._group:
                raise tw.provider.UnsupportedBatch("disabled")
            self.log.append(("add_batch", [r.metadata.name for r in rs]))
            if self.group_failures > 0:
                self.group_failures -= 1
                raise tw.provider.TransientFabricError("injected")
            return super().add_resources(rs)

        def remove_resources(self, rs):
            if not self._group:
                raise tw.provider.UnsupportedBatch("disabled")
            self.log.append(("remove_batch", [r.metadata.name for r in rs]))
            if self.group_failures > 0:
                self.group_failures -= 1
                raise tw.provider.TransientFabricError("injected")
            return super().remove_resources(rs)

        def mutation_order(self):
            out = []
            for verb, names in self.log:
                v = "add" if verb.startswith("add") else "remove"
                out.extend((v, n) for n in names)
            return out

    return RecordingPool(**kw)


def new_dispatcher(tw, pool, **kw):
    kw.setdefault("batch_window", WINDOW)
    kw.setdefault("poll_interval", 0.01)
    d = tw.dispatcher.FabricDispatcher(pool, **kw)
    d.start()
    return d


def _pool(tw, **kw):
    return recording_pool(tw, chips={"gpu-a100": 16, "tpu-v4": 16}, **kw)


# -- batching ----------------------------------------------------------------------

def same_node_wave_coalesces_into_one_group_call(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool)
    try:
        t = [sentinel(tw, d.add_resource, cr(tw, f"r{i}")) for i in range(6)]
        for i in range(6):
            drain(d, "add", f"r{i}")
        t.append(list(pool.log))
        return t + [outcome(tw, d.add_resource, cr(tw, f"r{i}"))
                    for i in range(6)]
    finally:
        d.stop()


def different_nodes_dispatch_independently(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool)
    try:
        t = [sentinel(tw, d.add_resource, cr(tw, f"r{i}", node=f"n{i}"))
             for i in range(4)]
        for i in range(4):
            drain(d, "add", f"r{i}")
        return t + [sorted(pool.log)]
    finally:
        d.stop()


def window_expiry_splits_separate_waves(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool, batch_window=0.02)
    try:
        t = [sentinel(tw, d.add_resource, cr(tw, "early"))]
        drain(d, "add", "early")
        t.append(sentinel(tw, d.add_resource, cr(tw, "late")))
        drain(d, "add", "late")
        return t + [list(pool.log)]
    finally:
        d.stop()


def provider_without_group_verbs_falls_back_per_item(tw):
    pool = recording_pool(tw, group_verbs=False, chips={"gpu-a100": 16})
    d = new_dispatcher(tw, pool)
    try:
        for i in range(4):
            sentinel(tw, d.add_resource, cr(tw, f"r{i}"))
        for i in range(4):
            drain(d, "add", f"r{i}")
        return [[v for v, _ in pool.log], d._group_verbs_ok]
    finally:
        d.stop()


def max_batch_caps_group_size(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool, max_batch=4)
    try:
        for i in range(10):
            sentinel(tw, d.add_resource, cr(tw, f"r{i}"))
        for i in range(10):
            drain(d, "add", f"r{i}")
        return [[len(n) for v, n in pool.log], pool.free_chips("gpu-a100")]
    finally:
        d.stop()


# -- FIFO ordering ---------------------------------------------------------------------

def attach_never_reorders_past_detach_same_node(tw):
    pool = _pool(tw)
    pool.add_resource(cr(tw, "r1"))
    pool.log.clear()
    d = new_dispatcher(tw, pool)
    try:
        t = [sentinel(tw, d.add_resource, cr(tw, "r0")),
             sentinel(tw, d.remove_resource, cr(tw, "r1")),
             sentinel(tw, d.add_resource, cr(tw, "r2"))]
        for verb, name in (("add", "r0"), ("remove", "r1"), ("add", "r2")):
            drain(d, verb, name)
        return t + [pool.mutation_order()]
    finally:
        d.stop()


def detach_waits_for_pending_attach_of_same_resource(tw):
    pool = recording_pool(tw, chips={"gpu-a100": 4}, async_steps=30)
    d = new_dispatcher(tw, pool, batch_window=0.0)
    try:
        t = [sentinel(tw, d.add_resource, cr(tw, "r0"))]
        assert wait_for(lambda: d.op_state("add", "r0") == "pending",
                        interval=0.002)
        t.append(sentinel(tw, d.remove_resource, cr(tw, "r0")))
        time.sleep(0.03)
        t.append(("remove", "r0") in pool.mutation_order())
        drain(d, "add", "r0")
        drain(d, "remove", "r0")
        order = pool.mutation_order()
        return t + [order.index(("remove", "r0")) > order.index(("add", "r0")),
                    pool.free_chips("gpu-a100")]
    finally:
        d.stop()


# -- failure splitting ---------------------------------------------------------------

def failed_batch_retries_member_by_member(tw):
    pool = _pool(tw)
    pool.inject_add_failure("bad", times=10)
    pool.group_failures = 1
    d = new_dispatcher(tw, pool)
    try:
        for name in ("good1", "bad", "good2"):
            sentinel(tw, d.add_resource, cr(tw, name))
        for name in ("good1", "bad", "good2"):
            drain(d, "add", name)
        verbs = [v for v, _ in pool.log]
        return [verbs.count("add_batch"), sorted(pool.log)[1:]] + [
            outcome(tw, d.add_resource, cr(tw, n))
            for n in ("good1", "bad", "good2")]
    finally:
        d.stop()


def partial_member_failure_needs_no_split(tw):
    pool = _pool(tw)
    pool.inject_add_failure("bad", times=1)
    d = new_dispatcher(tw, pool)
    try:
        for name in ("ok1", "bad", "ok2"):
            sentinel(tw, d.add_resource, cr(tw, name))
        for name in ("ok1", "bad", "ok2"):
            drain(d, "add", name)
        return [list(pool.log)] + [outcome(tw, d.add_resource, cr(tw, n))
                                   for n in ("ok1", "bad", "ok2")]
    finally:
        d.stop()


# -- the reconciler's dispatcher path ---------------------------------------------------

def make_world(tw, fabric_batch, budget=3, **disp_kw):
    t = tw.types
    store = tw.store.Store()
    for i in range(3):
        n = t.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        n.status.tpu_slots = 8
        store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 16, "tpu-v4": 16})
    chaos = tw.chaos.ChaosFabricProvider(pool)
    disp = None
    if fabric_batch:
        disp_kw.setdefault("batch_window", 0.005)
        disp_kw.setdefault("poll_interval", 0.01)
        disp = tw.dispatcher.FabricDispatcher(chaos, **disp_kw)
        disp.start()
    rec = tw.rc.ComposableResourceReconciler(
        store, chaos, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(attach_budget=budget), dispatcher=disp)
    store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="r0"),
        spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                      target_node="worker-0")))
    return store, pool, chaos, rec, disp


def settle(tw, rec, disp, name, steps=40):
    """Reconcile until the CR stops moving, driving the dispatcher's ops
    to completion between passes."""
    for _ in range(steps):
        try:
            rec.reconcile(name)
        except tw.provider.FabricError:
            pass
        if disp is not None:
            wait_for(lambda: {disp.op_state(v, name) for v in ("add", "remove")}
                     <= {None, "done"}, timeout=2.0, interval=0.002)


def _state(tw, store, name="r0"):
    r = store.try_get(tw.types.ComposableResource, name)
    if r is None:
        return None
    return dict(state=r.status.state, attempts=r.status.attach_attempts,
                quarantined=r.status.quarantined, error=r.status.error,
                device_ids=list(r.status.device_ids))


def budget_accounting(tw, fabric_batch):
    store, pool, chaos, rec, disp = make_world(tw, fabric_batch, budget=5)
    rec.reconcile("r0")
    chaos.fail_node("worker-0", times=2)
    try:
        for _ in range(20):
            if rec._attach_streaks.get("r0", 0) >= 2:
                break
            settle(tw, rec, disp, "r0", steps=1)
        mid = [rec._attach_streaks.get("r0", 0), _state(tw, store)]
        settle(tw, rec, disp, "r0", steps=8)
        return mid + [_state(tw, store), rec._attach_streaks.get("r0", 0)]
    finally:
        if disp is not None:
            disp.stop()


def budget_accounting_identical_to_unbatched(tw):
    return [budget_accounting(tw, False), budget_accounting(tw, True)]


def quarantine_fires_at_same_threshold(tw):
    out = []
    for mode in (False, True):
        store, pool, chaos, rec, disp = make_world(tw, mode, budget=3)
        rec.reconcile("r0")
        chaos.fail_node("worker-0")
        try:
            settle(tw, rec, disp, "r0", steps=12)
            out.append(_state(tw, store))
        finally:
            chaos.heal_node("worker-0")
            if disp is not None:
                disp.stop()
    return out


def dispatch_sentinel_does_not_reset_streak(tw):
    store, pool, chaos, rec, disp = make_world(tw, True, budget=10,
                                               batch_window=30.0)
    rec.reconcile("r0")
    rec._attach_streaks["r0"] = 3
    try:
        rec.reconcile("r0")
        return [disp.op_state("add", "r0"), rec._attach_streaks.get("r0"),
                tw.metrics.fabric_requests_total.value(op="add",
                                                       outcome="dispatched") > 0]
    finally:
        disp.stop()


def real_wait_sentinel_still_resets_streak(tw):
    t = tw.types
    store = tw.store.Store()
    n = t.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
    n.status.tpu_slots = 8
    store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 4}, async_steps=50)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=0.01)
    disp.start()
    rec = tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(attach_budget=5), dispatcher=disp)
    store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="r0"),
        spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                      target_node="worker-0")))
    rec.reconcile("r0")
    rec._attach_streaks["r0"] = 3
    try:
        rec.reconcile("r0")
        out = [rec._attach_streaks.get("r0")]
        assert wait_for(lambda: disp.op_state("add", "r0") == "pending",
                        interval=0.002)
        rec.reconcile("r0")
        return out + ["r0" in rec._attach_streaks]
    finally:
        disp.stop()


# -- migration-ordered pairs --------------------------------------------------------

def remove_waits_for_named_add_cross_lane(tw):
    pool = _pool(tw)
    gate = threading.Event()
    real_add = pool.add_resource

    def slow_add(r):
        gate.wait(5)
        return real_add(r)

    pool._group = False
    d = new_dispatcher(tw, pool, batch_window=0.0)
    try:
        src = cr(tw, "src", node="node-a")
        sentinel(tw, d.add_resource, src)
        drain(d, "add", "src")
        d.add_resource(src)
        pool.add_resource = slow_add
        t = [sentinel(tw, d.add_resource, cr(tw, "repl", node="node-b")),
             sentinel(tw, d.remove_resource, src, after=("add", "repl"))]
        time.sleep(0.1)
        t += [("remove", "src") in pool.mutation_order(),
              d.op_state("remove", "src")]
        gate.set()
        drain(d, "add", "repl")
        drain(d, "remove", "src")
        order = pool.mutation_order()
        return t + [order.index(("add", "repl")) < order.index(("remove", "src"))]
    finally:
        gate.set()
        d.stop()


def settled_or_unknown_target_imposes_no_wait(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool, batch_window=0.0)
    try:
        src = cr(tw, "src2", node="node-a")
        sentinel(tw, d.add_resource, src)
        drain(d, "add", "src2")
        d.add_resource(src)
        t = [sentinel(tw, d.remove_resource, src, after=("add", "ghost-repl")),
             drain(d, "remove", "src2")]
        return t + [("remove", "src2") in pool.mutation_order()]
    finally:
        d.stop()


# -- completion latch, cancel, deletion ------------------------------------------------

def latch_requeues_key_on_completion(tw):
    store, pool, chaos, rec, disp = make_world(tw, True)
    try:
        rec.reconcile("r0")
        rec.reconcile("r0")
        drain(disp, "add", "r0")
        assert wait_for(lambda: len(rec.queue) > 0, timeout=2.0,
                        interval=0.002)
        key = rec.queue.get(timeout=1)
        rec.reconcile("r0")
        return [key, _state(tw, store)]
    finally:
        disp.stop()


def deletion_with_uncancellable_add_routes_through_detaching(tw):
    t = tw.types
    store = tw.store.Store()
    n = t.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
    n.status.tpu_slots = 8
    store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 4}, async_steps=10)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=0.01)
    disp.start()
    rec = tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(), dispatcher=disp)
    store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="r0"),
        spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                      target_node="worker-0")))
    try:
        rec.reconcile("r0")
        rec.reconcile("r0")
        assert wait_for(lambda: disp.op_state("add", "r0") == "pending",
                        interval=0.002)
        store.delete(t.ComposableResource, "r0")
        rec.reconcile("r0")
        out = [_state(tw, store)["state"]]
        settle(tw, rec, disp, "r0", steps=30)
        return out + [_state(tw, store), pool.free_chips("gpu-a100")]
    finally:
        disp.stop()


def queued_add_cancelled_on_deletion(tw):
    store, pool, chaos, rec, disp = make_world(tw, True, batch_window=5.0)
    try:
        rec.reconcile("r0")
        rec.reconcile("r0")
        out = [disp.op_state("add", "r0")]
        store.delete(tw.types.ComposableResource, "r0")
        rec.reconcile("r0")
        return out + [_state(tw, store)["state"], disp.op_state("add", "r0"),
                      pool.attachment_record("r0"),
                      pool.free_chips("gpu-a100")]
    finally:
        disp.stop()


def parked_attach_result_is_not_cancellable(tw):
    store, pool, chaos, rec, disp = make_world(tw, True, batch_window=0.0)
    try:
        rec.reconcile("r0")
        rec.reconcile("r0")
        drain(disp, "add", "r0")
        out = [disp.op_state("add", "r0"),
               pool.attachment_record("r0") is not None]
        store.delete(tw.types.ComposableResource, "r0")
        rec.reconcile("r0")
        out.append(_state(tw, store)["state"])
        settle(tw, rec, disp, "r0", steps=20)
        return out + [_state(tw, store), pool.attachment_record("r0"),
                      pool.free_chips("gpu-a100")]
    finally:
        disp.stop()


def purge_cancels_parked_outcomes(tw):
    """A CR purged while its attach outcome sits parked: the reconcile of
    the vanished key drops both verbs' dispatcher state."""
    store, pool, chaos, rec, disp = make_world(tw, True, batch_window=0.0)
    try:
        rec.reconcile("r0")
        rec.reconcile("r0")
        drain(disp, "add", "r0")
        res = store.get(tw.types.ComposableResource, "r0")
        res.metadata.finalizers = []
        store.update(res)
        store.delete(tw.types.ComposableResource, "r0")
        out = [store.try_get(tw.types.ComposableResource, "r0")]
        rec.reconcile("r0")
        return out + [disp.op_state("add", "r0"), disp.op_state("remove", "r0")]
    finally:
        disp.stop()


def shared_snapshot_single_flight(tw):
    pool = _pool(tw)
    d = new_dispatcher(tw, pool, snapshot_ttl=0.5)
    calls = {"n": 0}
    orig = pool.get_resources

    def counting():
        calls["n"] += 1
        return orig()

    pool.get_resources = counting
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            d.get_resources())) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return [len(results), calls["n"]]
    finally:
        d.stop()


# -- stop, kill, drain -----------------------------------------------------------------

def stop_flushes_latches(tw):
    pool = _pool(tw)
    disp = new_dispatcher(tw, pool, batch_window=0.0)
    woke = threading.Event()
    out = [sentinel(tw, disp.add_resource, cr(tw, "r0"), on_ready=woke.set),
           drain(disp, "add", "r0")]
    woke.clear()
    disp.stop()
    out.append(woke.is_set())
    pool2 = recording_pool(tw, chips={"gpu-a100": 4})
    disp2 = tw.dispatcher.FabricDispatcher(pool2, batch_window=30.0)
    disp2.start()
    woke2 = threading.Event()
    out.append(sentinel(tw, disp2.add_resource, cr(tw, "q0"),
                        on_ready=woke2.set))
    out.append(disp2.op_state("add", "q0"))
    disp2.stop()
    out += [woke2.is_set(), pool2.log,
            sentinel(tw, disp2.add_resource, cr(tw, "q1"))]
    return out


def kill_abandons_latches(tw):
    pool = _pool(tw)
    disp = new_dispatcher(tw, pool, batch_window=0.0)
    woke = threading.Event()
    sentinel(tw, disp.add_resource, cr(tw, "r0"), on_ready=woke.set)
    out = [drain(disp, "add", "r0")]
    woke.clear()
    disp.kill()
    return out + [woke.is_set(), disp.op_state("add", "r0")]


def drain_times_out_on_an_unconsumed_outcome(tw):
    """``drain`` waits for parked outcomes to be consumed: with nobody
    consuming, it times out and reports it."""
    pool = _pool(tw)
    disp = new_dispatcher(tw, pool, batch_window=0.0)
    sentinel(tw, disp.add_resource, cr(tw, "p0"))
    out = [drain(disp, "add", "p0"), disp.drain(0.2),
           sentinel(tw, disp.add_resource, cr(tw, "p1"))]
    disp.stop()
    return out


def manager_stop_drains_the_dispatcher(tw):
    """The Manager's stop drains the dispatcher while its controllers
    still run: every in-flight attach completes and its outcome is
    consumed and persisted before the workers stop."""
    t = tw.types
    store = tw.store.Store()
    n = t.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
    n.status.tpu_slots = 8
    store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 8}, async_steps=5)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.01,
                                          poll_interval=0.01)
    mgr = tw.manager.Manager(store=store, dispatcher=disp, drain_timeout=10.0)
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool), dispatcher=disp,
        timing=tw.rc.ResourceTiming(attach_poll=5.0, visibility_poll=5.0)))
    drains = tw.metrics.dispatcher_drains_total
    clean0 = drains.value(outcome="clean")
    mgr.start(workers_per_controller=2)
    names = [f"m{i}" for i in range(3)]
    try:
        for name in names:
            store.create(t.ComposableResource(
                metadata=tw.meta.ObjectMeta(name=name),
                spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                              target_node="worker-0")))
        assert wait_for(lambda: all(disp.op_state("add", nm) is not None
                                    for nm in names), interval=0.002)
    finally:
        mgr.stop()
    kids = [store.get(t.ComposableResource, nm) for nm in names]
    return [drains.value(outcome="clean") - clean0,
            [len(k.status.device_ids) for k in kids],
            [disp.op_state("add", nm) for nm in names],
            pool.free_chips("gpu-a100")]


SCENARIOS = [
    same_node_wave_coalesces_into_one_group_call,
    different_nodes_dispatch_independently,
    window_expiry_splits_separate_waves,
    provider_without_group_verbs_falls_back_per_item,
    max_batch_caps_group_size,
    attach_never_reorders_past_detach_same_node,
    detach_waits_for_pending_attach_of_same_resource,
    failed_batch_retries_member_by_member,
    partial_member_failure_needs_no_split,
    budget_accounting_identical_to_unbatched,
    quarantine_fires_at_same_threshold,
    dispatch_sentinel_does_not_reset_streak,
    real_wait_sentinel_still_resets_streak,
    remove_waits_for_named_add_cross_lane,
    settled_or_unknown_target_imposes_no_wait,
    latch_requeues_key_on_completion,
    deletion_with_uncancellable_add_routes_through_detaching,
    queued_add_cancelled_on_deletion,
    parked_attach_result_is_not_cancellable,
    purge_cancels_parked_outcomes,
    shared_snapshot_single_flight,
    stop_flushes_latches,
    kill_abandons_latches,
    drain_times_out_on_an_unconsumed_outcome,
    manager_stop_drains_the_dispatcher,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port


def test_records_hold_the_reference_contract():
    jax, _ = run_both(same_node_wave_coalesces_into_one_group_call)
    assert jax[6] == [["add_batch", [f"r{i}" for i in range(6)]]]
    jax, _ = run_both(budget_accounting_identical_to_unbatched)
    assert jax[0] == jax[1] and jax[0][2]["state"] == "Online"
    jax, _ = run_both(queued_add_cancelled_on_deletion)
    assert jax == ["queued", "Deleting", None, None, 16]
    jax, _ = run_both(manager_stop_drains_the_dispatcher)
    assert jax == [1, [1, 1, 1], [None, None, None], 5]
