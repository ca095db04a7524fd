"""The port's ChaosStore (tpu_composer_torch/runtime/chaosstore.py)
against the JAX package's (tests/test_chaosstore.py's twin).

Each scenario runs once per package and returns the raised error
classes, injection counts, injected delays, the events that a lossy
watch let through (the same seeded draws on both sides, so the same
count), what committed to the inner store and the end state of an
operator driven through the chaos layer; the scenario also asserts the
reference test's invariants. Tolerance: exact.

Left out: ``TestPlumbing::test_cmd_wiring_builds_chaos_store``, which
builds the store from the JAX package's command line (``cmd.main``);
the port's entry point comes with a later slice. The slow soak
(``test_soak_heavy_store_chaos``) is not a tier-1 test and has no twin.
"""

from __future__ import annotations

import queue as _queue
import time

import pytest
import torch

from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)


def _node(tw, name="worker-0", slots=4):
    n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=name))
    n.status.tpu_slots = slots
    return n


def raised(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 - the class is compared
        return type(e).__name__
    return None


def failure_rate_one_fails_everything(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store, failure_rate=1.0, seed=1)
    rec = [raised(chaos.create, _node(tw)), raised(chaos.list, tw.types.Node),
           chaos.injected, len(store)]
    assert rec == ["StoreError", "StoreError", 2, 0]
    return rec


def conflict_rate_spares_reads_and_creates(tw):
    store = tw.store.Store()
    Node = tw.types.Node
    chaos = tw.chaosstore.ChaosStore(store, conflict_rate=1.0, seed=1)
    chaos.create(_node(tw))
    got = chaos.get(Node, "worker-0")
    rec = [raised(chaos.update, got), raised(chaos.update_status, got),
           raised(chaos.delete, Node, "worker-0"),
           store.get(Node, "worker-0").metadata.resource_version]
    assert rec[:3] == ["ConflictError"] * 3
    return rec


def fail_verb_scripted_count(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store)
    chaos.fail_verb("create", times=2)
    rec = [raised(chaos.create, _node(tw)) for _ in range(3)]
    rec.append(store.try_get(tw.types.Node, "worker-0") is not None)
    assert rec == ["StoreError", "StoreError", None, True]
    return rec


def blackout_and_heal(tw):
    chaos = tw.chaosstore.ChaosStore(tw.store.Store())
    chaos.blackout()
    rec = [raised(chaos.list, tw.types.Node)]
    chaos.heal()
    rec.append(chaos.list(tw.types.Node))
    assert rec == ["StoreError", []]
    return rec


def timed_blackout_on_an_injected_clock(tw):
    """``blackout_for`` on the chaos layer's clock: dark until the window
    ends, then light again with no heal."""
    now = [100.0]
    chaos = tw.chaosstore.ChaosStore(tw.store.Store(), clock=lambda: now[0])
    chaos.blackout_for(1.0)
    rec = [raised(chaos.list, tw.types.Node)]
    now[0] += 0.5
    rec.append(raised(chaos.list, tw.types.Node))
    now[0] += 0.6
    rec.append(raised(chaos.list, tw.types.Node))
    assert rec == ["StoreError", "StoreError", None]
    return rec


def latency_injected_per_call(tw):
    delays = []
    chaos = tw.chaosstore.ChaosStore(tw.store.Store(), latency=(0.01, 0.02),
                                     seed=3, sleep=delays.append)
    chaos.create(_node(tw))
    chaos.get(tw.types.Node, "worker-0")
    assert len(delays) == 2 and all(0.01 <= d <= 0.02 for d in delays)
    return delays


def injections_counted_by_mode(tw):
    m = tw.metrics.store_chaos_injected_total
    t0 = m.value(verb="update", mode="conflict")
    chaos = tw.chaosstore.ChaosStore(tw.store.Store(), conflict_rate=1.0, seed=1)
    chaos.create(_node(tw))
    err = raised(chaos.update, chaos.get(tw.types.Node, "worker-0"))
    rec = [err, m.value(verb="update", mode="conflict") - t0]
    assert rec == ["ConflictError", 1]
    return rec


def events_dropped_but_control_items_pass(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store, watch_drop_rate=1.0, seed=1)
    q = chaos.watch("Node")
    store.create(_node(tw))
    q._q.put(None)
    got = q.get(timeout=1)
    assert got is None
    return got


def zero_rate_returns_raw_queue(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store)
    q = chaos.watch("Node")
    store.create(_node(tw))
    ev = q.get(timeout=1)
    chaos.stop_watch(q)
    rec = [isinstance(ev, tw.store.WatchEvent), ev.type, ev.obj.metadata.name]
    assert rec[:2] == [True, "ADDED"]
    return rec


def partial_drop_rate_with_seed(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store, watch_drop_rate=0.5, seed=7)
    q = chaos.watch("Node")
    for i in range(40):
        store.create(_node(tw, f"w-{i}"))
    got = []
    while True:
        try:
            item = q.get(block=False)
        except _queue.Empty:
            break
        if isinstance(item, tw.store.WatchEvent):
            got.append(item.obj.metadata.name)
    assert 0 < len(got) < 40
    return got


def stop_watch_unsubscribes_inner_queue(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store, watch_drop_rate=0.5, seed=1)
    q = chaos.watch("Node")
    chaos.stop_watch(q)
    store.create(_node(tw))
    assert q._q.qsize() == 0
    return q._q.qsize()


def passthrough_surface(tw):
    store = tw.store.Store()
    chaos = tw.chaosstore.ChaosStore(store)
    chaos.create(_node(tw))
    rec = [chaos.try_get(tw.types.Node, "worker-0") is not None,
           chaos.try_get(tw.types.Node, "nope"), len(chaos),
           chaos.scheme is store.scheme, list(chaos.keys()) == list(store.keys())]
    assert rec == [True, None, 1, True, True]
    return rec


def maybe_cached_wraps_chaos_over_inproc_store(tw):
    chaos = tw.chaosstore.ChaosStore(tw.store.Store(), failure_rate=0.0)
    client = tw.cache.maybe_cached(chaos, True)
    rec = [isinstance(client, tw.cache.CachedClient),
           tw.cache.maybe_cached(chaos, False) is chaos]
    client.stop_informers()
    assert rec == [True, True]
    return rec


def converges_through_transients_and_conflicts(tw):
    """The operator converges through injected store faults: conflicts
    requeue, transients retry under backoff."""
    t = tw.types
    store = tw.store.Store()
    store.create(_node(tw, "worker-0"))
    store.create(_node(tw, "worker-1"))
    chaos = tw.chaosstore.ChaosStore(store, failure_rate=0.03,
                                     conflict_rate=0.08, seed=1234)
    pool = tw.inmem.InMemoryPool()
    mgr = tw.manager.Manager(store=chaos)
    mgr.add_controller(tw.req.ComposabilityRequestReconciler(
        chaos, pool, timing=tw.req.RequestTiming(updating_poll=0.05,
                                                 cleaning_poll=0.05)))
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        chaos, pool, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                    detach_poll=0.05, detach_fast=0.05,
                                    busy_poll=0.05)))
    mgr.start(workers_per_controller=2)

    def retry(fn):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                fn()
                return True
            except tw.store.StoreError:
                time.sleep(0.05)
        return False

    try:
        rec = [retry(lambda: chaos.create(t.ComposabilityRequest(
            metadata=tw.meta.ObjectMeta(name="job"),
            spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
                type="tpu", model="tpu-v4", size=4)))))]
        rec.append(wait_for(lambda: store.get(
            t.ComposabilityRequest, "job").status.state == "Running",
            timeout=30.0))
        rec.append(retry(lambda: chaos.delete(t.ComposabilityRequest, "job")))
        rec.append(wait_for(
            lambda: store.try_get(t.ComposabilityRequest, "job") is None
            and not store.list(t.ComposableResource), timeout=30.0))
        rec.append(wait_for(lambda: pool.free_chips("tpu-v4") == 64,
                            timeout=30.0))
        rec.append(pool.get_resources())
    finally:
        mgr.stop()
    assert rec == [True, True, True, True, True, []]
    return rec


SCENARIOS = [
    failure_rate_one_fails_everything,
    conflict_rate_spares_reads_and_creates,
    fail_verb_scripted_count,
    blackout_and_heal,
    timed_blackout_on_an_injected_clock,
    latency_injected_per_call,
    injections_counted_by_mode,
    events_dropped_but_control_items_pass,
    zero_rate_returns_raw_queue,
    partial_drop_rate_with_seed,
    stop_watch_unsubscribes_inner_queue,
    passthrough_surface,
    maybe_cached_wraps_chaos_over_inproc_store,
    converges_through_transients_and_conflicts,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
