"""The port's crash consistency and graceful drain against the JAX
package's (tests/test_crash_restart.py's twin, its tier-1 classes):
``TestGracefulDrain``, ``TestMigrationCrashRestart`` and
``TestTraceContinuity``.

Each scenario runs once per package and returns the order of the drain
and the lease release, the dispatcher's leftover ops, the children's
intents and devices, convergence after a crash and a restart, the
pool's conservation and the trace spans joined under a durable nonce;
the scenario also asserts the reference test's invariants (no double
attach, make-before-break across a crash). Counts that depend on thread
interleaving (the operator writes a migration took) are compared by the
reference's bound, not by value. Tolerance: exact.

Clocks: the drain scenarios' ``LeaseElector`` runs on a stepped
``ElectorClock`` (tests/torch_crash.py) that the scenario never steps, so
no renewal can age out under a loaded run: the lease is lost only where
a scenario deposes it on purpose.

Each ``Incarnation`` runs the reference's fleet plane as a runnable,
publishing through the same crash fuse as everything else (so a crash
exercises the publisher's store-failure path); the migration scenario
checks that each incarnation's snapshot landed and that the crashed
one's stopped advancing.

Left out: the slow soaks (``TestKillRestartSoak``,
``TestMigrationCrashSoak``).
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from tests.torch_crash import (
    CrashFuse,
    assert_no_double_attach,
    elector_clock,
    recording_pool,
)
from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)


def _world(tw, nodes=4):
    store = tw.store.Store()
    for i in range(nodes):
        n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        n.status.tpu_slots = 4
        store.create(n)
    return store


def _request(tw, store, name, size):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=size))))


def _cr(tw, name):
    res = tw.types.ComposableResource(metadata=tw.meta.ObjectMeta(name=name))
    res.spec.type, res.spec.model = "tpu", "tpu-v4"
    res.spec.target_node, res.spec.chip_count = "worker-0", 1
    return res


def raised(fn, *a):
    try:
        fn(*a)
    except Exception as e:  # noqa: BLE001 - class and message are compared
        return (type(e).__name__, str(e))
    return None


# -- graceful drain ------------------------------------------------------------

def shutdown_drains_inflight_then_releases_lease(tw):
    t = tw.types
    store = _world(tw, 2)
    pool = recording_pool(tw, async_steps=3)
    with elector_clock(tw):
        dispatcher = tw.dispatcher.FabricDispatcher(pool, batch_window=0.01,
                                                    poll_interval=0.02)
        elector = tw.leases.LeaseElector(store, identity="drainer",
                                         lease_duration_s=5.0,
                                         renew_period_s=0.5)
        order = []
        real_drain, real_release = dispatcher.drain, elector.release
        dispatcher.drain = lambda s: (order.append("drain"), real_drain(s))[1]
        elector.release = lambda: (order.append("release"), real_release())[1]
        mgr = tw.manager.Manager(store=store, leader_elector=elector,
                                 dispatcher=dispatcher, drain_timeout=8.0)
        mgr.add_controller(tw.req.ComposabilityRequestReconciler(
            store, pool, timing=tw.req.RequestTiming(updating_poll=0.05,
                                                     cleaning_poll=0.05)))
        mgr.add_controller(tw.rc.ComposableResourceReconciler(
            store, pool, tw.fake.FakeNodeAgent(pool=pool),
            timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                        detach_poll=0.05, detach_fast=0.05),
            dispatcher=dispatcher))
        mgr.add_runnable(dispatcher.run)
        mgr.start(workers_per_controller=2)
        stopped = False
        try:
            _request(tw, store, "job", 8)
            caught = wait_for(lambda: any(
                dispatcher.op_state("add", r.metadata.name) is not None
                for r in store.list(t.ComposableResource)), timeout=10)
            mgr.stop()
            stopped = True
        finally:
            if not stopped:
                mgr.stop()
    kids = store.list(t.ComposableResource)
    rec = [caught, order, dispatcher._ops, dispatcher._done,
           [(k.status.pending_op, bool(k.status.device_ids)) for k in kids]]
    assert caught and order == ["drain", "release"]
    assert rec[2] == {} and rec[3] == {}
    assert all(k == (None, True) for k in rec[4])
    return rec


def deposed_leader_skips_drain_before_watchdog_notices(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        dispatcher = tw.dispatcher.FabricDispatcher(tw.inmem.InMemoryPool(),
                                                    batch_window=0.01)
        elector = tw.leases.LeaseElector(store, identity="deposed",
                                         lease_duration_s=5.0,
                                         renew_period_s=1.0)
        drained = []
        dispatcher.drain = lambda s: (drained.append(s), True)[1]
        mgr = tw.manager.Manager(store=store, leader_elector=elector,
                                 dispatcher=dispatcher, drain_timeout=8.0)
        mgr.add_runnable(dispatcher.run)
        mgr.start()
        try:
            rec = [elector.is_leader]
            elector._leading = False
            rec.append(mgr.lost_leadership)
            mgr.stop()
            rec.append(list(drained))
        finally:
            mgr.stop()
            dispatcher.kill()
    assert rec == [True, False, []]
    return rec


def drain_timeout_reports_and_leaves_durable_intent(tw):
    gate = threading.Event()

    class StuckPool(tw.inmem.InMemoryPool):
        def add_resource(self, resource):
            gate.wait(10)
            return super().add_resource(resource)

    dispatcher = tw.dispatcher.FabricDispatcher(StuckPool(), batch_window=0.0)
    rec = [raised(dispatcher.add_resource, _cr(tw, "r0"))[0]]
    t0 = time.monotonic()
    rec.append(dispatcher.drain(0.3))
    bounded = time.monotonic() - t0 < 5.0
    gate.set()
    dispatcher.kill()
    assert rec == ["DispatchedAttaching", False] and bounded
    return rec


def draining_dispatcher_rejects_new_submissions(tw):
    pool = tw.inmem.InMemoryPool()
    dispatcher = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0)
    dispatcher.start()
    rec = [dispatcher.drain(0.2), raised(dispatcher.add_resource,
                                         _cr(tw, "late")),
           pool.get_resources()]
    dispatcher.stop()
    assert rec[0] and rec[1][0] == "DispatchedAttaching"
    assert "draining" in rec[1][1] and rec[2] == []
    return rec


# -- crash and restart ---------------------------------------------------------

class Incarnation:
    """One operator process lifetime against a shared store and fabric,
    with the reference's fleet plane publishing through its crash fuse."""

    def __init__(self, tw, raw_store, pool, fuse=None):
        self.fuse = CrashFuse(tw, raw_store, fuse)
        self.dispatcher = tw.dispatcher.FabricDispatcher(
            pool, batch_window=0.01, concurrency=4, poll_interval=0.02)
        self.fleet = tw.fleet.FleetPlane(self.fuse, identity="crash-operator",
                                         publish_period=0.25)
        self.mgr = tw.manager.Manager(store=self.fuse,
                                      dispatcher=self.dispatcher,
                                      drain_timeout=0.0, fleet=self.fleet)
        self.mgr.add_startup_hook(lambda: tw.adoption.adopt_pending_ops(
            self.fuse, pool, self.dispatcher))
        self.mgr.add_controller(tw.req.ComposabilityRequestReconciler(
            self.fuse, pool, timing=tw.req.RequestTiming(
                updating_poll=0.05, cleaning_poll=0.05, repair_poll=0.05)))
        self.mgr.add_controller(tw.rc.ComposableResourceReconciler(
            self.fuse, pool, tw.fake.FakeNodeAgent(pool=pool),
            timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                        detach_poll=0.05, detach_fast=0.05,
                                        busy_poll=0.05),
            dispatcher=self.dispatcher))
        self.mgr.add_controller(tw.mc.NodeMaintenanceReconciler(
            self.fuse, timing=tw.mc.MaintenanceTiming(drain_poll=0.05)))
        self.mgr.add_runnable(tw.syncer.UpstreamSyncer(self.fuse, pool,
                                                       period=0.1, grace=5.0))
        self.mgr.add_runnable(self.fleet.run)
        self.mgr.add_runnable(self.dispatcher.run)
        self.mgr.start(workers_per_controller=2)

    def kill(self):
        self.fuse.die()
        self.dispatcher.kill()
        self.mgr.stop()


WAVE = (("wave-a", 8), ("wave-b", 4))


def _submit_wave(tw, store):
    for name, size in WAVE:
        _request(tw, store, name, size)


def _all_running(tw, store):
    try:
        for name, size in WAVE:
            r = store.get(tw.types.ComposabilityRequest, name)
            if r.status.state != "Running" or sum(
                    len(x.device_ids) for x in r.status.resources.values()) != size:
                return False
        return True
    except Exception:
        return False


def _migration_setup(tw):
    t = tw.types
    store = _world(tw)
    pool = recording_pool(tw, async_steps=1)
    inc = Incarnation(tw, store, pool)
    _submit_wave(tw, store)
    assert wait_for(lambda: _all_running(tw, store)), "setup attach"
    inc.kill()
    node = store.get(t.ComposabilityRequest, "wave-a").status.slice.worker_hostnames[0]
    sources = {c.metadata.name for c in store.list(t.ComposableResource)
               if c.spec.target_node == node and not c.being_deleted}
    return store, pool, node, sources


def _submit_drain(tw, store, node):
    m = tw.maintenance
    store.create(m.NodeMaintenance(metadata=tw.meta.ObjectMeta(name="drain"),
                                   spec=m.NodeMaintenanceSpec(node_name=node)))


def _drain_converged(tw, store, node):
    try:
        m = store.try_get(tw.maintenance.NodeMaintenance, "drain")
        if m is None or m.status.state != tw.maintenance.MAINTENANCE_STATE_DRAINED:
            return False
        if any(c.spec.target_node == node
               for c in store.list(tw.types.ComposableResource)
               if not c.being_deleted):
            return False
        return _all_running(tw, store)
    except Exception:
        return False


def _drain_invariants(tw, store, pool, node, sources):
    for res in store.list(tw.types.ComposableResource):
        assert res.status.pending_op is None, res.status.to_dict()
        assert not res.status.quarantined, res.status.to_dict()
    assert not [d for d in pool.get_resources() if d.node == node]
    assert_no_double_attach(pool.events)
    for src in sources:
        rel = next((i for i, ev in enumerate(pool.events)
                    if ev[0] == "release" and ev[1] == src), None)
        assert rel is not None, f"source {src} never released"
        live = set()
        for ev in pool.events[:rel]:
            if ev[0] == "attach" and ev[1] not in sources:
                live.add(ev[1])
            elif ev[0] == "release":
                live.discard(ev[1])
        assert live, f"source {src} released with no live replacement"
    return [len(pool.get_resources()), pool.free_chips("tpu-v4")]


def midpoint_crash_converges(tw):
    store, pool, node, sources = _migration_setup(tw)
    inc = Incarnation(tw, store, pool)
    _submit_drain(tw, store, node)
    rec = [wait_for(lambda: _drain_converged(tw, store, node), timeout=30)]
    w_migrate = inc.fuse.mutations
    telemetry = "telemetry.crash-operator"
    published = lambda: store.try_get(  # noqa: E731
        tw.fleet_api.FleetTelemetry, telemetry)
    rec.append(wait_for(lambda: published() is not None, timeout=10))
    inc.kill()
    # The crashed incarnation's snapshot stops advancing.
    seq_at_kill = published().spec.seq
    time.sleep(0.6)
    rec.append(published().spec.seq == seq_at_kill)
    rec.append(_drain_invariants(tw, store, pool, node, sources))
    rec.append(w_migrate > 3)

    store, pool, node, sources = _migration_setup(tw)
    inc = Incarnation(tw, store, pool, fuse=max(1, w_migrate // 2))
    _submit_drain(tw, store, node)
    wait_for(lambda: inc.fuse.dead.is_set()
             or _drain_converged(tw, store, node), timeout=20)
    inc.kill()
    inc = Incarnation(tw, store, pool)
    try:
        rec.append(wait_for(lambda: _drain_converged(tw, store, node),
                            timeout=30))
        rec.append(_drain_invariants(tw, store, pool, node, sources))
    finally:
        inc.kill()
    assert rec == [True, True, True, [12, 52], True, True, [12, 52]]
    return rec


def trace_id_survives_kill_restart_via_nonce(tw):
    t = tw.types
    tracing = tw.tracing
    tracing.reset()
    survivor = None
    for fuse in range(2, 40):
        store = _world(tw)
        pool = recording_pool(tw, async_steps=1)
        inc = Incarnation(tw, store, pool, fuse=fuse)
        _submit_wave(tw, store)
        wait_for(lambda: inc.fuse.dead.is_set() or _all_running(tw, store),
                 timeout=15)
        inc.kill()
        adds = [r for r in store.list(t.ComposableResource)
                if r.status.pending_op is not None
                and r.status.pending_op.verb == "add"]
        if adds:
            survivor = adds[0]
            break
    assert survivor is not None, "no crash point left a durable attach intent"
    nonce = survivor.status.pending_op.nonce
    pre = [e for e in tracing.trace_events(nonce) if e.get("ph") == "X"]
    inc = Incarnation(tw, store, pool)
    try:
        converged = wait_for(lambda: _all_running(tw, store), timeout=30)
    finally:
        inc.kill()
    spans = [e for e in tracing.trace_events(nonce) if e.get("ph") == "X"]
    adopt = [e for e in spans if e["name"] == "adopt"]
    rec = [bool(pre), any(e["name"] == "reconcile" for e in pre), converged,
           bool(adopt),
           bool(adopt) and adopt[0]["args"].get("resource")
           == survivor.metadata.name,
           len(spans) > len(pre)]
    assert rec == [True] * 6
    return rec


SCENARIOS = [
    shutdown_drains_inflight_then_releases_lease,
    deposed_leader_skips_drain_before_watchdog_notices,
    drain_timeout_reports_and_leaves_durable_intent,
    draining_dispatcher_rejects_new_submissions,
    midpoint_crash_converges,
    trace_id_survives_kill_restart_via_nonce,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
