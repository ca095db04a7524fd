"""The port's Lease objects and ``LeaseElector``
(tpu_composer_torch/api/lease.py, runtime/leases.py) and the Manager's
``leader_elector=`` slot against the JAX package's
(tests/test_lease_election.py's twin).

Each scenario runs once per package and returns leadership flags, lease
holders and transitions, metric deltas, the order of drains and
releases, the states a threaded operator reached and the adoption
reports of a failover; the scenario also asserts the reference test's
invariants. Tolerance: exact.

Clocks: both packages' electors run on an ``ElectorClock``
(tests/torch_crash.py) that moves only when the scenario steps it. A
steal or a stand-down therefore happens at a clock step the scenario
chooses, and the scenarios compare how many steps it took, never
elapsed time. The renew threads still run on real time (their period
is a ``threading.Event.wait``), so a scenario that needs a renewal to
land waits for it by condition.

Left out: ``TestLeaseOnKubeStore`` (``:568``), which runs the elector
over the JAX package's apiserver client (``runtime/kubestore.py``) and
the fake apiserver; it waits for the port's store wire.
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
    steps_until,
)
from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)


def le(tw, store, ident, lease=1.0, renew=0.1, **kw):
    return tw.leases.LeaseElector(store, identity=ident, lease_duration_s=lease,
                                  renew_period_s=renew, **kw)


def holder(tw, store, name):
    return store.get(tw.lease.Lease, name).spec.holder_identity


def partitioned_store(tw, store):
    """``store`` whose Lease reads and writes fail while ``flag[0]``."""
    Lease, StoreError = tw.lease.Lease, tw.store.StoreError
    flag = [False]
    real_get, real_update = store.get, store.update

    def get(cls, name):
        if flag[0] and cls is Lease:
            raise StoreError("injected partition")
        return real_get(cls, name)

    def update(obj):
        if flag[0] and isinstance(obj, Lease):
            raise StoreError("injected partition")
        return real_update(obj)

    store.get, store.update = get, update
    return flag


# -- LeaseElector --------------------------------------------------------------

def single_winner_and_failover(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = le(tw, store, "replica-a", renew=0.2)
        b = le(tw, store, "replica-b", renew=0.2)
        rec = [a.try_acquire(), b.try_acquire(), a.is_leader, b.is_leader,
               holder(tw, store, a.name)]
        a.release()
        rec += [wait_for(b.try_acquire, timeout=3), b.is_leader,
                holder(tw, store, a.name),
                store.get(tw.lease.Lease, a.name).spec.lease_transitions]
        b.release()
    assert rec[:8] == [True, False, True, False, "replica-a", True, True,
                       "replica-b"] and rec[8] >= 1
    return rec


def expired_lease_is_stolen(tw):
    store = tw.store.Store()
    with elector_clock(tw) as clock:
        a = le(tw, store, "replica-a", renew=10.0)
        b = le(tw, store, "replica-b")
        rec = [a.try_acquire()]
        a._stop_renew.set()
        rec.append(b.try_acquire())
        rec.append(steps_until(clock, b.try_acquire, step=0.05, limit=100))
        rec.append(b.is_leader)
        b.release()
    assert rec[:2] == [True, False] and rec[2] is not None and rec[3]
    return rec


def partitioned_leader_stands_down_before_lease_stealable(tw):
    store = tw.store.Store()
    fails = tw.metrics.lease_transitions_total
    with elector_clock(tw) as clock:
        flag = partitioned_store(tw, store)
        a = le(tw, store, "replica-a", lease=3.0, renew_deadline_s=1.0)
        b = le(tw, store, "replica-b", lease=3.0, renew_deadline_s=1.0)
        rec = [a.try_acquire()]
        f0 = fails.value(event="renewed_fail")
        flag[0] = True
        # Inside the renew deadline the leader keeps leading through
        # failed renewals...
        clock.step(0.9)
        rec.append(wait_for(lambda: fails.value(event="renewed_fail") > f0 + 1,
                            timeout=5))
        rec.append(a.is_leader)
        # ...and at the deadline it stands down, before the lease is
        # stealable (3 s).
        clock.step(0.1)
        rec.append(wait_for(lambda: not a.is_leader, timeout=5))
        flag[0] = False
        rec.append(b.try_acquire())
        rec.append(steps_until(clock, b.try_acquire, step=0.1, limit=80))
        rec.append(b.is_leader)
        b.release()
    assert rec[:5] == [True, True, True, True, False] and rec[5] is not None
    return rec


def renew_deadline_must_be_less_than_duration(tw):
    try:
        le(tw, tw.store.Store(), "x", lease=10.0, renew_deadline_s=10.0)
    except ValueError as e:
        return ("ValueError", str(e))
    raise AssertionError("accepted renew_deadline >= lease_duration")


def deposed_leader_stands_down(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = le(tw, store, "replica-a")
        rec = [a.try_acquire()]
        lease = store.get(tw.lease.Lease, a.name)
        lease.spec.holder_identity = "replica-b"
        store.update(lease)
        rec.append(wait_for(lambda: not a.is_leader, timeout=3))
    assert rec == [True, True]
    return rec


# -- hardening -----------------------------------------------------------------

def monotonic_fencing_survives_wall_clock_jump(tw):
    import datetime

    store = tw.store.Store()
    with elector_clock(tw) as clock:
        flag = partitioned_store(tw, store)
        a = le(tw, store, "replica-a", lease=3.0, renew_deadline_s=1.0)
        rec = [a.try_acquire()]
        frozen = clock.now_dt() - datetime.timedelta(hours=1)
        a._now = lambda: frozen
        flag[0] = True
        clock.step(1.0)
        rec.append(wait_for(lambda: not a.is_leader, timeout=5))
    assert rec == [True, True]
    return rec


def fast_clock_contender_cannot_steal_healthy_lease(tw):
    import datetime

    store = tw.store.Store()
    Lease = tw.lease.Lease
    with elector_clock(tw) as clock:
        a = le(tw, store, "replica-a")
        b = le(tw, store, "replica-b")
        rec = [a.try_acquire()]
        b._now = lambda: clock.now_dt() + datetime.timedelta(hours=1)
        refused = []
        for _ in range(12):  # three lease durations, a renewing throughout
            clock.step(0.25)
            stamp = clock.now_iso()
            assert wait_for(lambda: store.get(Lease, a.name).spec.renew_time
                            == stamp, timeout=5)
            refused.append(b.try_acquire())
        rec += [refused, a.is_leader]
        a._stop_renew.set()
        rec.append(steps_until(clock, b.try_acquire, step=0.05, limit=100))
        b.release()
    assert rec[0] and not any(rec[1]) and rec[2] and rec[3] is not None
    return rec


def renew_failures_surface_in_metric(tw):
    store = tw.store.Store()
    m = tw.metrics.lease_transitions_total
    Lease, StoreError = tw.lease.Lease, tw.store.StoreError
    with elector_clock(tw):
        a0, f0 = m.value(event="acquired"), m.value(event="renewed_fail")
        a = le(tw, store, "replica-a", lease=2.0, renew=0.05,
               renew_deadline_s=1.0)
        rec = [a.try_acquire(), m.value(event="acquired") - a0]
        real_update = store.update

        def failing_update(obj):
            if isinstance(obj, Lease):
                raise StoreError("injected flake")
            return real_update(obj)

        store.update = failing_update
        rec.append(wait_for(lambda: m.value(event="renewed_fail") > f0,
                            timeout=5))
        store.update = real_update
        a.release()
    assert rec == [True, 1, True]
    return rec


def release_conflict_never_clears_successor_lease(tw):
    store = tw.store.Store()
    Lease = tw.lease.Lease
    with elector_clock(tw) as clock:
        a = le(tw, store, "replica-a", renew=10.0)
        rec = [a.try_acquire()]
        a._stop_renew.set()
        stale = store.get(Lease, a.name)
        lease = store.get(Lease, a.name)
        lease.spec.holder_identity = "replica-b"
        lease.spec.renew_time = clock.now_iso()
        store.update(lease)
        a.store = type("Stale", (), {
            "try_get": lambda self_, cls, name: stale,
            "update": store.update,
        })()
        a.release()
        rec.append(holder(tw, store, a.name))
    assert rec == [True, "replica-b"]
    return rec


def deposed_replica_release_leaves_successor_lease(tw):
    store = tw.store.Store()
    Lease = tw.lease.Lease
    with elector_clock(tw) as clock:
        a = le(tw, store, "replica-a")
        rec = [a.try_acquire()]
        lease = store.get(Lease, a.name)
        lease.spec.holder_identity = "replica-b"
        lease.spec.renew_time = clock.now_iso()
        store.update(lease)
        rec.append(wait_for(lambda: not a.is_leader, timeout=3))
        calls = []
        real_update = store.update
        store.update = lambda obj: (calls.append(obj), real_update(obj))[1]
        a.release()
        store.update = real_update
        rec += [any(isinstance(o, Lease) for o in calls),
                holder(tw, store, a.name)]
    assert rec == [True, True, False, "replica-b"]
    return rec


# -- managers ------------------------------------------------------------------

def _nodes(tw, store, n=2):
    for i in range(n):
        node = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        node.status.tpu_slots = 4
        store.create(node)


def _request(tw, store, name, size=4):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=size))))


def _state(tw, store, name):
    r = store.try_get(tw.types.ComposabilityRequest, name)
    return None if r is None else r.status.state


def _timings(tw):
    return (tw.req.RequestTiming(updating_poll=0.05, cleaning_poll=0.05),
            tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                 detach_poll=0.05, detach_fast=0.05,
                                 busy_poll=0.05))


def _manager(tw, store, pool, ident):
    rt, st = _timings(tw)
    mgr = tw.manager.Manager(store=store, leader_elector=le(
        tw, store, ident, renew=0.2))
    mgr.add_controller(tw.req.ComposabilityRequestReconciler(store, pool,
                                                             timing=rt))
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool), timing=st))
    return mgr


def exactly_one_reconciles_then_failover(tw):
    store = tw.store.Store()
    _nodes(tw, store)
    pool = tw.inmem.InMemoryPool()
    with elector_clock(tw):
        m1 = _manager(tw, store, pool, "replica-1")
        m2 = _manager(tw, store, pool, "replica-2")
        m1.start(workers_per_controller=1)
        t2 = threading.Thread(target=m2.start, daemon=True)
        t2.start()
        try:
            rec = [wait_for(lambda: m1._elector.is_leader, timeout=5),
                   m2._elector.is_leader]
            _request(tw, store, "r1")
            rec.append(wait_for(lambda: _state(tw, store, "r1") == "Running",
                                timeout=10))
            m1.stop()
            rec.append(wait_for(lambda: m2._elector.is_leader, timeout=10))
            _request(tw, store, "r2")
            rec.append(wait_for(lambda: _state(tw, store, "r2") == "Running",
                                timeout=10))
        finally:
            m1.stop()
            m2.stop()
            t2.join(timeout=5)
    assert rec == [True, False, True, True, True]
    return rec


def watchdog_stops_manager_on_lost_lease(tw):
    store = tw.store.Store()
    _nodes(tw, store, 1)
    pool = tw.inmem.InMemoryPool()
    m = tw.metrics.lease_transitions_total
    d0 = m.value(event="deposed")
    with elector_clock(tw):
        mgr = tw.manager.Manager(store=store,
                                 leader_elector=le(tw, store, "old-leader"))
        rt, _ = _timings(tw)
        mgr.add_controller(tw.req.ComposabilityRequestReconciler(
            store, pool, timing=rt))
        mgr.start(workers_per_controller=1)
        try:
            rec = [mgr._elector.is_leader]
            lease = store.get(tw.lease.Lease, mgr._elector.name)
            lease.spec.holder_identity = "usurper"
            store.update(lease)
            rec.append(wait_for(lambda: mgr.lost_leadership, timeout=5))
            rec.append(wait_for(lambda: all(
                not t.is_alive() for t in mgr._controllers[0]._threads),
                timeout=5))
            rec.append(m.value(event="deposed") - d0)
            time.sleep(1.5)
            rec.append(m.value(event="deposed") - d0)
        finally:
            mgr.stop()
    assert rec == [True, True, True, 1, 1]
    return rec


def standby_adopts_pending_intents_mid_wave(tw):
    t = tw.types
    store = tw.store.Store()
    _nodes(tw, store)
    pool = recording_pool(tw, async_steps=3)
    reports = []

    def replica(ident):
        fuse = CrashFuse(tw, store)
        disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.01,
                                              concurrency=4, poll_interval=0.05)
        mgr = tw.manager.Manager(store=fuse, leader_elector=le(
            tw, fuse, ident, renew=0.2), dispatcher=disp, drain_timeout=0.0)
        mgr.add_startup_hook(lambda: reports.append(
            (ident, tw.adoption.adopt_pending_ops(fuse, pool, disp))))
        rt, st = _timings(tw)
        mgr.add_controller(tw.req.ComposabilityRequestReconciler(fuse, pool,
                                                                 timing=rt))
        mgr.add_controller(tw.rc.ComposableResourceReconciler(
            fuse, pool, tw.fake.FakeNodeAgent(pool=pool), timing=st,
            dispatcher=disp))
        mgr.add_runnable(disp.run)
        return mgr, fuse, disp

    with elector_clock(tw) as clock:
        m1, fuse1, disp1 = replica("leader")
        m2, fuse2, disp2 = replica("standby")
        m1.start(workers_per_controller=2)
        t2 = threading.Thread(target=m2.start,
                              kwargs={"workers_per_controller": 2}, daemon=True)
        t2.start()
        try:
            rec = [wait_for(lambda: m1._elector.is_leader, timeout=5),
                   m2._elector.is_leader]
            _request(tw, store, "wave", size=8)
            rec.append(wait_for(lambda: any(
                r.status.pending_op is not None
                for r in store.list(t.ComposableResource)), timeout=10))
            fuse1.die()
            disp1.kill()

            def stolen():
                time.sleep(0.05)
                return m2._elector.is_leader

            rec.append(steps_until(clock, stolen, step=0.25, limit=200)
                       is not None)
            rec.append(wait_for(lambda: any(i == "standby" for i, _ in reports),
                                timeout=5))
            rec.append([r.total >= 1 for i, r in reports if i == "standby"])

            def converged():
                req = store.try_get(t.ComposabilityRequest, "wave")
                return (req is not None and req.status.state == "Running"
                        and sum(len(r.device_ids)
                                for r in req.status.resources.values()) == 8)

            rec.append(wait_for(converged, timeout=30))
            kids = store.list(t.ComposableResource)
            rec.append([(r.status.pending_op, r.status.attach_attempts,
                         r.status.quarantined) for r in kids])
            rec += [len(pool.get_resources()), pool.free_chips("tpu-v4")]
            assert_no_double_attach(pool.events)
        finally:
            fuse1.die()
            disp1.kill()
            try:
                m1.stop()
            except Exception:
                pass
            m2.stop()
            disp2.kill()
            t2.join(timeout=5)
    assert rec[:6] == [True, False, True, True, True, [True]]
    assert rec[6] and rec[8:] == [8, 56]
    assert all(r == (None, 0, False) for r in rec[7])
    return rec


SCENARIOS = [
    single_winner_and_failover,
    expired_lease_is_stolen,
    partitioned_leader_stands_down_before_lease_stealable,
    renew_deadline_must_be_less_than_duration,
    deposed_leader_stands_down,
    monotonic_fencing_survives_wall_clock_jump,
    fast_clock_contender_cannot_steal_healthy_lease,
    renew_failures_surface_in_metric,
    release_conflict_never_clears_successor_lease,
    deposed_replica_release_leaves_successor_lease,
    exactly_one_reconciles_then_failover,
    watchdog_stops_manager_on_lost_lease,
    standby_adopts_pending_intents_mid_wave,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
