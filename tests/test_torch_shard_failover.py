"""Sharded failover of the port's operator against the JAX package's
(tests/test_shard_failover.py's twin, cut to tier-1 size).

The reference's two tests are slow-marked soaks (a 32-chip wave, kill -9
on real lease timing). Their twin here keeps the reference's failover
world, 3 replicas over K = 6 shards, each replica wired as the
reference's ``ShardedReplica`` (a crash fuse over the shared store, a
``CachedClient``, a dispatcher with ``owns=``, both reconcilers and the
syncer with ``ownership=``, scoped adoption on acquire, resync on ready,
lane fencing on lose), and runs three scenarios through both packages:

- ``crashed_attach_owner_fails_over``: the owner of a child's shard
  crashes with the child's attach intent durable and the child not yet
  Online (no drain, no lease release); a survivor steals the shard,
  adopts the intent and the request reaches Running with one attach per
  child; the crashed replica's own reconcile of the child then raises
  ``ShardFencedError`` with no fabric call; and the survivors' fleet
  views age the crashed replica out (its snapshot's seq frozen past the
  staleness window on the survivor's own clock) with two live replicas.
- ``graceful_handoff_drains_once``: a planned stop of the shard's owner
  drains its dispatcher once, releases its leases, and the third
  replica takes the shard on its next tick.
- ``rebalance_handoff_mid_wave``: the reference's second soak at four
  shards: a newcomer joining mid-wave is handed shards and the wave
  converges with no double attach.

Clocks: every elector and fleet plane runs on one ``ElectorClock``
(tests/torch_crash.py) patched into both packages, with a renew period
far longer than the scenario, so the electors tick and the fleet planes
publish and aggregate only when the scenario calls ``tick()``.
Shard ownership, steals and handoffs are then a function of the ticks
and clock steps alone, and are compared exactly, with step counts in
place of elapsed times. The controllers and dispatchers run on real
threads; their outcomes are compared after waiting for a condition.

Left out: the trace stitching across a merged fleet trace (the fleet
twin, tests/test_torch_fleet.py, holds the merge itself).
"""

from __future__ import annotations

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

LEASE_S = 2.0
RENEW_S = 600.0  # never elapses in a scenario: ticks are driven by hand


class TaggedPool:
    """Per-replica fabric facade logging every mutating verb with the
    replica's identity before it runs."""

    def __init__(self, pool, identity, log):
        self._pool, self._identity, self._log = pool, identity, log

    def _tag(self, verb, names):
        self._log.append((self._identity, verb, names))

    def add_resource(self, r):
        self._tag("add", [r.metadata.name])
        return self._pool.add_resource(r)

    def remove_resource(self, r):
        self._tag("remove", [r.metadata.name])
        return self._pool.remove_resource(r)

    def add_resources(self, rs):
        self._tag("add", [r.metadata.name for r in rs])
        return self._pool.add_resources(rs)

    def remove_resources(self, rs):
        self._tag("remove", [r.metadata.name for r in rs])
        return self._pool.remove_resources(rs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_pool"], name)


class ShardedReplica:
    def __init__(self, tw, raw_store, pool, ident, k, log, reports,
                 expected_replicas=0):
        self.ident = ident
        self.fuse = CrashFuse(tw, raw_store)
        self.client = tw.cache.CachedClient(self.fuse)
        self.tagged = TaggedPool(pool, ident, log)
        self.elector = tw.shards.ShardLeaseElector(
            self.fuse, k, identity=ident, lease_duration_s=LEASE_S,
            renew_period_s=RENEW_S, expected_replicas=expected_replicas)
        own = self.elector.ownership
        self.dispatcher = tw.dispatcher.FabricDispatcher(
            self.tagged, batch_window=0.01, concurrency=4, poll_interval=0.05,
            owns=own.owns_key)
        # The reference's fleet plane, publishing through the fuse; the
        # scenario ticks it by hand on the stepped clock.
        self.fleet = tw.fleet.FleetPlane(
            self.fuse, identity=ident, num_shards=k, ownership=own,
            publish_period=0.25, stale_after_s=2.0)
        self.mgr = tw.manager.Manager(
            store=self.client, leader_elector=self.elector,
            dispatcher=self.dispatcher, drain_timeout=5.0, replica_id=ident,
            fleet=self.fleet)
        self.elector.on_acquire.append(lambda wins: reports.append(
            (ident, dict(wins), tw.adoption.adopt_pending_ops(
                self.client, self.tagged, self.dispatcher, shards=set(wins),
                num_shards=k))))
        self.elector.on_ready.append(lambda shards: self.mgr.resync(
            lambda key, _s=frozenset(shards): tw.shards.shard_for(key, k) in _s))
        self.elector.on_lose.append(
            lambda shard, reason: self.dispatcher.abandon_unowned())
        self.req_rec = tw.req.ComposabilityRequestReconciler(
            self.client, self.tagged,
            timing=tw.req.RequestTiming(updating_poll=0.05, cleaning_poll=0.05),
            ownership=own)
        self.res_rec = tw.rc.ComposableResourceReconciler(
            self.client, self.tagged, tw.fake.FakeNodeAgent(pool=pool),
            timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                        detach_poll=0.05, detach_fast=0.05,
                                        busy_poll=0.05),
            dispatcher=self.dispatcher, ownership=own)
        self.mgr.add_controller(self.req_rec)
        self.mgr.add_controller(self.res_rec)
        self.mgr.add_runnable(tw.syncer.UpstreamSyncer(
            self.client, self.tagged, period=0.1, grace=5.0, ownership=own))
        self.mgr.add_runnable(self.dispatcher.run)

    def start(self):
        self.mgr.start(workers_per_controller=2)

    def owned(self):
        return sorted(self.elector.owned_shards())

    def kill(self):
        """Crash: every store call fails from here on and the dispatcher
        abandons its lanes; no drain, no lease release. The informer
        cache keeps serving what it last saw."""
        self.fuse.die()
        self.dispatcher.kill()

    def stop(self):
        try:
            self.mgr.stop()
        except Exception:
            pass


class World:
    def __init__(self, tw, k=6, nodes=4, async_steps=3):
        self.tw = tw
        self.store = tw.store.Store()
        for i in range(nodes):
            n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 4
            self.store.create(n)
        self.pool = recording_pool(tw, async_steps=async_steps)
        self.log, self.reports = [], []
        self.k = k
        self.replicas = []

    def add(self, ident, expected_replicas=0):
        r = ShardedReplica(self.tw, self.store, self.pool, ident, self.k,
                           self.log, self.reports, expected_replicas)
        self.replicas.append(r)
        r.start()
        return r

    def submit(self, name, size):
        t = self.tw.types
        self.store.create(t.ComposabilityRequest(
            metadata=self.tw.meta.ObjectMeta(name=name),
            spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
                type="tpu", model="tpu-v4", size=size))))

    def children(self):
        return self.store.list(self.tw.types.ComposableResource)

    def running(self, name, size):
        req = self.store.try_get(self.tw.types.ComposabilityRequest, name)
        return (req is not None and req.status.state == "Running"
                and sum(len(r.device_ids)
                        for r in req.status.resources.values()) == size)

    def owner_of(self, key):
        shard = self.tw.shards.shard_for(key, self.k)
        return next(r for r in self.replicas
                    if shard in r.elector.owned_shards())

    def clean_accounting(self):
        kids = self.children()
        rec = [[(c.status.pending_op, c.status.attach_attempts,
                 c.status.quarantined) for c in kids],
               len(self.pool.get_resources()), self.pool.free_chips("tpu-v4")]
        assert_no_double_attach(self.pool.events)
        return rec

    def close(self):
        for r in self.replicas:
            r.kill()
        for r in self.replicas:
            r.stop()


def _advance(world, clock, seconds, live):
    """Step the clock in quarter seconds, ticking every live replica at
    each step, so live leases stay fresh in everyone's observation."""
    for _ in range(int(round(seconds / 0.25))):
        clock.step(0.25)
        for r in live:
            r.elector.tick()


def _bootstrap(world, names):
    """Start the replicas one by one (each holds its damped share after
    its first tick), then tick everyone once more."""
    out = []
    for name in names:
        r = world.add(name, expected_replicas=len(names))
        out.append(r.owned())
    for r in world.replicas:
        r.elector.tick()
    return out


def crashed_attach_owner_fails_over(tw):
    t = tw.types
    with elector_clock(tw) as clock:
        w = World(tw)
        try:
            rec = [_bootstrap(w, ["replica-a", "replica-b", "replica-c"])]
            rec.append([r.owned() for r in w.replicas])
            for r in w.replicas:
                r.fleet.tick()
            w.submit("wave", 8)
            caught = wait_for(lambda: any(
                c.status.pending_op is not None
                and c.status.state != t.RESOURCE_STATE_ONLINE
                for c in w.children()), timeout=10, interval=0.002)
            kid = next(c for c in w.children() if c.status.pending_op is not None
                       and c.status.state != t.RESOURCE_STATE_ONLINE)
            victim = w.owner_of(kid.metadata.name)
            victim.kill()
            crash_state = (kid.status.state, kid.status.pending_op.verb)
            lost = sorted(victim.elector.owned_shards())
            survivors = [r for r in w.replicas if r is not victim]
            log_at_crash = len([e for e in w.log if e[0] == victim.ident])
            held = lambda: set().union(*(s.elector.owned_shards()
                                         for s in survivors))

            # The crashed replica's renew loop cannot list its leases: it
            # fences every shard it held at the renew deadline, before
            # any survivor may steal them...
            def fenced():
                clock.step(0.25)
                for r in w.replicas:
                    r.elector.tick()
                return not victim.elector.owned_shards()

            rec += [caught, crash_state, lost,
                    steps_until(clock, fenced, step=0.0, limit=40),
                    sorted(held() & set(lost))]
            # ...and its own reconcile of the child is then refused at the
            # fabric boundary.
            try:
                victim.res_rec.reconcile(kid.metadata.name)
                fence = None
            except Exception as e:  # noqa: BLE001 - the class is compared
                fence = type(e).__name__
            rec.append(fence)

            def stolen():
                clock.step(0.25)
                for s in survivors:
                    s.elector.tick()
                return set(lost) <= held()

            rec.append(steps_until(clock, stolen, step=0.0, limit=40))

            # The survivors' fleet views age the corpse out: its seq has
            # not moved since the bootstrap publish, past the staleness
            # window on each survivor's own clock.
            def aged_out():
                clock.step(0.25)
                for s in survivors:
                    s.elector.tick()
                    s.fleet.tick()
                views = [s.fleet.snapshot()["replicas"] for s in survivors]
                return all(v.get(victim.ident, {}).get("stale") is True
                           and sorted(i for i, x in v.items()
                                      if not x["stale"])
                           == sorted(s.ident for s in survivors)
                           for v in views)

            rec.append(steps_until(clock, aged_out, step=0.0, limit=40))
            rec.append(sorted(survivors[0].fleet.snapshot()["replicas"]))
            rec.append(sorted((ident, sorted(wins.items()))
                              for ident, wins, _ in w.reports
                              if ident != victim.ident
                              and "failover" in wins.values()))
            rec.append(wait_for(lambda: w.running("wave", 8), timeout=30))
            rec.append(len([e for e in w.log if e[0] == victim.ident])
                       - log_at_crash)
            rec.append(sorted(
                sum(1 for ev in w.pool.events
                    if ev[0] == "attach" and ev[1] == c.metadata.name)
                for c in w.children()))
            rec.append(w.clean_accounting())
        finally:
            w.close()
    (_, _, caught, _, lost, fence_steps, early, fence, steal_steps,
     aged_steps, view, wins, running, victim_calls, attaches, _) = rec
    assert caught and lost and fence_steps is not None and early == []
    assert fence == "ShardFencedError" and steal_steps is not None
    assert aged_steps is not None and len(view) == 3
    assert wins and running and victim_calls == 0 and attaches == [1, 1]
    return rec


def graceful_handoff_drains_once(tw):
    drains = tw.metrics.dispatcher_drains_total
    with elector_clock(tw) as clock:
        w = World(tw)
        try:
            rec = [_bootstrap(w, ["replica-a", "replica-b", "replica-c"])]
            w.submit("job", 4)
            rec.append(wait_for(lambda: w.running("job", 4), timeout=30))
            # Past the startup damping window, so a survivor may hold
            # more than its first share.
            _advance(w, clock, LEASE_S + 0.25, w.replicas)
            owner = w.owner_of("job")
            shards = owner.owned()
            d0 = drains.value(outcome="clean")
            owner.mgr.stop()
            rec.append(drains.value(outcome="clean") - d0)
            rec.append([w.store.get(tw.lease.Lease,
                                    owner.elector.shard_lease_name(s))
                        .spec.holder_identity for s in shards])
            others = [r for r in w.replicas if r is not owner]
            for r in others:
                r.elector.tick()
            held = set().union(*(r.elector.owned_shards() for r in others))
            rec.append(set(shards) <= held)
            rec.append(w.owner_of("job").ident != owner.ident)
            rec.append(w.running("job", 4))
            rec.append(w.clean_accounting())
        finally:
            w.close()
    assert rec[1:3] == [True, 1] and rec[4:7] == [True, True, True]
    assert set(rec[3]) == {""}
    return rec


def rebalance_handoff_mid_wave(tw):
    t = tw.types
    with elector_clock(tw) as clock:
        w = World(tw, k=4, async_steps=2)
        try:
            a = w.add("incumbent")
            rec = [a.owned()]
            w.submit("wave", 16)
            rec.append(wait_for(lambda: any(c.status.pending_op is not None
                                            for c in w.children()),
                                timeout=15, interval=0.002))
            b = w.add("newcomer")

            def handed():
                clock.step(0.25)
                b.elector.tick()
                a.elector.tick()
                return (len(b.elector.owned_shards()) >= 1
                        and len(a.owned()) + len(b.owned()) == 4
                        and not (a.elector.owned_shards()
                                 & b.elector.owned_shards()))

            rec.append(steps_until(clock, handed, step=0.0, limit=40))
            rec.append([a.owned(), b.owned()])
            rec.append(sorted(reason for ident, wins, _ in w.reports
                              if ident == "newcomer"
                              for reason in wins.values()))
            rec.append(wait_for(lambda: w.running("wave", 16), timeout=60))
            rec.append(w.clean_accounting())
        finally:
            w.close()
    assert rec[0] == [0, 1, 2, 3] and rec[1] and rec[2] is not None
    assert rec[5]
    return rec


SCENARIOS = [
    crashed_attach_owner_fails_over,
    graceful_handoff_drains_once,
    rebalance_handoff_mid_wave,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
