"""The port's shard leases (tpu_composer_torch/runtime/shards.py), the
controllers' shard fences, the dispatcher's ``owns=`` gate and the scoped
adoption pass against the JAX package's (tests/test_shards.py's twin).

``shard_for`` must send every name to the JAX package's shard: a
different hash is a different result. The twin holds the two over 10,000
seeded names for K in {1, 2, 3, 6, 16}.

Each scenario runs once per package and returns the owned shard sets,
lease holders and transitions, hook orders, fence outcomes, adoption
reports and the pool's attachment log; the scenario also asserts the
reference test's invariants. Tolerance: exact.

Clocks: the electors run on an ``ElectorClock`` (tests/torch_crash.py)
patched into both packages' ``leases`` and ``shards`` modules, and are
driven by ``tick()``. The expiry scenarios compare the number of clock
steps a steal or a fence took, never elapsed time; the reference's
bounds (no steal before 0.8 lease durations, a fence before the lease is
stealable) are asserted in clock seconds.
"""

from __future__ import annotations

import random
import time
import zlib

import pytest
import torch

from tests.torch_crash import (
    assert_no_double_attach,
    elector_clock,
    recording_pool,
    steps_until,
)
from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin, wait_for

torch.set_num_threads(1)


def elector(tw, store, ident, k=4, lease=1.0, renew=0.2, **kw):
    return tw.shards.ShardLeaseElector(
        store, num_shards=k, identity=ident,
        lease_duration_s=lease, renew_period_s=renew, **kw)


def owned(*electors):
    return [sorted(e.owned_shards()) for e in electors]


# -- shard_for -----------------------------------------------------------------

def test_shard_for_matches_jax_on_seeded_names():
    jax, port = twin(JAX_ROOT).shards, twin(PORT_ROOT).shards
    rng = random.Random(20261017)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789-."
    names = [""] + ["".join(rng.choice(alphabet)
                            for _ in range(rng.randint(1, 40)))
                    for _ in range(9999)]
    for k in (1, 2, 3, 6, 16):
        a = [jax.shard_for(n, k) for n in names]
        b = [port.shard_for(n, k) for n in names]
        assert a == b, k
        if k > 1:
            assert set(a) == set(range(k))


def stable_crc32_mapping(tw):
    out = {}
    for name in ("wave-a", "wave-a-0", "detach-tpu-0", ""):
        for k in (1, 2, 4, 7):
            got = tw.shards.shard_for(name, k)
            assert got == (0 if k <= 1 else zlib.crc32(name.encode()) % k)
            out[f"{name}/{k}"] = got
    return out


def every_shard_reachable(tw):
    hit = sorted({tw.shards.shard_for(f"res-{i}", 4) for i in range(64)})
    assert hit == [0, 1, 2, 3]
    return hit


def ownership_view(tw):
    sh = tw.shards
    own = sh.ShardOwnership(4)
    rec = [own.owns_key("x")]
    own._add(sh.shard_for("x", 4))
    rec += [own.owns_key("x"), own.owns_shard(sh.shard_for("x", 4))]
    own._discard(sh.shard_for("x", 4))
    rec.append(own.owns_key("x"))
    assert rec == [False, True, True, False]
    return rec


# -- the elector ---------------------------------------------------------------

def single_replica_owns_every_shard(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = elector(tw, store, "replica-a")
        a.tick()
        holders = [store.get(tw.lease.Lease, a.shard_lease_name(i))
                   .spec.holder_identity for i in range(4)]
    assert owned(a) == [[0, 1, 2, 3]] and set(holders) == {"replica-a"}
    return [owned(a), holders]


def two_replicas_balance_within_spread_one(tw):
    store = tw.store.Store()
    with elector_clock(tw) as clock:
        a = elector(tw, store, "replica-a")
        b = elector(tw, store, "replica-b")
        for _ in range(6):
            a.tick()
            b.tick()
            clock.step(0.2)
    oa, ob = a.owned_shards(), b.owned_shards()
    assert oa | ob == {0, 1, 2, 3} and not oa & ob
    assert abs(len(oa) - len(ob)) <= 1
    return owned(a, b)


def returning_replica_is_handed_shards(tw):
    store = tw.store.Store()
    with elector_clock(tw) as clock:
        a = elector(tw, store, "replica-a")
        a.tick()
        rec = [owned(a)]
        b = elector(tw, store, "replica-b")
        for _ in range(8):
            b.tick()
            a.tick()
            clock.step(0.2)
    rec.append(owned(a, b))
    assert [len(s) for s in rec[1]] == [2, 2]
    return rec


def dead_replica_shards_stolen_within_lease_duration(tw):
    store = tw.store.Store()
    lease_s = 0.6
    failover = tw.metrics.shard_handoffs_total
    f0 = failover.value(reason="failover")
    with elector_clock(tw) as clock:
        a = elector(tw, store, "replica-a", lease=lease_s, renew=0.1)
        b = elector(tw, store, "replica-b", lease=lease_s, renew=0.1)
        for _ in range(2):
            a.tick()
            b.tick()
        orphaned = a.owned_shards()
        assert b.owned_shards() and orphaned
        t_dead = clock.t

        def took():
            b.tick()
            return orphaned <= b.owned_shards()

        steps = steps_until(clock, took, step=0.05, limit=int(5 * lease_s / 0.05))
        after = clock.t - t_dead
    assert steps is not None, "survivor never took the dead shards"
    assert lease_s * 0.8 <= after <= 2 * lease_s + 0.5
    assert b.owned_shards() == {0, 1, 2, 3}
    assert failover.value(reason="failover") - f0 >= 1
    return [sorted(orphaned), steps, owned(b),
            failover.value(reason="failover") - f0]


def partitioned_replica_fences_before_successor_steals(tw):
    store = tw.store.Store()
    Lease, StoreError = tw.lease.Lease, tw.store.StoreError
    partitioned = [False]

    class Partition:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def _gate(self, obj_or_cls):
            if partitioned[0] and (obj_or_cls is Lease
                                   or isinstance(obj_or_cls, Lease)):
                raise StoreError("injected partition")

        def list(self, cls, label_selector=None):
            self._gate(cls)
            return self._inner.list(cls, label_selector)

        def update(self, obj):
            self._gate(obj)
            return self._inner.update(obj)

        def create(self, obj):
            self._gate(obj)
            return self._inner.create(obj)

    lost = []
    with elector_clock(tw) as clock:
        a = elector(tw, Partition(store), "replica-a", lease=1.2, renew=0.1,
                    renew_deadline_s=0.4)
        a.on_lose.append(lambda s, reason: lost.append((s, reason)))
        b = elector(tw, store, "replica-b", lease=1.2, renew=0.1)
        a.tick()
        b.tick()
        t0 = clock.t
        partitioned[0] = True

        def fenced():
            a.tick()
            return not a.owned_shards()

        fence_steps = steps_until(clock, fenced, step=0.05, limit=60)
        fenced_after = clock.t - t0
        b.tick()
        early = owned(b)

        def b_took_everything():
            b.tick()
            return b.owned_shards() == {0, 1, 2, 3}

        steal_steps = steps_until(clock, b_took_everything, step=0.05,
                                  limit=120)
    assert fence_steps is not None and fenced_after < 1.2
    assert {r for _, r in lost} == {"fenced"} and early == [[]]
    assert steal_steps is not None
    return [fence_steps, sorted(lost), early, steal_steps, owned(a, b)]


def release_hands_off_instantly(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = elector(tw, store, "replica-a")
        a.tick()
        a.release()
        holders = [store.get(tw.lease.Lease, a.shard_lease_name(i))
                   .spec.holder_identity for i in range(4)]
        b = elector(tw, store, "replica-b")
        b.tick()
    assert holders == [""] * 4 and owned(b) == [[0, 1, 2, 3]]
    return [holders, owned(b)]


def hooks_fire_batched_in_handoff_order(tw):
    store = tw.store.Store()
    events = []
    with elector_clock(tw):
        a = elector(tw, store, "replica-a", k=2)
        a.on_acquire.append(lambda wins: events.append((
            "acquire", dict(wins), {s: a.ownership.owns_shard(s) for s in wins})))
        a.on_ready.append(lambda shards: events.append((
            "ready", sorted(shards), {s: a.ownership.owns_shard(s) for s in shards})))
        a.tick()
    assert [e[0] for e in events] == ["acquire", "ready"]
    assert set(events[0][1]) == {0, 1} and set(events[0][1].values()) == {"bootstrap"}
    assert all(events[0][2].values()) and events[1][1] == [0, 1]
    return events


def _attaching_cr(tw, store, name, chips=1, nonce=None):
    t = tw.types
    res = t.ComposableResource(metadata=tw.meta.ObjectMeta(name=name))
    res.spec.type, res.spec.model = "tpu", "tpu-v4"
    res.spec.target_node, res.spec.chip_count = "worker-0", chips
    res.status.state = t.RESOURCE_STATE_ATTACHING
    store.create(res)
    got = store.get(t.ComposableResource, name)
    got.status.state = t.RESOURCE_STATE_ATTACHING
    got.status.pending_op = t.PendingOp(
        verb="add", nonce=nonce or f"nonce-{name}", node="worker-0",
        started_at=tw.meta.now_iso())
    return store.update_status(got)


def adoption_repoll_passes_dispatcher_gate_on_handoff(tw):
    t = tw.types
    store = tw.store.Store()
    store.create(t.Node(metadata=tw.meta.ObjectMeta(name="worker-0")))
    pool = recording_pool(tw, async_steps=2)
    got = _attaching_cr(tw, store, "handoff-res", nonce="nonce-h")
    try:
        pool.add_resource(got)
    except Exception:
        pass
    outcomes = []
    with elector_clock(tw):
        b = elector(tw, store, "replica-b", k=2)
        disp = tw.dispatcher.FabricDispatcher(
            pool, batch_window=0.01, poll_interval=0.02,
            owns=b.ownership.owns_key)
        b.on_acquire.append(lambda wins: outcomes.append(
            tw.adoption.adopt_pending_ops(store, pool, disp, shards=set(wins),
                                          num_shards=2)))
        b.tick()
    repolled = [n for rep in outcomes for n in rep.repolled]
    driven = wait_for(lambda: disp.op_state("add", "handoff-res")
                      in ("pending", "done"), timeout=5)
    disp.kill()
    assert "handoff-res" in repolled and driven
    return [repolled, driven]


def startup_damping_caps_initial_grab(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = elector(tw, store, "replica-a", k=4, lease=5.0, expected_replicas=2)
        a.tick()
    assert len(a.owned_shards()) == 2
    return owned(a)


def dead_member_heartbeats_are_garbage_collected(tw):
    store = tw.store.Store()
    Lease = tw.lease.Lease
    with elector_clock(tw) as clock:
        dead = elector(tw, store, "replica-dead", lease=0.4, renew=0.1)
        dead.tick()
        survivor = elector(tw, store, "replica-live", lease=0.4, renew=0.1)
        survivor.tick()
        name = dead._member_name
        present = store.try_get(Lease, name) is not None

        def gc_done():
            survivor.tick()
            return (store.try_get(Lease, name) is None
                    and name not in survivor._obs)

        steps = steps_until(clock, gc_done, step=0.05, limit=80)
        own_hb = store.try_get(Lease, survivor._member_name) is not None
    assert present and steps is not None and own_hb
    return [name, steps, own_hb]


def acquire_returns_even_with_zero_shards(tw):
    store = tw.store.Store()
    with elector_clock(tw):
        a = elector(tw, store, "replica-a", k=1)
        b = elector(tw, store, "replica-b", k=1)
        a.tick()
        rec = [owned(a), b.acquire(poll_interval=0.05)]
        try:
            rec += [owned(b), b.is_leader]
        finally:
            b.release()
            a.release()
    assert rec == [[[0]], True, [[]], True]
    return rec


# -- ownership enforcement -----------------------------------------------------

def _enforcement_world(tw):
    store = tw.store.Store()
    n = tw.types.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
    n.status.tpu_slots = 4
    store.create(n)
    return store, tw.inmem.InMemoryPool()


def fence_outcome(fn, *a):
    try:
        fn(*a)
    except Exception as e:  # noqa: BLE001 - the class is compared
        return type(e).__name__
    return None


def fabric_write_path_fenced_for_unowned_key(tw):
    store, pool = _enforcement_world(tw)
    own = tw.shards.ShardOwnership(4)
    rec_ = tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(), ownership=own)
    res = _attaching_cr(tw, store, "fenced-res")
    rec = [fence_outcome(rec_._fabric_add, res),
           fence_outcome(rec_._fabric_remove, res), pool.get_resources(),
           tw.shards.ShardFencedError in rec_.quiet_exceptions]
    assert rec == ["ShardFencedError", "ShardFencedError", [], True]
    return rec


def request_slice_verbs_fenced_for_unowned_key(tw):
    """The request side's fence (``_slice_fabric``): an unowned request
    key raises ShardFencedError before any slice verb; an owned one gets
    the fabric."""
    store, pool = _enforcement_world(tw)
    own = tw.shards.ShardOwnership(4)
    req = tw.req.ComposabilityRequestReconciler(store, pool, ownership=own)
    t = tw.types
    r = t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="slice-req"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=4)))
    rec = [fence_outcome(req._slice_fabric, r),
           tw.shards.ShardFencedError in req.quiet_exceptions]
    own._add(tw.shards.shard_for("slice-req", 4))
    rec.append(req._slice_fabric(r) is pool)
    assert rec == ["ShardFencedError", True, True]
    return rec


def worker_drops_unowned_keys_without_reconciling(tw):
    store, pool = _enforcement_world(tw)
    own = tw.shards.ShardOwnership(4)
    reconciled = []
    rec_ = tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(), ownership=own)
    real = rec_.reconcile
    rec_.reconcile = lambda name: (reconciled.append(name), real(name))[1]
    _attaching_cr(tw, store, "owned-res")
    _attaching_cr(tw, store, "ghost-res")
    own._add(tw.shards.shard_for("owned-res", 4))
    assert tw.shards.shard_for("ghost-res", 4) != tw.shards.shard_for("owned-res", 4)
    rec_.start(workers=1)
    try:
        seen = wait_for(lambda: "owned-res" in reconciled, timeout=5)
        time.sleep(0.3)
        ghost = "ghost-res" in reconciled
    finally:
        rec_.stop()
    assert seen and not ghost
    return [seen, ghost]


def dispatcher_abandons_unowned_lanes_on_fence(tw):
    store, pool = _enforcement_world(tw)
    mine = {"keep-res", "lose-res"}
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=30.0,
                                          owns=lambda n: n in mine)
    keep = _attaching_cr(tw, store, "keep-res")
    lose = _attaching_cr(tw, store, "lose-res")
    rec = [fence_outcome(disp.add_resource, r) for r in (keep, lose)]
    rec += [disp.op_state("add", "keep-res"), disp.op_state("add", "lose-res")]
    mine.discard("lose-res")
    rec += [disp.abandon_unowned(), disp.op_state("add", "lose-res"),
            disp.op_state("add", "keep-res")]
    disp.kill()
    rec.append(pool.get_resources())
    assert rec == ["DispatchedAttaching"] * 2 + ["queued", "queued", 1, None,
                                                 "queued", []]
    return rec


def dispatcher_refuses_unowned_op_at_execute_time(tw):
    store, pool = _enforcement_world(tw)
    mine = {"race-res"}
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.01,
                                          poll_interval=0.02,
                                          owns=lambda n: n in mine)
    res = _attaching_cr(tw, store, "race-res")
    rec = [fence_outcome(disp.add_resource, res)]
    mine.discard("race-res")
    rec.append(wait_for(lambda: disp.op_state("add", "race-res") is None,
                        timeout=5))
    time.sleep(0.1)
    rec.append(pool.get_resources())
    disp.kill()
    assert rec == ["DispatchedAttaching", True, []]
    return rec


# -- scoped adoption -----------------------------------------------------------

def adoption_scoped_to_shard_keys(tw):
    t = tw.types
    store = tw.store.Store()
    store.create(t.Node(metadata=tw.meta.ObjectMeta(name="worker-0")))
    pool = tw.inmem.InMemoryPool()
    names = [f"mig-{i}" for i in range(8)]
    by_shard = {}
    for name in names:
        _attaching_cr(tw, store, name, nonce=f"n-{name}")
        by_shard.setdefault(tw.shards.shard_for(name, 4), []).append(name)
    shard = next(s for s, members in by_shard.items() if members)
    report = tw.adoption.adopt_pending_ops(store, pool, None, shards={shard},
                                           num_shards=4)
    touched = sorted(set(report.adopted + report.reissued + report.repolled
                         + report.cleared + report.deferred))
    untouched = sorted(n for n in names if store.get(
        t.ComposableResource, n).status.pending_op is not None)
    assert touched == sorted(by_shard[shard])
    assert untouched == sorted(set(names) - set(touched))
    return [shard, touched, untouched]


def shard_migration_mid_attach_no_double_attach(tw):
    t = tw.types
    store = tw.store.Store()
    store.create(t.Node(metadata=tw.meta.ObjectMeta(name="worker-0")))
    pool = recording_pool(tw)
    got = _attaching_cr(tw, store, "mid-attach", chips=2, nonce="nonce-mid")
    pool.add_resource(got)
    before = pool.free_chips("tpu-v4")
    report = tw.adoption.adopt_pending_ops(
        store, pool, None, shards={tw.shards.shard_for("mid-attach", 2)},
        num_shards=2)
    after = store.get(t.ComposableResource, "mid-attach")
    rec = [report.adopted, after.status.pending_op, len(after.status.device_ids),
           after.status.attach_attempts, after.status.quarantined,
           pool.free_chips("tpu-v4") - before, list(pool.events)]
    assert_no_double_attach(pool.events)
    assert rec[:6] == [["mid-attach"], None, 2, 0, False, 0]
    return rec


SCENARIOS = [
    stable_crc32_mapping,
    every_shard_reachable,
    ownership_view,
    single_replica_owns_every_shard,
    two_replicas_balance_within_spread_one,
    returning_replica_is_handed_shards,
    dead_replica_shards_stolen_within_lease_duration,
    partitioned_replica_fences_before_successor_steals,
    release_hands_off_instantly,
    hooks_fire_batched_in_handoff_order,
    adoption_repoll_passes_dispatcher_gate_on_handoff,
    startup_damping_caps_initial_grab,
    dead_member_heartbeats_are_garbage_collected,
    acquire_returns_even_with_zero_shards,
    fabric_write_path_fenced_for_unowned_key,
    request_slice_verbs_fenced_for_unowned_key,
    worker_drops_unowned_keys_without_reconciling,
    dispatcher_abandons_unowned_lanes_on_fence,
    dispatcher_refuses_unowned_op_at_execute_time,
    adoption_scoped_to_shard_keys,
    shard_migration_mid_attach_no_double_attach,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
