"""The port's NodeMaintenance drain and the request controller's repair and
migration drivers (tpu_composer_torch/controllers/{maintenance,
request_controller}.py) against the JAX package's, in the scenarios of
tests/test_migration.py and tests/test_repair.py that need no
``ChaosFabricProvider``.

Each scenario is stepped by hand on both packages (``run_both``): a Store
of 4 workers, an ``InMemoryPool`` as the fabric (the JAX tests wrap it in
a ``ChaosFabricProvider`` that these scenarios never trip), a
``FakeNodeAgent`` and the request, resource and maintenance reconcilers
with the JAX tests' fast timings. The JAX tests' invariants are checked
on every turn on both sides (make-before-break, no duplicate attachment,
the cordon held, surge budgets); the observations compared are the
final world (``RequestWorld.view``-style: requests, children, pool), the
NodeMaintenance status, the quarantine markers and the deltas of the
repair and migration counters. ``uuid.uuid4`` is seeded the same on both
sides. Masked: uid, timestamps, intent nonces, trace ids. Tolerance:
exact.

The two deadline scenarios run on a stepped clock (``StepClock``): the
``now_iso`` that both packages' ``maintenance`` and ``request_controller``
modules read moves by the pump's ``sleep`` once per pump step, and the
pump does not sleep. The count of placement attempts that failed before
the deadline and the seconds the abort message quotes are then a
function of the steps alone, and are compared exactly.

The scenarios of test_repair.py that drive a ``ChaosFabricProvider``
(``TestRepairBreaker::test_brownout_freezes_repairs_instead_of_mass_detach``,
``TestSyncerVanishDetection``, ``TestFabricAttachedStaleness``) run with
``World(chaos=True)``: the reconcilers compose through each package's
chaos provider round its pool. Waiting for the admission sub-slice: test_migration.py's
``test_node_name_is_immutable`` (the validating webhooks). The workload
half of the drain (``TestMaintenanceDrivesReshard``) is held by
tests/test_torch_reshard.py's operator-driven reshard.
"""

from __future__ import annotations

import contextlib
import datetime
import time

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)

MODEL = "tpu-v4"
MANAGED_BY = "app.kubernetes.io/managed-by"


class StepClock:
    """A ``now_iso`` that moves only when stepped: from a fixed instant,
    by the seconds each ``step`` is given."""

    def __init__(self):
        self.t = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)

    def __call__(self):
        return self.t.isoformat(timespec="microseconds").replace("+00:00", "Z")

    def step(self, seconds):
        self.t += datetime.timedelta(seconds=seconds)


@contextlib.contextmanager
def step_clock(tw):
    """Both controllers' ``now_iso`` (their module globals) replaced by
    one ``StepClock`` for the duration."""
    clock = StepClock()
    mods = (tw.mc, tw.req)
    saved = [m.now_iso for m in mods]
    for m in mods:
        m.now_iso = clock
    try:
        yield clock
    finally:
        for m, f in zip(mods, saved):
            m.now_iso = f


class World:
    def __init__(self, tw, nodes=4, slots=8, chips=64, migrate=None,
                 repair=None, failure_threshold=2, recovery_threshold=1,
                 node_degrade_threshold=0, default_deadline=1800.0,
                 pool_cls=None, clock=None, chaos=False):
        self.tw = tw
        # With a StepClock the pump steps it by ``sleep`` instead of
        # sleeping.
        self.clock = clock
        t = tw.types
        self.store = tw.store.Store()
        for i in range(nodes):
            n = t.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = slots
            self.store.create(n)
        self.pool = (pool_cls or tw.inmem.InMemoryPool)(chips={MODEL: chips})
        self.fabric = (tw.chaos.ChaosFabricProvider(self.pool) if chaos
                       else self.pool)
        self.agent = tw.fake.FakeNodeAgent(pool=self.pool)
        self.req_rec = tw.req.ComposabilityRequestReconciler(
            self.store, self.fabric,
            timing=tw.req.RequestTiming(updating_poll=0.01, cleaning_poll=0.01,
                                        running_poll=5.0, repair_poll=0.01),
            repair=repair or tw.req.RepairConfig(),
            migrate=migrate or tw.req.MigrateConfig())
        self.res_rec = tw.rc.ComposableResourceReconciler(
            self.store, self.fabric, self.agent,
            timing=tw.rc.ResourceTiming(
                health_failure_threshold=failure_threshold,
                health_recovery_threshold=recovery_threshold,
                node_degrade_threshold=node_degrade_threshold))
        self.maint_rec = tw.mc.NodeMaintenanceReconciler(
            self.store,
            timing=tw.mc.MaintenanceTiming(drain_poll=0.01,
                                           default_deadline=default_deadline),
            publisher=self.res_rec.publisher)
        m = tw.metrics
        self._counters = [(m.migrations_total, "migrations"),
                          (m.repairs_total, "repairs")]
        self._base = self.counters()

    # -- objects ------------------------------------------------------------
    def request(self, name="req-1", size=8, **spec_kw):
        t = self.tw.types
        self.store.create(t.ComposabilityRequest(
            metadata=self.tw.meta.ObjectMeta(name=name),
            spec=t.ComposabilityRequestSpec(
                resource=t.ResourceDetails(type="tpu", model=MODEL, size=size),
                **spec_kw)))

    def drain(self, node, name="mx", deadline=0.0):
        m = self.tw.maintenance
        self.store.create(m.NodeMaintenance(
            metadata=self.tw.meta.ObjectMeta(name=name),
            spec=m.NodeMaintenanceSpec(node_name=node, deadline_seconds=deadline)))

    def maint(self, name="mx"):
        return self.store.try_get(self.tw.maintenance.NodeMaintenance, name)

    def maint_state(self, name="mx"):
        m = self.maint(name)
        return None if m is None else m.status.state

    def members(self, owner=None):
        return [c for c in self.store.list(self.tw.types.ComposableResource)
                if not c.being_deleted
                and (owner is None or c.metadata.labels.get(MANAGED_BY) == owner)]

    def converged(self, name="req-1", scoped=True):
        req = self.store.try_get(self.tw.types.ComposabilityRequest, name)
        if req is None:
            return False
        live = self.members(name if scoped else None)
        return (req.status.state == "Running"
                and len(live) == req.status.slice.num_hosts
                and all(c.status.state == "Online" for c in live))

    def quarantined(self, node):
        return self.tw.publisher.node_quarantined(self.store, node)

    # -- stepping -------------------------------------------------------------
    def pump(self, steps=120, invariant=None, done=None, sleep=0.0,
             requests=None):
        t = self.tw.types
        fe = self.tw.provider.FabricError
        for _ in range(steps):
            for m in self.store.list(self.tw.maintenance.NodeMaintenance):
                try:
                    self.maint_rec.reconcile(m.metadata.name)
                except fe:
                    pass
            names = requests or [r.metadata.name
                                 for r in self.store.list(t.ComposabilityRequest)]
            for n in names:
                try:
                    self.req_rec.reconcile(n)
                except fe:
                    pass
            for c in self.store.list(t.ComposableResource):
                try:
                    self.res_rec.reconcile(c.metadata.name)
                except fe:
                    pass
            if invariant is not None:
                invariant()
            if done is not None and done():
                return True
            if self.clock is not None:
                self.clock.step(sleep)
            elif sleep:
                time.sleep(sleep)
        return False

    def to_running(self, name="req-1", scoped=True):
        self.pump(done=lambda: self.converged(name, scoped))
        assert self.store.get(self.tw.types.ComposabilityRequest,
                              name).status.state == "Running"

    def no_duplicate_attachments(self):
        ids = [d.device_id for d in self.pool.get_resources()]
        assert len(ids) == len(set(ids)), ids

    # -- observing -------------------------------------------------------------
    def counters(self):
        out = {}
        for counter, name in self._counters:
            for labels in counter.label_sets():
                key = name + ":" + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                out[key] = counter.value(**labels)
        return out

    def view(self):
        t, dra = self.tw.types, self.tw.dra
        base = self._base
        now = self.counters()
        reqs = {r.metadata.name: dict(
            state=r.status.state, error=r.status.error,
            slice=r.status.slice.to_dict(),
            rows={k: v.to_dict() for k, v in r.status.resources.items()},
            migration={k: v.to_dict() for k, v in r.status.migration.items()})
            for r in self.store.list(t.ComposabilityRequest)}
        kids = {c.metadata.name: dict(
            spec=c.spec.to_dict(), state=c.status.state,
            device_ids=list(c.status.device_ids),
            failure=None if c.status.failure is None else c.status.failure.reason,
            annotations=dict(c.metadata.annotations), deleting=c.being_deleted)
            for c in self.store.list(t.ComposableResource)}
        maints = {m.metadata.name: m.status.to_dict()
                  for m in self.store.list(self.tw.maintenance.NodeMaintenance)}
        markers = sorted((r.spec.node_name, r.spec.reason)
                         for r in self.store.list(dra.DeviceTaintRule)
                         if not r.spec.device_uuid)
        return dict(
            requests=reqs, children=kids, maintenance=maints, markers=markers,
            fabric=sorted((d.device_id, d.node) for d in self.pool.get_resources()),
            free=self.pool.free_chips(MODEL), dead=self.pool.dead_chips(MODEL),
            counters={k: v - base.get(k, 0.0) for k, v in now.items()
                      if v - base.get(k, 0.0)})


# -- NodeMaintenance drains (tests/test_migration.py) ---------------------------------

def drain_migrates_make_before_break(tw):
    w = World(tw)
    w.request(size=8)
    w.to_running()
    req = w.store.get(tw.types.ComposabilityRequest, "req-1")
    victim_node = req.status.slice.worker_hostnames[0]
    source = next(c for c in w.members() if c.spec.target_node == victim_node)
    w.drain(victim_node)
    seen = {"repl_online": False}

    def invariant():
        w.no_duplicate_attachments()
        src = w.store.try_get(tw.types.ComposableResource, source.name)
        repl = next((c for c in w.store.list(tw.types.ComposableResource)
                     if c.metadata.annotations.get(tw.types.ANNOTATION_REPLACES)
                     == source.name), None)
        if repl is not None and repl.status.state == "Online":
            seen["repl_online"] = True
        if src is None or src.being_deleted:
            assert seen["repl_online"], "source detached before its replacement"
        assert w.quarantined(victim_node)

    w.pump(invariant=invariant, done=lambda: (
        w.maint_state() == "Drained" and w.converged()))
    m = w.maint()
    assert m.status.state == "Drained" and m.status.evacuated == 1
    live = w.members()
    assert len(live) == 2 and all(c.status.state == "Online" for c in live)
    assert not [c for c in live if c.spec.target_node == victim_node]
    req = w.store.get(tw.types.ComposabilityRequest, "req-1")
    assert req.status.migration == {}
    assert len(w.pool.get_resources()) == 8
    assert tw.metrics.node_maintenances_active.value() == 0.0
    return w.view()


def deleting_maintenance_uncordons(tw):
    w = World(tw)
    w.request(size=8)
    w.to_running()
    node = w.store.get(tw.types.ComposabilityRequest,
                       "req-1").status.slice.worker_hostnames[0]
    w.drain(node)
    w.pump(done=lambda: w.maint_state() == "Drained")
    assert w.quarantined(node)
    drained = w.view()
    w.store.delete(tw.maintenance.NodeMaintenance, "mx")
    w.pump(steps=5, done=lambda: w.maint() is None)
    assert w.maint() is None and not w.quarantined(node)
    return [drained, w.view()]


def escalation_quarantine_marker_is_never_cleared(tw):
    w = World(tw)
    w.request(size=8)
    w.to_running()
    node = w.store.get(tw.types.ComposabilityRequest,
                       "req-1").status.slice.worker_hostnames[0]
    w.res_rec.publisher.quarantine_node(node, "post-ready-failures")
    w.drain(node)
    w.pump(done=lambda: w.maint_state() == "Drained")
    w.store.delete(tw.maintenance.NodeMaintenance, "mx")
    w.pump(steps=5, done=lambda: w.maint() is None)
    assert w.quarantined(node)
    return w.view()


def drain_deadline_expiry_aborts(tw):
    with step_clock(tw) as clock:
        return _drain_deadline_expiry_aborts(tw, clock)


def _drain_deadline_expiry_aborts(tw, clock):
    w = World(tw, nodes=2, clock=clock)
    w.request(size=8)
    w.to_running()
    node = w.store.get(tw.types.ComposabilityRequest,
                       "req-1").status.slice.worker_hostnames[0]
    w.drain(node, deadline=0.15)
    w.pump(sleep=0.02, done=lambda: w.maint_state() == "Aborted")
    m = w.maint()
    assert m.status.state == "Aborted" and "deadline expired" in m.status.message
    assert not w.quarantined(node)
    w.pump(steps=20, done=w.converged)
    for c in w.members():
        assert c.status.state == "Online"
        assert tw.types.ANNOTATION_EVACUATE not in c.metadata.annotations
    return w.view()


def repair_policy_none_members_are_never_claimed(tw):
    with step_clock(tw) as clock:
        return _repair_policy_none_members_are_never_claimed(tw, clock)


def _repair_policy_none_members_are_never_claimed(tw, clock):
    w = World(tw, clock=clock)
    w.request(size=8, repair_policy=tw.types.REPAIR_NONE)
    w.to_running()
    node = w.store.get(tw.types.ComposabilityRequest,
                       "req-1").status.slice.worker_hostnames[0]
    w.drain(node, deadline=0.15)
    w.pump(steps=30)
    msg = w.maint().status.message
    assert "unmigratable: repairPolicy=None" in msg
    for c in w.members():
        assert tw.types.ANNOTATION_EVACUATE not in c.metadata.annotations
    w.pump(sleep=0.02, done=lambda: w.maint_state() == "Aborted")
    assert w.maint_state() == "Aborted" and not w.quarantined(node)
    return [msg, w.view()]


def surge_budgets_bound_concurrent_migrations(tw):
    w = World(tw, migrate=tw.req.MigrateConfig(max_concurrent=1))
    w.request("req-1", size=4)
    w.to_running("req-1")
    w.request("req-2", size=4)
    w.to_running("req-2")
    (packed,) = {c.spec.target_node for c in w.members()}

    def invariant():
        migrating = [c for c in w.members() if c.status.state == "Migrating"]
        assert len(migrating) <= 1
        w.no_duplicate_attachments()

    w.drain(packed)
    w.pump(steps=300, invariant=invariant, done=lambda: (
        w.maint_state() == "Drained" and w.converged("req-1")
        and w.converged("req-2")))
    assert w.maint().status.evacuated == 2
    assert not [c for c in w.members() if c.spec.target_node == packed]
    return w.view()


def breaker_freezes_evacuation_during_brownout(tw):
    w = World(tw, slots=4, migrate=tw.req.MigrateConfig(
        breaker_fraction=0.25, breaker_min_members=2))
    w.request("req-2", size=8, repair_policy=tw.types.REPAIR_NONE)
    w.to_running("req-2")
    w.request("req-1", size=4)
    w.to_running("req-1")
    sick = w.members("req-2")
    killed = []
    for c in sick:
        w.pool.set_health(c.status.device_ids[0],
                          tw.provider.DeviceHealth("Critical", "brownout"))
        killed.append(c.status.device_ids[0])
    w.pump(steps=10, done=lambda: all(
        w.store.get(tw.types.ComposableResource, c.name).status.state
        == "Degraded" for c in sick))
    victim_node = w.members("req-1")[0].spec.target_node
    w.drain(victim_node)
    w.pump(steps=30)
    assert tw.metrics.migration_breaker_open.value() == 1.0
    assert not [c for c in w.members() if c.status.state == "Migrating"]
    frozen = w.view()
    for dev in killed:
        w.pool.set_health(dev, tw.provider.DeviceHealth("OK"))
    w.pump(steps=300, done=lambda: w.maint_state() == "Drained")
    assert tw.metrics.migration_breaker_open.value() == 0.0
    assert w.maint_state() == "Drained"
    return [frozen, w.view()]


def online_members_evacuate_a_quarantined_node(tw):
    w = World(tw, node_degrade_threshold=1)
    w.request("req-1", size=4)
    w.to_running("req-1")
    w.request("req-2", size=4)
    w.to_running("req-2")
    (packed,) = {c.spec.target_node for c in w.members()}
    healthy = w.members("req-2")[0]
    victim = w.members("req-1")[0]
    w.pool.kill_device(victim.status.device_ids[0])
    w.pump(steps=10, done=lambda: w.quarantined(packed))
    assert w.quarantined(packed)
    w.pump(steps=300, done=lambda: (
        w.converged("req-1") and w.converged("req-2")
        and not [c for c in w.members() if c.spec.target_node == packed]))
    moved = w.members("req-2")[0]
    assert moved.spec.target_node != packed and moved.name != healthy.name
    return w.view()


def _defrag_world(tw, **spec_kw):
    w = World(tw)
    w.req_rec.scheduler.defrag.mode = "migrate"
    for name in ("r1", "r2", "r3", "r4"):
        w.request(name, size=4, **spec_kw)
        w.to_running(name)
    for name in ("r2", "r4"):
        w.store.delete(tw.types.ComposabilityRequest, name)
    w.pump(steps=60, done=lambda: all(
        w.store.try_get(tw.types.ComposabilityRequest, n) is None
        for n in ("r2", "r4")))
    return w


def defrag_executes_via_live_migration(tw):
    w = _defrag_world(tw)
    planner = w.req_rec.scheduler.defrag
    plan = planner.plan()
    assert len(plan.migrations) == 1
    mover, owner = plan.migrations[0].resource, plan.migrations[0].request
    assert planner.execute(plan) == 1
    child = w.store.get(tw.types.ComposableResource, mover)
    assert not child.being_deleted
    assert child.metadata.annotations[tw.types.ANNOTATION_EVACUATE] == "defrag"

    def invariant():
        req = w.store.get(tw.types.ComposabilityRequest, owner)
        assert req.status.state == "Running"
        assert [c for c in w.members(owner)
                if c.status.state in ("Online", "Migrating")]
        w.no_duplicate_attachments()

    w.pump(steps=200, invariant=invariant, done=lambda: (
        w.converged("r1") and w.converged("r3")
        and len({c.spec.target_node for c in w.members()}) == 1))
    assert len({c.spec.target_node for c in w.members()}) == 1
    assert planner.plan().empty
    return w.view()


def unmigratable_candidates_are_gated_with_reasons(tw):
    w = _defrag_world(tw, repair_policy=tw.types.REPAIR_NONE)
    planner = w.req_rec.scheduler.defrag
    plan = planner.plan()
    assert plan.empty
    assert planner.last_skips.get("repairPolicy=None", 0) >= 2
    return [dict(planner.last_skips), w.view()]


def loop_report_and_breaker_freeze(tw):
    w = _defrag_world(tw)
    loop = tw.defrag.DefragLoop(w.store, w.req_rec.scheduler.defrag,
                                execute=False)
    report = {k: v for k, v in loop.report().items() if k != "engine"}
    assert report["mode"] == "migrate" and report["frozen"] is False
    assert len(report["dry_run"]["migrations"]) == 1
    tw.metrics.repair_breaker_open.set(1.0)
    try:
        frozen = loop.report()
        assert frozen["frozen"] is True and frozen["dry_run"]["migrations"] == []
        assert loop.run_once().empty and loop.last_report["frozen"] is True
    finally:
        tw.metrics.repair_breaker_open.set(0.0)
    return [report, frozen]


# -- repair (tests/test_repair.py) ---------------------------------------------------

def dead_chip_member_is_replaced_make_before_break(tw):
    w = World(tw)
    w.request()
    w.to_running()
    victim = next(c for c in w.members() if c.spec.worker_id == 1)
    old_name, old_node = victim.name, victim.spec.target_node
    w.pool.kill_device(victim.status.device_ids[0])
    seen = {"repl_online": False}

    def invariant():
        w.no_duplicate_attachments()
        old = w.store.try_get(tw.types.ComposableResource, old_name)
        repl = next((c for c in w.store.list(tw.types.ComposableResource)
                     if c.metadata.annotations.get(tw.types.ANNOTATION_REPLACES)
                     == old_name), None)
        if repl is not None and repl.status.state == "Online":
            seen["repl_online"] = True
        if old is None or old.being_deleted:
            assert seen["repl_online"]

    w.pump(steps=80, invariant=invariant, requests=["req-1"], done=lambda: (
        w.store.try_get(tw.types.ComposableResource, old_name) is None
        and w.converged(scoped=False)))
    live = w.members()
    new_w1 = next(c for c in live if c.spec.worker_id == 1)
    assert new_w1.name != old_name and new_w1.spec.target_node != old_node
    req = w.store.get(tw.types.ComposabilityRequest, "req-1")
    assert req.status.slice.worker_hostnames[1] == new_w1.spec.target_node
    assert w.pool.dead_chips(MODEL) == 1
    return w.view()


def surge_budget_bounds_concurrent_repairs(tw):
    w = World(tw, nodes=8)
    w.request(size=16, max_concurrent_repairs=1)
    w.to_running()
    victims = [c for c in w.members() if c.spec.worker_id in (0, 2)]
    names = {v.name for v in victims}
    for v in victims:
        w.pool.kill_device(v.status.device_ids[0])
    peak = {"n": 0}

    def invariant():
        repairing = [c for c in w.store.list(tw.types.ComposableResource)
                     if c.status.state == "Repairing"]
        peak["n"] = max(peak["n"], len(repairing))
        assert len(repairing) <= 1
        w.no_duplicate_attachments()

    w.pump(steps=160, invariant=invariant, requests=["req-1"], done=lambda: (
        not (names & {c.name for c in w.store.list(tw.types.ComposableResource)})
        and w.converged(scoped=False)))
    assert peak["n"] == 1 and w.pool.dead_chips(MODEL) == 2
    return w.view()


def repair_waits_when_no_healthy_capacity(tw):
    w = World(tw, nodes=2)
    w.request()
    w.to_running()
    victim = w.members()[0]
    w.pool.kill_device(victim.status.device_ids[0])
    before = tw.metrics.repairs_total.value(outcome="failed")
    w.pump(steps=30, requests=["req-1"], done=lambda: (
        tw.metrics.repairs_total.value(outcome="failed") > before))
    v = w.store.get(tw.types.ComposableResource, victim.name)
    assert v.status.state == "Degraded"
    assert "repair of" in w.store.get(tw.types.ComposabilityRequest,
                                      "req-1").status.error
    return w.view()


def unsupported_repair_falls_back_to_resolve(tw):
    class NoRepairPool(tw.inmem.InMemoryPool):
        def repair_slice_member(self, slice_name, worker_id, node):
            raise tw.provider.UnsupportedRepair("this pool cannot swap chips in place")

    w = World(tw, pool_cls=NoRepairPool)
    w.request()
    w.to_running()
    victim = w.members()[0]
    w.pool.kill_device(victim.status.device_ids[0])
    w.pump(steps=160, requests=["req-1"], done=lambda: (
        victim.name not in {c.name for c in w.members()}
        and w.converged(scoped=False)))
    assert victim.name not in {c.name for c in w.members()}
    w.no_duplicate_attachments()
    return w.view()


def detach_only_policy_detaches_and_resolves(tw):
    w = World(tw)
    w.request(repair_policy=tw.types.REPAIR_DETACH_ONLY)
    w.to_running()
    victim = w.members()[0]
    w.pool.kill_device(victim.status.device_ids[0])
    w.pump(steps=160, requests=["req-1"], done=lambda: (
        victim.name not in {c.name for c in w.members()}
        and w.converged(scoped=False)))
    assert victim.name not in {c.name for c in w.members()}
    return w.view()


def none_policy_leaves_degraded_member_for_operator(tw):
    w = World(tw)
    w.request(repair_policy=tw.types.REPAIR_NONE)
    w.to_running()
    victim = w.members()[0]
    w.pool.kill_device(victim.status.device_ids[0])
    req = lambda: w.store.get(tw.types.ComposabilityRequest, "req-1")  # noqa: E731
    w.pump(steps=20, requests=["req-1"],
           done=lambda: "repairPolicy=None" in req().status.error)
    v = w.store.get(tw.types.ComposableResource, victim.name)
    assert v.status.state == "Degraded" and v.status.failure is not None
    evs = [e.reason for e in w.req_rec.recorder.for_object(
        kind="ComposabilityRequest", name="req-1")]
    assert "DegradedNoRepair" in evs
    degraded = w.view()
    w.pool.revive_device(victim.status.device_ids[0])
    w.pump(steps=40, requests=["req-1"], done=lambda: (
        w.converged(scoped=False) and not req().status.error))
    assert req().status.error == ""
    return [degraded, w.view()]


def none_policy_does_not_starve_lost_member_recovery(tw):
    w = World(tw)
    w.request(repair_policy=tw.types.REPAIR_NONE)
    w.to_running()
    sick, lost = sorted(w.members(), key=lambda c: c.spec.worker_id)
    w.pool.kill_device(sick.status.device_ids[0])
    w.pump(steps=20, requests=["req-1"], done=lambda: w.store.get(
        tw.types.ComposableResource, sick.name).status.state == "Degraded")
    w.store.delete(tw.types.ComposableResource, lost.name)
    w.pump(steps=200, requests=["req-1"], done=lambda: w.converged(scoped=False))
    live = w.members()
    assert len(live) == 2 and all(c.status.state == "Online" for c in live)
    return w.view()


def single_failure_on_small_fleet_still_repairs(tw):
    w = World(tw, repair=tw.req.RepairConfig(breaker_fraction=0.4,
                                              breaker_min_members=4))
    w.request()
    w.to_running()
    victim = w.members()[0]
    w.pool.kill_device(victim.status.device_ids[0])
    w.pump(steps=120, requests=["req-1"], done=lambda: (
        victim.name not in {c.name for c in w.members()}
        and w.converged(scoped=False)))
    assert victim.name not in {c.name for c in w.members()}
    return w.view()


def repeated_post_ready_failures_quarantine_the_node(tw):
    t = tw.types
    w = World(tw, node_degrade_threshold=2)
    for i, slice_name in enumerate(["s-a", "s-b"]):
        w.pool.reserve_slice(slice_name, MODEL, "2x2x1", ["worker-0"])
        w.store.create(t.ComposableResource(
            metadata=tw.meta.ObjectMeta(name=f"r{i}"),
            spec=t.ComposableResourceSpec(
                type="tpu", model=MODEL, target_node="worker-0", chip_count=4,
                slice_name=slice_name, worker_id=0, topology="2x2x1")))
        w.res_rec.reconcile(f"r{i}")
        w.res_rec.reconcile(f"r{i}")
    for i in range(2):
        cr = w.store.get(t.ComposableResource, f"r{i}")
        w.pool.kill_device(cr.status.device_ids[0])
        for _ in range(w.res_rec.timing.health_failure_threshold):
            w.res_rec.reconcile(f"r{i}")
    assert w.quarantined("worker-0")
    return w.view()


def node_deletion_replaces_member_and_reclaims_orphan(tw):
    t = tw.types
    w = World(tw, nodes=3)
    w.request()
    w.to_running()
    victim = next(c for c in w.members() if c.spec.worker_id == 1)
    victim_devices = set(victim.status.device_ids)
    gone = victim.spec.target_node
    syncer = tw.syncer.UpstreamSyncer(w.store, w.pool, period=0.01, grace=0.05,
                                      vanish_threshold=2)
    w.store.delete(t.Node, gone)
    now = 0.0
    for _ in range(300):
        w.pump(steps=1, requests=["req-1"])
        now += 0.1
        syncer.sync_once(now=now)
        w.no_duplicate_attachments()
        attached = {d.device_id for d in w.pool.get_resources()}
        if w.converged(scoped=False) and not (victim_devices & attached):
            break
    else:
        raise AssertionError("never converged")
    live = w.members()
    assert all(c.spec.target_node != gone for c in live)
    assert len({d.device_id for d in w.pool.get_resources()}) == sum(
        len(c.status.device_ids) for c in live)
    return w.view()


# -- the chaos provider's scenarios (tests/test_repair.py) -------------------------------

def brownout_freezes_repairs_instead_of_mass_detach(tw):
    with step_clock(tw) as clock:
        w = World(tw, nodes=8, clock=clock, chaos=True,
                  repair=tw.req.RepairConfig(breaker_fraction=0.5,
                                             breaker_min_members=2,
                                             min_degraded_seconds=0.5))
        gauge = tw.metrics.repair_breaker_open
        try:
            w.request(size=16)
            w.to_running()
            before = sorted(c.name for c in w.members())
            victims = sorted(w.members(), key=lambda c: c.spec.worker_id)[:3]
            for v in victims:
                w.fabric.degrade_node(v.spec.target_node)
            w.pump(steps=30, done=lambda: gauge.value() == 1.0)
            w.pump(steps=5)
            frozen = [gauge.value(), sorted(c.name for c in w.members()) == before,
                      sorted(c.status.state for c in w.members()), w.view()]
            reasons = sorted({e.reason for e in w.req_rec.recorder.for_object(
                kind="ComposabilityRequest", name="req-1")})
            w.fabric.heal()
            w.pump(steps=60, done=w.converged)
            w.req_rec.reconcile("req-1")
            assert frozen[0] == 1.0 and "RepairsFrozen" in reasons
            assert sorted(c.name for c in w.members()) == before
            return frozen + [reasons, w.view(), gauge.value()]
        finally:
            gauge.set(0.0)


def _online_member(w):
    tw, t = w.tw, w.tw.types
    w.pool.reserve_slice("s1", MODEL, "2x2x1", ["worker-0"])
    w.store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="r0"),
        spec=t.ComposableResourceSpec(
            type="tpu", model=MODEL, target_node="worker-0", chip_count=4,
            slice_name="s1", worker_id=0, topology="2x2x1")))
    w.res_rec.reconcile("r0")
    w.res_rec.reconcile("r0")
    cr = w.store.get(t.ComposableResource, "r0")
    assert cr.status.state == "Online"
    return cr


def _syncer(w):
    return w.tw.syncer.UpstreamSyncer(w.store, w.fabric, period=0.01,
                                      grace=100.0, vanish_threshold=2)


def _member(w, name="r0"):
    c = w.store.get(w.tw.types.ComposableResource, name)
    f = c.status.failure
    return (c.status.state, None if f is None else (f.source, f.reason))


def _sync(w, syncer, now):
    try:
        syncer.sync_once(now=now)
        return "ok"
    except w.tw.provider.FabricError as e:
        return type(e).__name__


def vanished_device_degrades_after_damping_window(tw):
    w = World(tw, chaos=True)
    cr = _online_member(w)
    syncer = _syncer(w)
    w.fabric.vanish_device(cr.status.device_ids[0])
    t = [_sync(w, syncer, 0.0), _member(w)]
    t += [_sync(w, syncer, 1.0), _member(w)]
    return t


def listing_blip_does_not_count_toward_vanish(tw):
    w = World(tw, chaos=True)
    _online_member(w)
    syncer = _syncer(w)
    w.fabric.fail_op("get_resources", times=2)
    t = [_sync(w, syncer, 0.0) for _ in range(2)]
    t += [_sync(w, syncer, 1.0), _sync(w, syncer, 2.0), _member(w)]
    return t


def vanished_member_recovers_when_devices_reappear(tw):
    w = World(tw, chaos=True)
    cr = _online_member(w)
    syncer = _syncer(w)
    dev = cr.status.device_ids[0]
    w.fabric.vanish_device(dev)
    t = [_sync(w, syncer, 0.0), _sync(w, syncer, 1.0), _member(w)]
    for _ in range(w.res_rec.timing.health_recovery_threshold + 1):
        w.res_rec.reconcile("r0")
    t.append(_member(w))
    w.fabric.unvanish_device(dev)
    t += [_sync(w, syncer, 2.0), _member(w)]
    return t


def vanished_member_is_repaired_despite_healthy_probe(tw):
    w = World(tw, chaos=True)
    w.request()
    w.to_running()
    victim = w.members()[0]
    syncer = _syncer(w)
    for dev in victim.status.device_ids:
        w.fabric.vanish_device(dev)
    t = [_sync(w, syncer, 0.0), _sync(w, syncer, 1.0), _member(w, victim.name)]
    w.pump(steps=160, done=lambda: (
        victim.name not in {c.name for c in w.store.list(
            tw.types.ComposableResource)} and w.converged()))
    assert victim.name not in {c.name for c in w.members()}
    return t + [w.view()]


def reappearing_device_resets_the_vanish_clock(tw):
    w = World(tw, chaos=True)
    cr = _online_member(w)
    syncer = _syncer(w)
    dev = cr.status.device_ids[0]
    w.fabric.vanish_device(dev)
    t = [_sync(w, syncer, 0.0)]
    w.fabric.unvanish_device(dev)
    t.append(_sync(w, syncer, 1.0))
    w.fabric.vanish_device(dev)
    t += [_sync(w, syncer, 2.0), _member(w)]
    return t


def unreachable_fabric_returns_none_not_empty(tw):
    w = World(tw, chaos=True)
    w.fabric.blackout()
    t = [w.res_rec.fabric_attached("worker-0")]
    w.fabric.heal()
    return t + [w.res_rec.fabric_attached("worker-0")]


def gauge_keeps_last_value_through_a_blip(tw):
    w = World(tw, chaos=True)
    w.request(size=4)
    w.to_running()
    node = w.members()[0].spec.target_node
    gauge = tw.metrics.composed_chips
    t = [gauge.value(node=node)]
    w.fabric.blackout()
    w.res_rec._refresh_composed_gauge(node)
    t.append(gauge.value(node=node))
    w.fabric.heal()
    w.res_rec._refresh_composed_gauge(node)
    return t + [gauge.value(node=node)]


SCENARIOS = [
    drain_migrates_make_before_break, deleting_maintenance_uncordons,
    escalation_quarantine_marker_is_never_cleared, drain_deadline_expiry_aborts,
    repair_policy_none_members_are_never_claimed,
    surge_budgets_bound_concurrent_migrations,
    breaker_freezes_evacuation_during_brownout,
    online_members_evacuate_a_quarantined_node,
    defrag_executes_via_live_migration,
    unmigratable_candidates_are_gated_with_reasons,
    loop_report_and_breaker_freeze,
    dead_chip_member_is_replaced_make_before_break,
    surge_budget_bounds_concurrent_repairs,
    repair_waits_when_no_healthy_capacity,
    unsupported_repair_falls_back_to_resolve,
    detach_only_policy_detaches_and_resolves,
    none_policy_leaves_degraded_member_for_operator,
    none_policy_does_not_starve_lost_member_recovery,
    single_failure_on_small_fleet_still_repairs,
    repeated_post_ready_failures_quarantine_the_node,
    node_deletion_replaces_member_and_reclaims_orphan,
    brownout_freezes_repairs_instead_of_mass_detach,
    vanished_device_degrades_after_damping_window,
    listing_blip_does_not_count_toward_vanish,
    vanished_member_recovers_when_devices_reappear,
    vanished_member_is_repaired_despite_healthy_probe,
    reappearing_device_resets_the_vanish_clock,
    unreachable_fabric_returns_none_not_empty,
    gauge_keeps_last_value_through_a_blip,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out
