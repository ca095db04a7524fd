"""The port's cluster scheduler (tpu_composer_torch/scheduler/) against the
JAX package's (tests/test_scheduler.py's twin).

Each scenario of tests/test_scheduler.py runs on both packages through
``run_both``: the same requests are stepped through each package's
request and resource reconcilers (``RequestWorld``: Store, nodes,
``InMemoryPool``, ``FakeNodeAgent``), and the observations — the
scenario's own results plus every request's state, error, slice and
rows, every child's spec and state, and the pool's reservations and
free chips — must be equal. ``uuid.uuid4`` is seeded the same on both
sides, so generated child names match; masked: uid, timestamps, intent
nonces, trace ids (``tests/torch_operator.MASKED``). The scenario's own
assertions (those of the JAX test) hold on both packages. Tolerance:
exact, except the fragmentation score (``pytest.approx``'s default, as
the JAX test).

The NVIDIA H100 rows have no JAX counterpart. They are held to the
port's own ``solve_slice``: a node of 8 GPUs holding a 4-GPU child has 4
free, a second 8-GPU request on that host is refused, and ``explain``
names the verdicts.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_operator import (
    PORT_ROOT,
    RequestWorld,
    outcome,
    run_both,
    seeded_uuids,
    twin,
)

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


def _state(w, name):
    return w.get(name).status.state


def decisions_view(doc):
    """An explain document without its clock (``at``) and without the
    engine layer that ran it (the JAX package runs ``py_scan`` where its
    native library is not built; the port always builds its own)."""
    def rec(r):
        r = {k: v for k, v in r.items() if k != "at"}
        if "inputs" in r:
            r["inputs"] = {k: v for k, v in r["inputs"].items()
                           if k != "engine"}
        return r
    return [rec(r) for r in doc["decisions"]]


# -- placement engine -------------------------------------------------------

def host_index(tw):
    hi = tw.placement.host_index
    out = [hi("worker-12"), hi("tpu-host-3"), hi("gateway")]
    assert out == [12, 3, None]
    return out


def tightest_fit_packs_fragmented_host(tw):
    w = RequestWorld(tw)
    w.request("frag", size=2, target_node="worker-2")
    w.run_to_ready("frag")
    w.request("r2", size=2)
    w.run_to_ready("r2")
    assert w.get("r2").status.slice.worker_hostnames == ["worker-2"]
    return w.view()


def contiguity_tiebreak_prefers_adjacent_window(tw):
    w = RequestWorld(tw, n_nodes=4)
    w.request("hole", size=4, target_node="worker-1")
    w.run_to_ready("hole")
    w.request("pair", size=8)
    w.run_to_ready("pair")
    assert w.get("pair").status.slice.worker_hostnames == ["worker-2", "worker-3"]
    return w.view()


def fragmentation_score(tw):
    w = RequestWorld(tw, n_nodes=4)
    engine = tw.placement.PlacementEngine(w.store)
    before = engine.fragmentation(set())
    w.request("r1", size=2, target_node="worker-0")
    w.run_to_ready("r1")
    after = engine.fragmentation(set())
    assert before == 0.0
    assert after == pytest.approx(1 - 12 / 14)
    return [before, after, w.view()]


def full_cluster_is_not_fragmented(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("r1", size=4)
    w.run_to_ready("r1")
    frag = tw.placement.PlacementEngine(w.store).fragmentation(set())
    assert frag == 0.0
    return frag


# -- gang admission ---------------------------------------------------------

def exactly_full_capacity_admits_one_gang_whole(tw):
    w = RequestWorld(tw, n_nodes=2)
    w.request("gang-a", size=8)
    w.request("gang-b", size=8)
    w.pump()
    states = {n: _state(w, n) for n in ("gang-a", "gang-b")}
    assert sorted(states.values()) == ["", "Running"]
    winner = next(n for n, s in states.items() if s == "Running")
    loser = next(n for n, s in states.items() if s != "Running")
    assert not w.children(loser)
    assert w.get(loser).status.error
    first = w.view()
    w.delete(winner)
    w.pump()
    w.run_to_ready(loser)
    return [states, first, w.view()]


def equal_priority_no_preemption(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("first", size=4)
    w.run_to_ready("first")
    w.request("second", size=4)
    w.pump(5)
    assert _state(w, "first") == "Running"
    assert w.get("second").status.error
    return w.view()


# -- preemption ---------------------------------------------------------------

def _victims(tw, w, hp, quarantined=frozenset()):
    sched = w.req_rec.scheduler
    return sched.preemptor.compute_victims(
        hp, tw.slices.solve_slice("tpu-v4", 4), set(quarantined),
        sched.engine.used_slots_map("hp"))


def victim_set_is_minimal(tw):
    w = RequestWorld(tw, n_nodes=2)
    w.request("small-a", size=2, target_node="worker-0")
    w.request("small-b", size=2, target_node="worker-0")
    w.request("big-c", size=4, target_node="worker-1")
    for n in ("small-a", "small-b", "big-c"):
        w.run_to_ready(n)
    victims = _victims(tw, w, w.request("hp", size=4, priority=100))
    assert victims == ["big-c"]
    return [victims, w.req_rec.scheduler.preemptor.last_search]


def fewest_chips_among_equal_cardinality(tw):
    w = RequestWorld(tw, n_nodes=2)
    w.request("cheap", size=2, target_node="worker-0")
    w.request("pricey", size=4, target_node="worker-1")
    for n in ("cheap", "pricey"):
        w.run_to_ready(n)
    victims = _victims(tw, w, w.request("hp", size=4, priority=100))
    assert victims == ["cheap"]
    return victims


def never_policy_protects_victim(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("protected", size=4, policy=tw.types.PREEMPT_NEVER)
    w.run_to_ready("protected")
    w.request("hp", size=4, priority=100)
    w.pump(5)
    assert _state(w, "protected") == "Running"
    assert w.get("hp").status.error
    return w.view()


def never_policy_preemptor_does_not_evict(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("batch", size=4)
    w.run_to_ready("batch")
    w.request("hp", size=4, priority=100, policy=tw.types.PREEMPT_NEVER)
    w.pump(5)
    assert _state(w, "batch") == "Running"
    return w.view()


def preemption_evicts_lower_priority(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("batch", size=4)
    w.run_to_ready("batch")
    w.request("hp", size=4, priority=100)
    trace = [outcome(w.req_rec.reconcile, "hp"), w.view()]
    w.run_to_ready("hp")
    assert _state(w, "batch") != "Running"
    return trace + [w.view()]


def preempt_clears_placeholder_rows_of_allocating_victim(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("victim", size=2)
    w.run_to_ready("victim")
    v = w.get("victim")
    v.status.state = "NodeAllocating"
    w.store.update_status(v)
    assert v.status.resources
    w.req_rec._preempt(w.request("hp", size=4, priority=100), ["victim"])
    v = w.get("victim")
    assert v.status.resources == {}
    assert "preempted" in v.status.error
    return w.view()


def victims_on_quarantined_nodes_not_chosen(tw):
    w = RequestWorld(tw, n_nodes=2)
    w.request("doomed", size=4, target_node="worker-0")
    w.request("alive", size=4, target_node="worker-1")
    for n in ("doomed", "alive"):
        w.run_to_ready(n)
    tw.publisher.DevicePublisher(w.store).quarantine_node("worker-0", "test")
    victims = _victims(tw, w, w.request("hp", size=4, priority=100),
                       {"worker-0"})
    assert victims == ["alive"]
    return victims


# -- backfill gate --------------------------------------------------------------

def _drain_only(w, name, until):
    for _ in range(30):
        outcome(w.req_rec.reconcile, name)
        for c in w.store.list(w.tw.types.ComposableResource):
            outcome(w.res_rec.reconcile, c.metadata.name)
        if until():
            return


def low_priority_held_back_for_feasible_high_priority(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("occupant", size=4, policy=tw.types.PREEMPT_NEVER)
    w.run_to_ready("occupant")
    w.request("hp", size=4, priority=50)
    w.pump(3)
    w.delete("occupant")
    _drain_only(w, "occupant", lambda: not w.store.list(
        tw.types.ComposableResource) and w.get("occupant") is None)
    w.request("lp", size=4)
    held = outcome(w.req_rec.reconcile, "lp")
    assert held[0] == "raised" and "held back" in held[2]
    w.run_to_ready("hp")
    assert _state(w, "lp") != "Running"
    return [held, w.view()]


def scalar_request_cannot_backfill_steal_from_pending_slice(tw):
    w = RequestWorld(tw, n_nodes=1, chips={"tpu-v4": 64, "gpu-a100": 8})
    w.request("occupant", size=4, policy=tw.types.PREEMPT_NEVER)
    w.run_to_ready("occupant")
    w.request("hp", size=4, priority=50)
    w.pump(3)
    w.delete("occupant")
    _drain_only(w, "occupant", lambda: not w.store.list(
        tw.types.ComposableResource) and w.get("occupant") is None)
    w.request("gpu", size=1, model="gpu-a100")
    held = outcome(w.req_rec.reconcile, "gpu")
    assert held[0] == "raised" and "held back" in held[2]
    w.run_to_ready("hp")
    return [held, w.view()]


def grow_onto_contended_host_cannot_slip_the_gate(tw):
    w = RequestWorld(tw, n_nodes=1, chips={"tpu-v4": 64, "gpu-a100": 8})
    w.request("gpu", size=2, model="gpu-a100")
    w.run_to_ready("gpu")
    w.request("hp", size=2, priority=100)
    shape = tw.slices.solve_slice("tpu-v4", 2)
    w.req_rec.scheduler.queue.note_pending(
        w.get("hp"), shape.num_hosts, shape.chips_per_host)
    w.resize("gpu", 3)
    w.req_rec.reconcile("gpu")
    held = outcome(w.req_rec.reconcile, "gpu")
    assert held[0] == "raised" and "held back" in held[2]
    w.run_to_ready("hp")
    return [held, w.view()]


def anchored_pending_demand_counts_only_the_delta(tw):
    w = RequestWorld(tw, n_nodes=1, slots=8,
                     chips={"tpu-v4": 64, "gpu-a100": 16})
    w.request("hi", size=4, model="gpu-a100", priority=100)
    w.run_to_ready("hi")
    w.request("peer", size=3, model="gpu-a100")
    w.run_to_ready("peer")
    w.resize("hi", 6)
    w.pump(3)
    assert w.get("hi").status.error
    w.delete("peer")
    _drain_only(w, "peer", lambda: w.get("peer") is None and all(
        c.spec.target_node != "worker-0"
        or c.metadata.labels.get(tw.types.LABEL_MANAGED_BY) == "hi"
        for c in w.store.list(tw.types.ComposableResource)))
    w.request("lo", size=3, model="gpu-a100")
    held = outcome(w.req_rec.reconcile, "lo")
    assert held[0] == "raised" and "held back" in held[2]
    w.run_to_ready("hi")
    assert len(w.children("hi")) == 6
    return [held, w.view()]


def unsatisfiable_high_priority_does_not_starve_cluster(tw):
    w = RequestWorld(tw, n_nodes=2)
    tw.publisher.DevicePublisher(w.store).quarantine_node("worker-0", "fabric dead")
    w.request("hp", size=4, priority=100, target_node="worker-0")
    w.pump(3)
    assert w.get("hp").status.error
    w.request("lp", size=4)
    w.run_to_ready("lp")
    assert w.get("lp").status.slice.worker_hostnames == ["worker-1"]
    return w.view()


# -- defragmentation ------------------------------------------------------------

def _fragmented(tw):
    w = RequestWorld(tw, n_nodes=4)
    for name in ("r1", "r2", "r3", "r4"):
        w.request(name, size=2)
        w.run_to_ready(name)
    w.delete("r2")
    w.delete("r4")
    w.pump()
    return w


def _plan_view(plan):
    return dict(migrations=[m.__dict__ for m in plan.migrations],
                frag_before=plan.frag_before, frag_after=plan.frag_after,
                empty=plan.empty)


def plan_is_pure_and_deterministic(tw):
    w = _fragmented(tw)
    p1, p2 = w.req_rec.scheduler.defrag.plan(), w.req_rec.scheduler.defrag.plan()
    assert p1.migrations and p1.migrations == p2.migrations
    assert p1.frag_after < p1.frag_before
    assert all(not c.being_deleted
               for c in w.store.list(tw.types.ComposableResource))
    return [_plan_view(p1), w.view()]


def execute_consolidates_and_is_idempotent(tw):
    w = _fragmented(tw)
    planner = w.req_rec.scheduler.defrag
    plan = planner.plan()
    assert len(plan.migrations) == 1
    assert planner.execute(plan) == 1
    w.pump()
    for name in ("r1", "r3"):
        assert _state(w, name) == "Running"
    hosts = {c.spec.target_node for c in w.store.list(tw.types.ComposableResource)
             if not c.being_deleted}
    assert len(hosts) == 1
    assert planner.plan().empty
    return [_plan_view(plan), w.view()]


def never_policy_pins_worker(tw):
    w = RequestWorld(tw, n_nodes=4)
    for name, policy in (("r1", tw.types.PREEMPT_NEVER), ("r3", "")):
        w.request(name, size=2, policy=policy)
        w.run_to_ready(name)
    w.request("r5", size=4, target_node="worker-1")
    w.run_to_ready("r5")
    w.delete("r3")
    w.pump()
    plan = w.req_rec.scheduler.defrag.plan()
    assert plan.empty
    return [_plan_view(plan), w.view()]


def no_churn_migration_off_a_freshly_packed_target(tw):
    w = RequestWorld(tw, n_nodes=4)
    never = tw.types.PREEMPT_NEVER
    for name, policy in (("r1", ""), ("r2", ""), ("r3", ""), ("r4", ""),
                         ("r5", never), ("r6", "")):
        w.request(name, size=2, policy=policy)
        w.run_to_ready(name)
    for name in ("r2", "r4", "r6"):
        w.delete(name)
    w.pump()
    plan = w.req_rec.scheduler.defrag.plan()
    assert len(plan.migrations) == 1
    (m,) = plan.migrations
    assert (m.from_node, m.to_node) == ("worker-0", "worker-1")
    return [_plan_view(plan), w.view()]


def multi_host_members_never_migrate(tw):
    w = RequestWorld(tw, n_nodes=4)
    w.request("gang", size=8)
    w.run_to_ready("gang")
    w.request("single", size=2)
    w.run_to_ready("single")
    plan = w.req_rec.scheduler.defrag.plan()
    assert all(m.request != "gang" for m in plan.migrations)
    return [_plan_view(plan), w.view()]


def explain_records_placement_and_hold_back(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("first", size=4)
    w.run_to_ready("first")
    w.request("second", size=4)
    w.pump(2)
    led = w.req_rec.scheduler.ledger
    docs = [led.explain("first"), led.explain("second")]
    assert docs[0]["latest"]["outcome"] == "placed"
    assert docs[1]["latest"]["outcome"] == "held-back"
    return [decisions_view(d) for d in docs]


SCENARIOS = [
    host_index, tightest_fit_packs_fragmented_host,
    contiguity_tiebreak_prefers_adjacent_window, fragmentation_score,
    full_cluster_is_not_fragmented,
    exactly_full_capacity_admits_one_gang_whole, equal_priority_no_preemption,
    victim_set_is_minimal, fewest_chips_among_equal_cardinality,
    never_policy_protects_victim, never_policy_preemptor_does_not_evict,
    preemption_evicts_lower_priority,
    preempt_clears_placeholder_rows_of_allocating_victim,
    victims_on_quarantined_nodes_not_chosen,
    low_priority_held_back_for_feasible_high_priority,
    scalar_request_cannot_backfill_steal_from_pending_slice,
    grow_onto_contended_host_cannot_slip_the_gate,
    anchored_pending_demand_counts_only_the_delta,
    unsatisfiable_high_priority_does_not_starve_cluster,
    plan_is_pure_and_deterministic, execute_consolidates_and_is_idempotent,
    never_policy_pins_worker, no_churn_migration_off_a_freshly_packed_target,
    multi_host_members_never_migrate, explain_records_placement_and_hold_back,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("field,value", [
    ("priority", 100), ("preemption_policy", "Never")])
def test_spec_fields_round_trip_across_packages(field, value):
    from tests.torch_operator import JAX_ROOT

    specs = []
    for root in (JAX_ROOT, PORT_ROOT):
        t = twin(root).types
        spec = t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(model="tpu-v4", size=4), **{field: value})
        spec.validate()
        specs.append(spec.to_dict())
    assert specs[0] == specs[1]
    back = twin(PORT_ROOT).types.ComposabilityRequestSpec.from_dict(specs[0])
    assert getattr(back, field) == value


@pytest.mark.parametrize("bad", [dict(preemption_policy="Sometimes"),
                                 dict(priority=2_000_000_000)])
def test_invalid_spec_fields_rejected_like_jax(bad):
    from tests.torch_operator import JAX_ROOT

    msgs = []
    for root in (JAX_ROOT, PORT_ROOT):
        t = twin(root).types
        spec = t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(model="tpu-v4", size=4), **bad)
        with pytest.raises(t.ValidationError) as e:
            spec.validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the H100 (port only) -------------------------------------------------------

def _h100_world(n_nodes=2):
    tw = twin(PORT_ROOT)
    return tw, RequestWorld(tw, n_nodes=n_nodes, slots=8,
                            chips={H100: 32, "gpu-a100": 16})


def test_h100_child_holds_its_gpus_on_the_host():
    """A node of 8 GPUs that holds a 4-GPU child has 4 free: the child
    counts chip_count slots, not one (engine, snapshot and native scan
    agree)."""
    with seeded_uuids():
        tw, w = _h100_world(n_nodes=1)
        w.request("four", size=4, model=H100)
        w.run_to_ready("four")
        (child,) = w.children("four")
        assert (child.spec.type, child.spec.chip_count) == ("gpu", 4)
        engine = w.req_rec.scheduler.engine
        used = engine.used_slots_map("")
        assert used == {"worker-0": 4}
        probe = w.request("probe", size=4, model=H100)
        verdicts = engine.candidate_verdicts(probe, 4, set(), used)
        assert verdicts == [{"node": "worker-0", "free": 4, "verdict": "ok"}]
        assert engine.candidate_verdicts(probe, 8, set(), used) == [
            {"node": "worker-0", "free": 4,
             "verdict": "no-tpu-ports free=4 need=8"}]
        assert engine.last_scan_kind == "native"


def test_h100_second_full_host_request_is_refused():
    """A second 8-GPU request on a host whose 8 GPUs are taken is an
    AllocationError naming the shortfall; the host is never overcommitted."""
    with seeded_uuids():
        tw, w = _h100_world(n_nodes=1)
        w.request("a", size=8, model=H100)
        w.run_to_ready("a")
        w.request("b", size=8, model=H100)
        with pytest.raises(tw.placement.AllocationError):
            w.req_rec.reconcile("b")
        assert w.get("b").status.state == ""
        assert not w.children("b")
        assert w.pool.free_chips(H100) == 32 - 8
        used = w.req_rec.scheduler.engine.used_slots_map("")
        assert used == {"worker-0": 8}
        # A 4-GPU request has no room either: 8 + 4 > 8.
        w.request("c", size=4, model=H100)
        with pytest.raises(tw.placement.AllocationError):
            w.req_rec.reconcile("c")


def test_h100_explain_names_the_verdicts():
    with seeded_uuids():
        tw, w = _h100_world(n_nodes=2)
        w.request("a", size=8, model=H100, target_node="worker-0")
        w.run_to_ready("a")
        w.request("b", size=8, model=H100)
        w.run_to_ready("b")
        w.request("c", size=1, model=H100)
        with pytest.raises(tw.placement.AllocationError):
            w.req_rec.reconcile("c")
        led = w.req_rec.scheduler.ledger
        placed = led.explain("b")["latest"]
        assert placed["outcome"] == "placed" and placed["chosen"] == ["worker-1"]
        assert led.explain("b")["engine"] == "native"
        held = led.explain("c")["latest"]
        assert held["outcome"] == "held-back"
        verdicts = {c["node"]: c["verdict"] for c in held["candidates"]}
        assert verdicts == {"worker-0": "no-tpu-ports free=0 need=1",
                            "worker-1": "no-tpu-ports free=0 need=1"}
        assert held["binding"]["resource"] == "tpu-ports"


def test_a100_keeps_the_scalar_path():
    """gpu-a100 (the compat row) is not a chip group: each child holds one
    slot, and a request of 3 makes 3 children."""
    with seeded_uuids():
        tw, w = _h100_world(n_nodes=1)
        w.request("a100", size=3, model="gpu-a100")
        w.run_to_ready("a100")
        kids = w.children("a100")
        assert len(kids) == 3 and all(c.spec.chip_count in (0, 1) for c in kids)
        assert w.req_rec.scheduler.engine.used_slots_map("")["worker-0"] == 3
