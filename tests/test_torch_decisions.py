"""The port's decision observatory — scheduler/ledger.py,
runtime/capacity.py, runtime/goodput.py and the Manager's routes for them —
against the JAX package's (tests/test_decisions.py's and
tests/test_goodput.py's twin).

The same script runs on both packages (``run_both``): the ledger's ring,
collapse, bounds, rate limit and joins; placements, hold-backs and
preemptions through the real reconcilers (``RequestWorld``) with their
records; the 32-chip story of the JAX acceptance test; the capacity
sampler's arithmetic; the goodput phase clock on an injected clock. Each
package's ``/debug/scheduler/explain/<name>``, ``/debug/scheduler/capacity``,
``/debug/goodput`` and ``/debug/defrag`` are read through a Manager's
health port, with the same 503 bodies when absent. Compared exactly;
masked: uid, timestamps, intent nonces, trace ids, and each record's
clock (``at``), sequence number (a per-process counter), decision id and
the engine layer that made it (the port runs its own native kernel, the
JAX package ``py_scan`` where its native library is not built).
Tolerance: exact, except the goodput ratios (``pytest.approx``'s
default, as the JAX tests). Left for later sub-slices: the SLO engine's
annotator and goodput objective, the fleet merge, the ``explain`` CLI.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import (
    JAX_ROOT,
    PORT_ROOT,
    RequestWorld,
    run_both,
    seeded_uuids,
    twin,
)

torch.set_num_threads(1)

REQ = "ComposabilityRequest"
RES = "ComposableResource"


def rec_view(r):
    """One record doc without its clock, sequence, id and engine layer."""
    r = {k: v for k, v in r.items() if k not in ("at", "seq", "decision_id")}
    if "inputs" in r:
        r["inputs"] = {k: v for k, v in r["inputs"].items() if k != "engine"}
    return r


def explain_view(doc):
    if doc is None:
        return None
    return dict(request=doc["request"], latest=rec_view(doc["latest"]),
                decisions=[rec_view(d) for d in doc["decisions"]])


def _rec(tw, request="r", kind=None, outcome=None, summary="s", **kw):
    led = tw.ledger
    return led.DecisionRecord(request=request, kind=kind or led.KIND_PLACE,
                              outcome=outcome or led.OUTCOME_PLACED,
                              summary=summary, **kw)


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- ledger mechanics -----------------------------------------------------------

def fresh_records_append_and_get_ids(tw):
    led = tw.ledger.DecisionLedger()
    a = led.record(_rec(tw, summary="first"))
    b = led.record(_rec(tw, summary="second"))
    assert a.decision_id and b.decision_id and a.decision_id != b.decision_id
    assert b.seq > a.seq
    return explain_view(led.explain("r"))


def identical_repeats_collapse(tw):
    recorder = tw.events.EventRecorder()
    led = tw.ledger.DecisionLedger(recorder=recorder)
    for _ in range(5):
        led.record(_rec(tw, outcome=tw.ledger.OUTCOME_HELD_BACK,
                        summary="held back: need 2 hosts",
                        binding={"resource": "tpu-ports"}))
    first = explain_view(led.explain("r"))
    assert first["latest"]["repeats"] == 5
    led.record(_rec(tw, summary="placed on worker-0"))
    return [first, explain_view(led.explain("r")),
            [(e.reason, e.message) for e in recorder.all()]]


def ring_and_object_bounds(tw):
    led = tw.ledger.DecisionLedger(per_object=4, max_objects=3)
    for i in range(10):
        led.record(_rec(tw, summary=f"s{i}"))
    ring = explain_view(led.explain("r"))
    for i in range(5):
        led.record(_rec(tw, request=f"other-{i}", summary="x"))
    assert len(ring["decisions"]) == 4 and len(led.names()) <= 3
    return [ring, sorted(led.names())]


def bump_if_recent_rate_limits_without_sliding(tw):
    L = tw.ledger
    led = L.DecisionLedger()
    led.record(_rec(tw, outcome=L.OUTCOME_HELD_BACK, summary="h",
                    binding={"resource": "tpu-ports"}))
    first = led.latest("r")
    anchor = first.mono
    out = [led.bump_if_recent("r", L.KIND_PLACE, L.OUTCOME_HELD_BACK,
                              exclude_resources=("backfill-gate",
                                                 "fabric-reservation"))
           is first, first.repeats, first.mono == anchor,
           led.bump_if_recent("r", L.KIND_PLACE, L.OUTCOME_HELD_BACK,
                              resource="backfill-gate") is None,
           led.bump_if_recent("r", L.KIND_PLACE, L.OUTCOME_HELD_BACK,
                              within_s=0.0) is None]
    assert out == [True, 2, True, True, True]
    return out


def dominant_hold_back_reason(tw):
    L = tw.ledger
    led = L.DecisionLedger()
    for i in range(3):
        led.record(_rec(tw, outcome=L.OUTCOME_HELD_BACK, summary=f"a{i}",
                        binding={"resource": "tpu-ports"}))
    led.record(_rec(tw, outcome=L.OUTCOME_HELD_BACK, summary="b",
                    binding={"resource": "backfill-gate"}))
    reason = led.dominant_hold_back_reason()
    assert reason.startswith("tpu-ports")
    return reason


def latest_placed_skips_holds(tw):
    L = tw.ledger
    led = L.DecisionLedger()
    led.record(_rec(tw, summary="placed", chosen=["w0"]))
    led.record(_rec(tw, outcome=L.OUTCOME_HELD_BACK, summary="h",
                    binding={"resource": "tpu-ports"}))
    assert led.latest_placed("r").chosen == ["w0"]
    return explain_view(led.explain("r"))


def link_decision_records_nonce_and_consumes_flow(tw):
    led = tw.ledger.DecisionLedger()
    ctx = tw.tracing.new_trace("d-test")
    with tw.tracing.span("scheduler.decide", cat="scheduler"):
        flows = [ctx.handoff()]
    rec = _rec(tw, summary="placed", chosen=["w0"])
    rec.flows = flows
    led.record(rec)
    assert led.link_decision("r", "nonce-1") == rec.decision_id
    assert rec.nonces == ["nonce-1"] and rec.flows == []
    assert led.link_decision("ghost", "n") == ""
    return rec.nonces


# -- decisions through the real reconcilers ------------------------------------------

def placed_record_matches_execution_and_joins_intents(tw):
    w = RequestWorld(tw, n_nodes=4)
    led = w.req_rec.scheduler.ledger
    w.request("gang", size=8)
    w.run_to_ready("gang")
    rec = led.latest_placed("gang")
    assert rec.kind == "place"
    assert sorted(rec.chosen) == sorted(w.get("gang").status.slice.worker_hostnames)
    assert rec.demand == {"num_hosts": 2, "chips_per_host": 4}
    assert "tightest-fit" in rec.tiebreak
    assert rec.inputs["schedulable_hosts"] == 4 and rec.inputs["free_chips"] == 16
    assert len(rec.nonces) == 2
    spans = [e for e in tw.tracing.trace_events(rec.decision_id)
             if e.get("ph") == "X"]
    assert any(e["name"] == "scheduler.decide" for e in spans)
    return [rec_view(rec.to_doc()), w.view()]


def hold_back_names_binding_resource(tw):
    w = RequestWorld(tw, n_nodes=2)
    led = w.req_rec.scheduler.ledger
    never = tw.types.PREEMPT_NEVER
    w.request("occupant-0", size=4, target_node="worker-0", policy=never)
    w.request("occupant-1", size=4, target_node="worker-1", policy=never)
    for n in ("occupant-0", "occupant-1"):
        w.run_to_ready(n)
    held = tw.metrics.scheduler_held_back_total
    before = held.value(reason="tpu-ports")
    w.request("starved", size=8)
    w.pump(3)
    rec = led.latest("starved")
    assert rec.outcome == "held-back"
    assert rec.binding["resource"] == "tpu-ports"
    assert (rec.binding["fitting_hosts"], rec.binding["short_hosts"]) == (0, 2)
    assert held.value(reason="tpu-ports") > before
    return [rec_view(rec.to_doc()), w.view()]


def preempt_record_carries_minimality_rationale(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("batch", size=4)
    w.run_to_ready("batch")
    w.request("urgent", size=4, priority=10)
    w.pump(2)
    doc = w.req_rec.scheduler.ledger.explain("urgent")
    rec = next(r for r in reversed(doc["decisions"])
               if r["outcome"] == "preempting")
    assert rec["victims"] == ["batch"]
    assert "exhaustive" in rec["victim_rationale"]
    return explain_view(doc)


def gate_hold_back_names_protected_request(tw):
    t = tw.types
    w = RequestWorld(tw, n_nodes=1)
    w.request("occupant", size=4, policy=t.PREEMPT_NEVER)
    w.run_to_ready("occupant")
    w.request("hp", size=4, priority=50)
    w.pump(3)
    w.delete("occupant")
    for _ in range(20):
        try:
            w.req_rec.reconcile("occupant")
        except tw.provider.FabricError:
            pass
        for c in w.store.list(t.ComposableResource):
            try:
                w.res_rec.reconcile(c.metadata.name)
            except tw.provider.FabricError:
                pass
        if w.get("occupant") is None:
            break
    w.request("lp", size=4)
    with pytest.raises(Exception):
        w.req_rec.reconcile("lp")
    rec = w.req_rec.scheduler.ledger.latest("lp")
    assert rec.binding["resource"] == "backfill-gate"
    assert rec.binding["protecting"] == "hp"
    return rec_view(rec.to_doc())


def queued_and_placed_events_ride_the_recorder(tw):
    w = RequestWorld(tw, n_nodes=1)
    w.request("occ", size=4, policy=tw.types.PREEMPT_NEVER)
    w.run_to_ready("occ")
    w.request("waiting", size=4)
    w.pump(3)
    ev = {n: [(e.reason, e.message) for e in w.req_rec.recorder.for_object(
        kind=REQ, name=n)] for n in ("waiting", "occ")}
    assert "Queued" in {r for r, _ in ev["waiting"]}
    assert "Placed" in {r for r, _ in ev["occ"]}
    return ev


def disabled_ledger_constructs_nothing(tw):
    sched = tw.sched.ClusterScheduler(tw.store.Store(), decisions=False)
    assert sched.ledger is None and sched.defrag.decision_ledger is None
    return True


def _story(tw):
    w = RequestWorld(tw, n_nodes=8, chips={"tpu-v4": 32})
    for i in range(6):
        w.request(f"batch-{i}", size=4, target_node=f"worker-{i}")
    w.request("frag", size=2, target_node="worker-6")
    for i in range(6):
        w.run_to_ready(f"batch-{i}")
    w.run_to_ready("frag")
    w.request("inference", size=8, priority=100)
    w.pump(40)
    w.run_to_ready("inference")
    w.request("starved", size=8)
    w.pump(3)
    return w


def every_decision_has_a_record_and_endpoint_serves_it(tw):
    w = _story(tw)
    led = w.req_rec.scheduler.ledger
    for r in w.store.list(tw.types.ComposabilityRequest):
        if r.status.state == "Running":
            rec = led.latest_placed(r.name)
            assert sorted(rec.chosen) == sorted(r.status.slice.worker_hostnames)
    pre = [d for d in led.explain("inference")["decisions"]
           if d["outcome"] == "preempting"]
    assert pre and pre[0]["victims"] == ["frag"]
    hold = led.latest("starved")
    assert hold.binding["resource"] == "tpu-ports"
    mgr = tw.manager.Manager(store=w.store, health_addr="127.0.0.1:0",
                             decisions=led)
    mgr.start()
    try:
        port = mgr.health_port
        code, doc = _get(port, "/debug/scheduler/explain/starved")
        assert code == 200 and doc["latest"]["outcome"] == "held-back"
        ghost = _get(port, "/debug/scheduler/explain/ghost")
        assert ghost[0] == 404
        code, idx = _get(port, "/debug")
        assert "/debug/scheduler/explain/<name>" in idx["endpoints"]
        served = {n: explain_view(_get(port, f"/debug/scheduler/explain/{n}")[1])
                  for n in ("inference", "frag", "starved", "batch-0")}
    finally:
        mgr.stop()
    return [served, ghost, w.view()]


# -- capacity ---------------------------------------------------------------------

def largest_placeable_slice_arithmetic(tw):
    lps = tw.capacity.largest_placeable_slice
    out = [lps({}), lps({"a": 0, "b": 0}), lps({"a": 4}),
           lps({"a": 4, "b": 4, "c": 2, "d": 1}), lps({"a": 3, "b": 3, "c": 3})]
    assert out == [0, 0, 4, 8, 9]
    return out


def sampler_sets_gauges_and_ring(tw):
    w = RequestWorld(tw, n_nodes=4)
    w.request("half", size=8)
    w.run_to_ready("half")
    obs = tw.capacity.CapacityObservatory(w.store, w.req_rec.scheduler.engine,
                                          period=1.0, ring=8)
    sample = obs.sample()
    assert sample["free_chips"] == 8 and sample["largest_slice_chips"] == 8
    assert sample["hosts_by_free"] == {"0": 2, "4": 2}
    assert tw.metrics.capacity_free_chips.value() == 8.0
    snap = obs.snapshot()
    assert len(snap["timeline"]) == 1
    drop = ("at", "t", "ts", "mono")
    return {k: v for k, v in snap["latest"].items() if k not in drop}


# -- goodput ----------------------------------------------------------------------

def degrade_repair_recover_matches_phase_clock(tw):
    t = tw.goodput.GoodputTracker(now=lambda: 0.0)
    t.observe(REQ, "job", "", now=0.0)
    t.observe(REQ, "job", "Updating", now=3.0)
    t.observe(REQ, "job", "Running", now=5.0)
    t.observe(RES, "job-m0", "Degraded", owner="job", now=10.0)
    t.observe(RES, "job-m0", "Repairing", owner="job", now=12.0)
    t.observe(RES, "job-m0", "Online", owner="job", now=15.0)
    t.observe(REQ, "job", "Cleaning", now=20.0)
    view = t.request_view("job", now=20.0)
    assert view["seconds"] == {"queued": 3.0, "provisioning": 2.0,
                               "ready": 10.0, "degraded": 2.0,
                               "repairing": 3.0}
    assert view["goodput_ratio"] == pytest.approx(0.5)
    assert t.counts(now=100.0) == t.counts(now=20.0)
    return [view, t.counts(now=20.0), t.snapshot(now=20.0)]


def worst_impairment_wins_and_recovery_restores_ready(tw):
    t = tw.goodput.GoodputTracker(now=lambda: 0.0)
    t.observe(REQ, "job", "Running", now=0.0)
    t.observe(RES, "m0", "Degraded", owner="job", now=2.0)
    t.observe(RES, "m1", "Repairing", owner="job", now=4.0)
    t.observe(RES, "m1", "Online", owner="job", now=7.0)
    t.observe(RES, "m0", "Online", owner="job", now=9.0)
    view = t.request_view("job", now=10.0)
    assert view["seconds"] == {"ready": 3.0, "degraded": 4.0, "repairing": 3.0}
    return view


def migrating_member_counts_as_lost(tw):
    t = tw.goodput.GoodputTracker(now=lambda: 0.0)
    t.observe(REQ, "job", "Running", now=0.0)
    t.observe(RES, "m0", "Migrating", owner="job", now=5.0)
    t.observe(RES, "m0", "Online", owner="job", now=8.0)
    view = t.request_view("job", now=10.0)
    assert view["seconds"]["migrating"] == pytest.approx(3.0)
    return view


def deleted_request_retires_into_process_totals(tw):
    t = tw.goodput.GoodputTracker(now=lambda: 0.0)
    t.observe(REQ, "job", "Running", now=0.0)
    t.observe(REQ, "job", "(deleted)", now=4.0)
    assert t.names() == []
    assert t.ratio(now=10.0) == pytest.approx(1.0)
    return [t.counts(now=10.0), t.ratio(now=10.0)]


def counts_monotonic_and_gauge_level_set(tw):
    t = tw.goodput.GoodputTracker(now=lambda: 0.0)
    t.observe(REQ, "job", "", now=0.0)
    a, b = t.counts(now=1.0), t.counts(now=2.0)
    assert b[0] > a[0] and b[1] > a[1]
    g = tw.goodput.GoodputTracker(now=lambda: 0.0)
    g.observe(REQ, "job", "Running", now=0.0)
    g.set_gauges(now=10.0)
    assert tw.metrics.goodput_ratio.value() == pytest.approx(1.0)
    return [a, b, tw.metrics.goodput_ratio.value()]


SCENARIOS = [
    fresh_records_append_and_get_ids, identical_repeats_collapse,
    ring_and_object_bounds, bump_if_recent_rate_limits_without_sliding,
    dominant_hold_back_reason, latest_placed_skips_holds,
    link_decision_records_nonce_and_consumes_flow,
    placed_record_matches_execution_and_joins_intents,
    hold_back_names_binding_resource,
    preempt_record_carries_minimality_rationale,
    gate_hold_back_names_protected_request,
    queued_and_placed_events_ride_the_recorder,
    disabled_ledger_constructs_nothing,
    every_decision_has_a_record_and_endpoint_serves_it,
    largest_placeable_slice_arithmetic, sampler_sets_gauges_and_ring,
    degrade_repair_recover_matches_phase_clock,
    worst_impairment_wins_and_recovery_restores_ready,
    migrating_member_counts_as_lost,
    deleted_request_retires_into_process_totals,
    counts_monotonic_and_gauge_level_set,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_dump_round_trip_and_env_file(tmp_path, monkeypatch):
    docs = []
    for root in (JAX_ROOT, PORT_ROOT):
        tw = twin(root)
        led = tw.ledger.DecisionLedger()
        led.record(_rec(tw, summary="placed on worker-1", chosen=["worker-1"],
                        tiebreak="tightest-fit"))
        path = str(tmp_path / f"{root}.json")
        assert led.dump(path) == path
        doc = json.loads(open(path).read())
        docs.append([rec_view(r) for r in doc["requests"]["r"]])
        env_path = str(tmp_path / f"{root}-ring.json")
        monkeypatch.setenv("TPUC_DECISIONS_FILE", env_path)
        assert tw.ledger.dump_file() == env_path
        assert "worker-1" in open(env_path).read()
        tw.ledger.deactivate(led)
        assert tw.ledger.dump_file() is None
    assert docs[0] == docs[1]
    assert docs[1][0]["chosen"] == ["worker-1"]


def _served(root, route, **mgr_kw):
    tw = twin(root)
    mgr = tw.manager.Manager(store=tw.store.Store(), health_addr="127.0.0.1:0",
                             **mgr_kw)
    mgr.start()
    try:
        return _get(mgr.health_port, route)
    finally:
        mgr.stop()


@pytest.mark.parametrize("route", [
    "/debug/scheduler/explain/x", "/debug/scheduler/capacity",
    "/debug/goodput", "/debug/defrag"])
def test_routes_answer_503_like_jax_when_absent(route):
    jax_resp, port_resp = (_served(r, route) for r in (JAX_ROOT, PORT_ROOT))
    assert port_resp == jax_resp
    assert port_resp[0] == 503


def test_capacity_route_serves_the_sampler():
    out = []
    for root in (JAX_ROOT, PORT_ROOT):
        tw = twin(root)
        with seeded_uuids():
            w = RequestWorld(tw, n_nodes=2)
            obs = tw.capacity.CapacityObservatory(w.store,
                                                  w.req_rec.scheduler.engine)
            obs.sample()
            mgr = tw.manager.Manager(store=w.store, health_addr="127.0.0.1:0",
                                     capacity=obs)
            mgr.start()
            try:
                code, doc = _get(mgr.health_port, "/debug/scheduler/capacity")
            finally:
                mgr.stop()
        assert code == 200
        out.append((doc["latest"]["free_chips"],
                    doc["latest"]["largest_slice_chips"]))
    assert out[0] == out[1] == (8, 8)


def test_defrag_route_serves_the_loop_report():
    out = []
    for root in (JAX_ROOT, PORT_ROOT):
        tw = twin(root)
        with seeded_uuids():
            w = RequestWorld(tw, n_nodes=4)
            for name in ("r1", "r2", "r3", "r4"):
                w.request(name, size=2)
                w.run_to_ready(name)
            w.delete("r2")
            w.delete("r4")
            w.pump()
            loop = tw.defrag.DefragLoop(w.store, w.req_rec.scheduler.defrag,
                                        period=3600)
            mgr = tw.manager.Manager(store=w.store, health_addr="127.0.0.1:0",
                                     defrag=loop)
            mgr.start()
            try:
                code, doc = _get(mgr.health_port, "/debug/defrag")
            finally:
                mgr.stop()
        assert code == 200
        out.append({k: v for k, v in doc.items() if k != "engine"})
    assert out[0] == out[1] and len(out[1]["dry_run"]["migrations"]) == 1


def test_goodput_route_and_stop_unregisters_sink():
    out = []
    for root in (JAX_ROOT, PORT_ROOT):
        tw = twin(root)
        tracker = tw.goodput.GoodputTracker(now=lambda: 10.0)
        tracker.observe(REQ, "job", "Running", now=0.0)
        tw.lifecycle.add_transition_sink(tracker.observe)
        mgr = tw.manager.Manager(store=tw.store.Store(),
                                 health_addr="127.0.0.1:0", goodput=tracker)
        mgr.start()
        try:
            code, doc = _get(mgr.health_port, "/debug/goodput")
        finally:
            mgr.stop()
        assert all(getattr(s, "__self__", None) is not tracker
                   for s in tw.lifecycle._transition_sinks)
        assert code == 200 and doc["ratio"] == pytest.approx(1.0)
        out.append(doc)
    assert out[0] == out[1]
    assert out[1]["requests"]["job"]["category"] == "ready"


def test_lifecycle_watch_feeds_the_ports_tracker():
    """On the port's real reconcilers, its lifecycle watch feeds its own
    goodput tracker (each package keeps its own sink list)."""
    tw = twin(PORT_ROOT)
    w = RequestWorld(tw, n_nodes=2)
    tracker = tw.goodput.GoodputTracker()
    tw.lifecycle.add_transition_sink(tracker.observe)
    stop = threading.Event()
    watcher = threading.Thread(target=tw.lifecycle.watch_runnable(w.store),
                               args=(stop,), daemon=True)
    watcher.start()
    try:
        w.request("job", size=4)
        w.run_to_ready("job")
        for _ in range(250):
            view = tracker.request_view("job")
            if view is not None and view["category"] == "ready":
                break
            threading.Event().wait(0.02)
        assert tracker.request_view("job")["category"] == "ready"
        assert tracker.counts()[0] > 0
        assert tracker.observe not in twin(JAX_ROOT).lifecycle._transition_sinks
    finally:
        stop.set()
        watcher.join(timeout=5)
        tw.lifecycle.remove_transition_sink(tracker.observe)
