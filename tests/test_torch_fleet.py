"""The port's fleet observatory against the JAX package's
(tests/test_fleet.py's twin): the metric merge primitives, the
publisher/aggregator plane (process-token dedup, the bucket-schema
guard, staleness on the observation clock, the store-blip and outage
paths, GC and the dump), fleet SLO parity, trace stitching, and the
``/debug/fleet`` endpoint with the Manager's wiring.

Each scenario runs once per package (``run_both``) on injected
monotonic ``now`` values and returns the deterministic part of what the
reference asserts on: counts, sums, percentiles, burn rates, the
gauges, and the fleet view without the fields that read process-wide
state (the local SLO engine, the GIL gauge, the profiler's top frames)
or the wall clock (``published_at``). The reference's invariants are
asserted on the way. Tolerance: exact.

Cross-package cases: each package's payload for the same observations
is the same, and a port aggregator merges a JAX replica's snapshot
(equal bucket schemas) into the burn rate the JAX aggregator computes.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)

BUCKETS = (0.1, 0.5, 1.0, 5.0)
#: View fields that read process-wide state or the wall clock.
_NOISY = ("published_at", "slo", "gil", "profiler_top")


def core(view: dict) -> dict:
    """The fleet view without the fields two runs cannot share."""
    out = {k: v for k, v in view.items() if k != "replicas"}
    out["replicas"] = {
        ident: {k: v for k, v in rep.items() if k not in _NOISY}
        for ident, rep in view.get("replicas", {}).items()}
    return out


# ----------------------------------------------------------------------
# Histogram.merge / Counter.merge primitives
# ----------------------------------------------------------------------
def histogram_merge_preserves_sum_count_and_inf(tw):
    H = tw.metrics.Histogram
    a, b = H("a", buckets=BUCKETS), H("b", buckets=BUCKETS)
    for v in (0.05, 0.3, 0.7):
        a.observe(v, type="tpu")
    for v in (0.2, 2.0, 99.0):
        b.observe(v, type="tpu")
    b.observe(0.4, type="gpu")
    merged = H("m", buckets=BUCKETS)
    merged.merge(a)
    merged.merge(b)
    assert merged.total_count() == a.total_count() + b.total_count() == 7
    assert merged.count(type="tpu") == 6 and merged.count(type="gpu") == 1
    assert merged.sum(type="tpu") == pytest.approx(
        a.sum(type="tpu") + b.sum(type="tpu"))
    text = "\n".join(merged.expose())
    assert 'le="+Inf"} 6' in text
    assert merged.total_count_le(5.0) == pytest.approx(6.0)
    return {"expose": text, "state": merged.state(),
            "le5": merged.total_count_le(5.0)}


def histogram_merge_accepts_serialized_state(tw):
    H = tw.metrics.Histogram
    a = H("a", buckets=BUCKETS)
    a.observe(0.3, verb="add")
    state = json.loads(json.dumps(a.state()))
    merged = H("m", buckets=BUCKETS)
    merged.merge(state)
    assert merged.count(verb="add") == 1
    assert merged.sum(verb="add") == pytest.approx(0.3)
    return state


def histogram_merge_bucket_schema_guard(tw):
    H = tw.metrics.Histogram
    a = H("a", buckets=(0.1, 1.0))
    a.observe(0.05)
    merged = H("m", buckets=BUCKETS)
    errors = []
    with pytest.raises(ValueError, match="bucket schema mismatch") as e1:
        merged.merge(a)
    errors.append(str(e1.value))
    bad = {"buckets": list(BUCKETS), "series": [[{}, [1, 2], 0.1]]}
    with pytest.raises(ValueError, match="malformed bucket counts") as e2:
        merged.merge(bad)
    errors.append(str(e2.value))
    assert merged.total_count() == 0
    return errors


def counter_merge_sums_label_sets(tw):
    C = tw.metrics.Counter
    a = C("a")
    a.inc(2, verb="add")
    b = C("b")
    b.inc(3, verb="add")
    b.inc(1, verb="remove")
    merged = C("m")
    merged.merge(a)
    merged.merge(json.loads(json.dumps(b.state())))
    out = [merged.value(verb="add"), merged.value(verb="remove"),
           merged.total()]
    assert out == [5, 1, 6]
    return out


# ----------------------------------------------------------------------
# publisher / aggregator plane
# ----------------------------------------------------------------------
def _plane(tw, store, ident, hist, token, **kw):
    kw.setdefault("publish_period", 0.5)
    kw.setdefault("stale_after_s", 2.0)
    return tw.fleet.FleetPlane(
        store, ident, histograms={"tpuc_attach_to_ready_seconds": hist},
        process_token=token, **kw)


def publish_and_aggregate_two_replicas(tw):
    m = tw.metrics
    store = tw.store.Store()
    ha, hb = m.Histogram("ha"), m.Histogram("hb")
    a = _plane(tw, store, "rep-a", ha, "proc-a")
    b = _plane(tw, store, "rep-b", hb, "proc-b")
    ha.observe(0.2, type="tpu")
    hb.observe(0.4, type="tpu")
    assert a.publish() and b.publish()
    view = a.aggregate(now=100.0)
    assert set(view["replicas"]) == {"rep-a", "rep-b"}
    merged = view["merged"]["tpuc_attach_to_ready_seconds"]
    assert merged["count"] == 2 and merged["p99_s"] is not None
    assert m.fleet_replicas.value() == 2.0
    assert m.fleet_replica_shards.value(replica="rep-a") == 0.0
    return core(view)


def process_token_dedup_never_double_counts(tw):
    store = tw.store.Store()
    shared = tw.metrics.Histogram("shared")
    shared.observe(0.2)
    a = _plane(tw, store, "rep-a", shared, "proc-shared")
    b = _plane(tw, store, "rep-b", shared, "proc-shared")
    assert a.publish() and b.publish()
    view = a.aggregate(now=100.0)
    assert view["merged"]["tpuc_attach_to_ready_seconds"]["count"] == 1
    assert set(view["replicas"]) == {"rep-a", "rep-b"}
    return core(view)


def schema_mismatch_excludes_contributor_loudly(tw):
    H = tw.metrics.Histogram
    store = tw.store.Store()
    ha, hb = H("ha"), H("hb", buckets=(0.1, 1.0))
    a = _plane(tw, store, "rep-a", ha, "proc-a")
    b = _plane(tw, store, "rep-b", hb, "proc-b")
    ha.observe(0.2)
    hb.observe(0.2)
    assert a.publish() and b.publish()
    view = a.aggregate(now=100.0)
    assert view["merged"]["tpuc_attach_to_ready_seconds"]["count"] == 1
    return core(view)


def dead_replica_ages_out_and_label_sets_level_set(tw):
    m = tw.metrics
    store = tw.store.Store()
    ha, hb = m.Histogram("ha"), m.Histogram("hb")
    a = _plane(tw, store, "rep-a", ha, "proc-a", stale_after_s=2.0)
    b = _plane(tw, store, "rep-b", hb, "proc-b", stale_after_s=2.0)
    hb.observe(60.0)
    assert a.publish() and b.publish()
    views = [core(a.aggregate(now=100.0))]
    assert views[0]["merged"]["tpuc_attach_to_ready_seconds"]["count"] == 1
    assert m.fleet_replicas.value() == 2.0
    for now in (100.5, 101.0, 101.5):
        a.publish()
        view = a.aggregate(now=now)
        assert view["replicas"]["rep-b"]["stale"] is False
        views.append(core(view))
    a.publish()
    view = a.aggregate(now=103.5)
    assert view["replicas"]["rep-b"]["stale"] is True
    assert view["merged"]["tpuc_attach_to_ready_seconds"]["count"] == 0
    assert m.fleet_replicas.value() == 1.0
    assert {"replica": "rep-b"} not in m.fleet_replica_shards.label_sets()
    views.append(core(view))
    b.publish()
    view = a.aggregate(now=104.0)
    assert view["replicas"]["rep-b"]["stale"] is False
    assert m.fleet_replicas.value() == 2.0
    views.append(core(view))
    return views


def store_blip_does_not_reset_staleness_clocks(tw):
    store = tw.store.Store()
    H = tw.metrics.Histogram
    ha, hb = H("ha"), H("hb")
    a = _plane(tw, store, "rep-a", ha, "proc-a", stale_after_s=2.0)
    b = _plane(tw, store, "rep-b", hb, "proc-b", stale_after_s=2.0)
    hb.observe(60.0)
    assert a.publish() and b.publish()
    a.aggregate(now=100.0)
    real_list = store.list
    store.list = lambda *args, **kw: (_ for _ in ()).throw(
        tw.store.StoreError("blip"))
    blip = a.aggregate(now=101.0)
    assert set(blip["replicas"]) == {"rep-a", "rep-b"}
    store.list = real_list
    a.publish()
    view = a.aggregate(now=103.0)
    assert view["replicas"]["rep-b"]["stale"] is True
    assert view["merged"]["tpuc_attach_to_ready_seconds"]["count"] == 0
    return [core(blip), core(view)]


def long_dead_snapshot_gcd_from_store(tw):
    store = tw.store.Store()
    H = tw.metrics.Histogram
    a = _plane(tw, store, "rep-a", H("ha"), "proc-a", stale_after_s=1.0)
    b = _plane(tw, store, "rep-b", H("hb"), "proc-b", stale_after_s=1.0)
    assert a.publish() and b.publish()
    a.aggregate(now=100.0)
    a.aggregate(now=120.0)
    names = sorted(o.metadata.name
                   for o in store.list(tw.fleet_api.FleetTelemetry))
    assert "telemetry.rep-b" not in names and "telemetry.rep-a" in names
    return names


def own_view_survives_store_outage(tw):
    StoreError = tw.store.StoreError

    class DeadStore:
        def try_get(self, *a, **k):
            raise StoreError("dark")

        create = update = try_get

        def list(self, *a, **k):
            raise StoreError("dark")

        def delete(self, *a, **k):
            raise AssertionError("unused")

    plane = _plane(tw, DeadStore(), "rep-a", tw.metrics.Histogram("h"),
                   "proc-a")
    assert plane.publish() is False
    view = plane.aggregate(now=100.0)
    assert "rep-a" in view["replicas"]
    return core(view)


def dump_file(tw, tmp_path):
    store = tw.store.Store()
    plane = _plane(tw, store, "rep-a", tw.metrics.Histogram("h"), "proc-a")
    plane.tick(now=100.0)
    saved = tw.fleet._active
    tw.fleet._active = plane
    path = tmp_path / f"fleet-{tw.root}.json"
    try:
        assert tw.fleet.dump_file(str(path)) == str(path)
    finally:
        tw.fleet._active = saved
    doc = json.loads(path.read_text())
    assert doc["identity"] == "rep-a" and "rep-a" in doc["replicas"]
    return core(doc)


# ----------------------------------------------------------------------
# fleet SLO parity (acceptance)
# ----------------------------------------------------------------------
def merged_burn_equals_single_replica_burn(tw):
    H = tw.metrics.Histogram
    wave = [0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.5, 2.0, 6.0,
            7.0, 0.25, 0.35, 0.15, 0.45, 5.5]
    threshold, target = 5.0, 0.75
    solo = H("solo")
    solo_engine = tw.slo.SloEngine(
        objectives=[tw.slo.Objective("attach_p99", solo, threshold, target)],
        fast_window=60.0, slow_window=600.0)
    solo_engine.evaluate(now=0.0)
    for v in wave:
        solo.observe(v, type="tpu")
    solo_engine.evaluate(now=30.0)
    solo_burn, _ = solo_engine.burn_rates("attach_p99")

    store = tw.store.Store()
    ha, hb = H("ha"), H("hb")
    a = tw.fleet.FleetPlane(
        store, "rep-a", publish_period=0.5,
        histograms={"tpuc_attach_to_ready_seconds": ha},
        process_token="proc-a", attach_p99_s=threshold, queue_p99_s=0.0,
        fast_window=60.0, slow_window=600.0)
    b = tw.fleet.FleetPlane(
        store, "rep-b", publish_period=0.5,
        histograms={"tpuc_attach_to_ready_seconds": hb},
        process_token="proc-b")
    a.slo.objectives[0].target = target
    a.publish(), b.publish()
    a.aggregate(now=0.0)
    for i, v in enumerate(wave):
        (ha if i % 2 == 0 else hb).observe(v, type="tpu")
    a.publish(), b.publish()
    a.aggregate(now=30.0)
    fleet_burn, _ = a.slo.burn_rates("fleet_attach_p99")
    assert solo_burn > 0
    assert fleet_burn == pytest.approx(solo_burn, rel=1e-6)
    view = a.snapshot()
    fleet_p99 = view["merged"]["tpuc_attach_to_ready_seconds"]["p99_s"]
    exact_p99 = solo.percentile(0.99, type="tpu")
    hi = next(b_ for b_ in solo.buckets if b_ >= exact_p99)
    lo = max([b_ for b_ in solo.buckets if b_ < exact_p99], default=0.0)
    assert lo <= fleet_p99 <= hi
    return {"solo_burn": solo_burn, "fleet_burn": fleet_burn,
            "fleet_p99": fleet_p99, "exact_p99": exact_p99}


# ----------------------------------------------------------------------
# trace stitching
# ----------------------------------------------------------------------
def _traced(fn):
    """Run ``fn(tw, tracing)`` between the reference's setup and teardown
    of the package's trace ring and replica binding."""

    def scenario(tw):
        tracing = tw.tracing
        tracing.reset()
        try:
            return fn(tw, tracing)
        finally:
            tracing.reset()
            tracing.set_replica(None)
            if hasattr(tracing._tls, "replica"):
                del tracing._tls.replica

    scenario.__name__ = fn.__name__
    return scenario


@_traced
def replica_pid_is_stable_and_named(tw, tracing):
    pid = tracing.replica_pid("rep-a")
    assert pid == tracing.replica_pid("rep-a")
    assert pid != tracing.replica_pid("rep-b")
    tracing.bind_thread("rep-a")
    with tracing.span("work", cat="t"):
        pass
    evt = tracing.snapshot()[-1]
    assert evt["pid"] == pid
    doc = json.loads(tracing.export_chrome())
    names = [e for e in doc["traceEvents"] if e.get("name") == "process_name"]
    assert any(e["args"]["name"] == "rep-a" for e in names)
    assert doc["metadata"]["epoch_us"] > 0
    return {"pid": pid, "names": sorted(e["args"]["name"] for e in names)}


@_traced
def merge_stitches_nonce_across_pids(tw, tracing):
    tracing.bind_thread("rep-a")
    with tracing.span("reconcile", cat="controller", trace_id="nonce-1"):
        pass
    doc_a = json.loads(tracing.export_chrome())
    tracing.reset()
    tracing.bind_thread("rep-b")
    with tracing.span("adopt", cat="adoption", trace_id="nonce-1"):
        pass
    doc_b = json.loads(tracing.export_chrome())
    merged = tracing.merge_chrome([doc_a, doc_b])
    assert merged["metadata"]["stitched_flows"] == 1
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert len({e["pid"] for e in spans}) == 2
    flows = [e for e in merged["traceEvents"]
             if e.get("ph") in ("s", "f") and e["args"].get("stitched")]
    assert len(flows) == 2
    s, f = sorted(flows, key=lambda e: e["ph"], reverse=True)
    assert s["ph"] == "s" and f["ph"] == "f" and s["id"] == f["id"]
    assert s["pid"] != f["pid"]
    assert s["args"]["trace_id"] == f["args"]["trace_id"] == "nonce-1"
    return {"stitched": merged["metadata"]["stitched_flows"],
            "pids": sorted({e["pid"] for e in spans}),
            "flows": sorted((e["ph"], e["pid"]) for e in flows)}


@_traced
def merge_keeps_same_identity_pid_across_incarnations(tw, tracing):
    tracing.bind_thread("rep-a")
    with tracing.span("before-crash", cat="t", trace_id="n1"):
        pass
    doc_a = json.loads(tracing.export_chrome())
    tracing.reset()
    with tracing.span("after-restart", cat="t", trace_id="n1"):
        pass
    doc_b = json.loads(tracing.export_chrome())
    saved = dict(tracing._pid_names)
    tracing._pid_names.clear()
    try:
        merged = tracing.merge_chrome([doc_a, doc_b])
    finally:
        tracing._pid_names.update(saved)
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert len({e["pid"] for e in spans}) == 1
    assert merged["metadata"]["stitched_flows"] == 0
    return {"pids": sorted({e["pid"] for e in spans}),
            "stitched": merged["metadata"]["stitched_flows"]}


@_traced
def merge_rejects_non_object_documents(tw, tracing):
    with pytest.raises(ValueError, match="JSON object") as e:
        tracing.merge_chrome([[{"name": "x", "ph": "X"}]])
    return str(e.value)


@_traced
def merge_remaps_colliding_flow_ids(tw, tracing):
    def doc(pid, trace_id):
        return {
            "traceEvents": [
                {"name": "causal", "cat": "flow", "ph": "s", "id": 2,
                 "ts": 1.0, "pid": pid, "tid": 1,
                 "args": {"trace_id": trace_id}},
                {"name": "causal", "cat": "flow", "ph": "f", "bp": "e",
                 "id": 2, "ts": 2.0, "pid": pid, "tid": 2,
                 "args": {"trace_id": trace_id}},
            ],
            "metadata": {"epoch_us": 0.0},
        }

    merged = tracing.merge_chrome([doc(111, "nonce-a"), doc(222, "nonce-b")])
    flows = [e for e in merged["traceEvents"] if e.get("ph") in ("s", "f")]
    by_id = {}
    for e in flows:
        by_id.setdefault(e["id"], set()).add(e["args"]["trace_id"])
    assert all(len(traces) == 1 for traces in by_id.values()), by_id
    assert len(by_id) == 2
    return merged


@_traced
def merge_aligns_clocks_and_remaps_colliding_pids(tw, tracing):
    base = {"traceEvents": [
        {"name": "x", "cat": "c", "ph": "X", "ts": 10.0, "dur": 5.0,
         "pid": 42, "tid": 1, "args": {"trace_id": "n"}}],
        "metadata": {"epoch_us": 1_000_000.0}}
    later = {"traceEvents": [
        {"name": "y", "cat": "c", "ph": "X", "ts": 10.0, "dur": 5.0,
         "pid": 42, "tid": 1, "args": {"trace_id": "n"}}],
        "metadata": {"epoch_us": 1_000_100.0}}
    merged = tracing.merge_chrome([base, later])
    spans = sorted([e for e in merged["traceEvents"] if e.get("ph") == "X"],
                   key=lambda e: e["ts"])
    assert spans[1]["ts"] - spans[0]["ts"] == pytest.approx(100.0)
    assert spans[0]["pid"] != spans[1]["pid"]
    return merged


# ----------------------------------------------------------------------
# /debug/fleet endpoint + manager wiring
# ----------------------------------------------------------------------
def endpoint_serves_fleet_view_and_503_when_disabled(tw):
    Manager = tw.manager.Manager
    store = tw.store.Store()
    plane = _plane(tw, store, "rep-a", tw.metrics.Histogram("h"), "proc-a")
    plane.tick(now=100.0)
    mgr = Manager(store=store, health_addr="127.0.0.1:0", fleet=plane)
    mgr.start()
    try:
        port = mgr.health_port
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/fleet").read())
        assert doc["identity"] == "rep-a" and "rep-a" in doc["replicas"]
        index = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug").read())
        assert "/debug/fleet" in index["endpoints"]
    finally:
        mgr.stop()
    mgr = Manager(store=tw.store.Store(), health_addr="127.0.0.1:0")
    mgr.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{mgr.health_port}/debug/fleet")
        assert exc.value.code == 503
        code = (exc.value.code, exc.value.read().decode())
    finally:
        mgr.stop()
    return {"view": core(doc), "index": sorted(index["endpoints"]),
            "disabled": code}


def runnable_publishes_on_cadence(tw):
    store = tw.store.Store()
    plane = _plane(tw, store, "rep-a", tw.metrics.Histogram("h"), "proc-a",
                   publish_period=0.05)
    stop = threading.Event()
    t = threading.Thread(target=plane.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            objs = store.list(tw.fleet_api.FleetTelemetry)
            if objs and objs[0].spec.seq >= 2:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("publisher never advanced seq")
    finally:
        stop.set()
        t.join(timeout=2)
    return {"advanced": True, "name": objs[0].metadata.name,
            "active": tw.fleet.active() is plane}


SCENARIOS = [
    histogram_merge_preserves_sum_count_and_inf,
    histogram_merge_accepts_serialized_state,
    histogram_merge_bucket_schema_guard,
    counter_merge_sums_label_sets,
    publish_and_aggregate_two_replicas,
    process_token_dedup_never_double_counts,
    schema_mismatch_excludes_contributor_loudly,
    dead_replica_ages_out_and_label_sets_level_set,
    store_blip_does_not_reset_staleness_clocks,
    long_dead_snapshot_gcd_from_store,
    own_view_survives_store_outage,
    merged_burn_equals_single_replica_burn,
    replica_pid_is_stable_and_named,
    merge_stitches_nonce_across_pids,
    merge_keeps_same_identity_pid_across_incarnations,
    merge_rejects_non_object_documents,
    merge_remaps_colliding_flow_ids,
    merge_aligns_clocks_and_remaps_colliding_pids,
    endpoint_serves_fleet_view_and_503_when_disabled,
    runnable_publishes_on_cadence,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_dump_file_matches_jax(tmp_path):
    jax_out, port_out = run_both(dump_file, tmp_path)
    assert port_out == jax_out


# ----------------------------------------------------------------------
# Cross-package payloads
# ----------------------------------------------------------------------
def _published_payload(tw):
    H = tw.metrics.Histogram
    store = tw.store.Store()
    hist = H("h")
    for v in (0.05, 0.2, 0.9, 3.0, 12.0):
        hist.observe(v, type="gpu")
    own = tw.shards.ShardOwnership(6)
    own._owned.update({1, 4})
    plane = tw.fleet.FleetPlane(
        store, "rep-x", num_shards=6, ownership=own,
        histograms={"tpuc_attach_to_ready_seconds": hist},
        process_token="proc-x")
    assert plane.publish()
    obj = store.get(tw.fleet_api.FleetTelemetry, "telemetry.rep-x")
    d = obj.spec.to_dict()
    for k in ("publishedAt", "slo", "gil", "profilerTop"):
        d["payload"].pop(k, None)
    return d


def test_payloads_match_across_packages():
    jax_out, port_out = run_both(_published_payload)
    assert port_out == jax_out
    # The SLO-relevant histograms share their bucket schemas.
    jax_m, port_m = twin(JAX_ROOT).metrics, twin(PORT_ROOT).metrics
    for name in ("attach_to_ready_seconds", "fabric_completion_latency",
                 "queue_wait_seconds", "repair_time_to_replace_seconds"):
        assert getattr(port_m, name).buckets == getattr(jax_m, name).buckets


def test_port_aggregator_merges_a_jax_replica_snapshot():
    """A JAX replica's FleetTelemetry, carried as its wire dict into the
    port's store, merges into the port aggregator's series; the fleet
    burn rate equals the JAX aggregator's over the mirrored store."""
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    wave = [0.2, 0.4, 6.0, 0.3, 7.5, 0.1]

    def replica(tw, store, ident, values):
        h = tw.metrics.Histogram(ident)
        plane = tw.fleet.FleetPlane(
            store, ident, histograms={"tpuc_attach_to_ready_seconds": h},
            process_token=f"proc-{ident}", attach_p99_s=5.0, queue_p99_s=0.0)
        plane.publish()
        plane.aggregate(now=0.0)
        for v in values:
            h.observe(v, type="gpu")
        plane.publish()
        return plane

    # The JAX replica publishes into a JAX store; its object crosses over.
    jstore = jax.store.Store()
    jrep = replica(jax, jstore, "rep-j", wave[0::2])
    # The aggregating replica, once in each package, sees the same two
    # snapshots: its own and the JAX replica's.
    burns, counts = [], []
    for tw in (jax, port):
        store = tw.store.Store()
        agg = replica(tw, store, "rep-agg", wave[1::2])
        wire = jstore.get(jax.fleet_api.FleetTelemetry, "telemetry.rep-j")
        doc = json.loads(json.dumps(wire.to_dict()))
        doc["metadata"].pop("resourceVersion", None)
        doc["metadata"].pop("uid", None)
        store.create(tw.fleet_api.FleetTelemetry.from_dict(doc))
        view = agg.aggregate(now=30.0)
        counts.append(view["merged"]["tpuc_attach_to_ready_seconds"]["count"])
        burns.append(agg.slo.burn_rates("fleet_attach_p99"))
    assert counts == [len(wave), len(wave)]
    assert burns[0] == burns[1] and burns[1][0] > 0
    assert jrep.identity == "rep-j"
