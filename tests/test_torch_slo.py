"""The port's SLO engine against the JAX package's (tests/test_slo.py's
twin): histogram quantiles, multi-window burn rates on an injected
clock, the default objectives, and the brownout acceptance (a fabric
blackout stalls attaches, the attach objective breaches before the
repair breaker opens, and clears on recovery).

Each scenario runs once per package (``run_both``: the same seeded
``random`` and uuids) and returns what the reference test asserts on —
percentiles, counts, burn rates, breach flags, the gauges and the
Events' reasons — and asserts the reference's invariants on the way.
The two packages' results must be equal. Tolerance: exact.

The brownout scenarios sleep 0.2 s of real time inside a blackout, as
the reference does, so the attach histogram records the outage.
"""

from __future__ import annotations

import random
import time

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)

MODEL = "tpu-v4"


# ---------------------------------------------------------------------------
# Histogram quantiles — the SLO engine's substrate
# ---------------------------------------------------------------------------

def empty_series_returns_none_not_a_boundary(tw):
    h = tw.metrics.Histogram("t_slo_empty")
    out = [h.percentile(0.5), h.percentile(0.99, op="x")]
    assert out == [None, None]
    return out


def exact_path_while_samples_complete(tw):
    h = tw.metrics.Histogram("t_slo_exact")
    for v in (0.1, 0.2, 0.3, 0.4, 0.5):
        h.observe(v)
    out = [h.percentile(0.5), h.percentile(1.0)]
    assert out == [0.3, 0.5]
    return out


def bucket_interpolation_after_sample_eviction(tw):
    h = tw.metrics.Histogram("t_slo_interp", buckets=(0.1, 0.2, 0.4, 0.8))
    h._max_samples = 4
    h._samples.clear()
    for _ in range(100):
        h.observe(0.15)
    p50 = h.percentile(0.5)
    assert p50 is not None and 0.1 < p50 < 0.2, p50
    assert abs(p50 - 0.15) < 0.011, p50
    return p50


def count_le_interpolates_within_bucket(tw):
    h = tw.metrics.Histogram("t_slo_countle", buckets=(0.1, 0.2, 0.4))
    for _ in range(10):
        h.observe(0.15)
    for _ in range(10):
        h.observe(0.3)
    out = [h.total_count(), h.total_count_le(0.2), h.total_count_le(0.3)]
    assert out[0] == 20 and out[1] == 10
    assert abs(out[2] - 15.0) < 1e-9
    h.observe(99.0)
    out.append(h.total_count_le(0.4))
    assert out[3] == 20
    return out


# ---------------------------------------------------------------------------
# Burn-rate math (driven with an injected clock)
# ---------------------------------------------------------------------------

def _engine(tw, h, threshold=0.1, target=0.9, **kw):
    kw.setdefault("fast_window", 30.0)
    kw.setdefault("slow_window", 300.0)
    kw.setdefault("burn_threshold", 2.0)
    return tw.slo.SloEngine(
        objectives=[tw.slo.Objective("obj", h, threshold, target)], **kw)


def no_traffic_means_zero_burn(tw):
    h = tw.metrics.Histogram("t_burn_idle")
    eng = _engine(tw, h)
    eng.evaluate(now=0.0)
    snap = eng.evaluate(now=10.0)
    assert eng.burn_rates("obj") == (0.0, 0.0)
    assert not eng.breached("obj")
    return snap


def fast_window_trips_before_slow(tw):
    m = tw.metrics
    h = m.Histogram("t_burn_fastfirst")
    eng = _engine(tw, h)
    for t in range(0, 280, 10):
        for _ in range(10):
            h.observe(0.01)
        eng.evaluate(now=float(t))
    for _ in range(20):
        h.observe(1.0)
    eng.evaluate(now=290.0)
    fast, slow = eng.burn_rates("obj")
    assert fast >= eng.burn_threshold and slow < eng.burn_threshold
    assert not eng.breached("obj")
    assert m.slo_breached.value(slo="obj") == 0.0
    steps = [(fast, slow)]
    t = 290.0
    while not eng.breached("obj") and t < 600.0:
        t += 10.0
        for _ in range(20):
            h.observe(1.0)
        eng.evaluate(now=t)
        steps.append(eng.burn_rates("obj"))
    assert eng.breached("obj"), eng.burn_rates("obj")
    assert m.slo_breached.value(slo="obj") == 1.0
    assert m.slo_burn_rate.value(slo="obj", window="fast") >= 2.0
    return {"steps": steps, "breached_at": t}


def recovery_clears_via_the_fast_window(tw):
    m = tw.metrics
    h = m.Histogram("t_burn_recover")
    recorder = tw.events.EventRecorder()
    eng = _engine(tw, h, recorder=recorder)
    eng.evaluate(now=0.0)
    for _ in range(50):
        h.observe(1.0)
    eng.evaluate(now=10.0)
    assert eng.breached("obj")
    breach = [e for e in recorder.all() if e.reason == "SloBreached"]
    assert len(breach) == 1 and breach[0].kind == "SLO"
    rates = []
    for t in (20.0, 30.0, 41.0, 50.0):
        for _ in range(30):
            h.observe(0.01)
        eng.evaluate(now=t)
        rates.append(eng.burn_rates("obj"))
    assert not eng.breached("obj"), eng.burn_rates("obj")
    assert m.slo_breached.value(slo="obj") == 0.0
    assert any(e.reason == "SloRecovered" for e in recorder.all())
    return {"rates": rates,
            "events": [(e.kind, e.name, e.type, e.reason, e.message)
                       for e in recorder.all()]}


def defaults_cover_the_four_objectives(tw):
    names = {o.name for o in tw.slo.default_objectives()}
    assert names == {"attach_p99", "completion_p50", "queue_wait_p99",
                     "repair_p99"}
    off = {o.name for o in tw.slo.default_objectives(queue_p99_s=0)}
    assert off == {"attach_p99", "completion_p50", "repair_p99"}
    return [[(o.name, o.histogram.name, o.threshold_s, o.target,
              o.description) for o in tw.slo.default_objectives()],
            sorted(off)]


# ---------------------------------------------------------------------------
# Brownout acceptance: chaos stalls attaches -> attach SLO burns -> clears
# ---------------------------------------------------------------------------

def make_world(tw, nodes=4):
    store = tw.store.Store()
    for i in range(nodes):
        n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        n.status.tpu_slots = 8
        store.create(n)
    pool = tw.inmem.InMemoryPool(chips={MODEL: 64})
    chaos = tw.chaos.ChaosFabricProvider(pool)
    agent = tw.fake.FakeNodeAgent(pool=pool)
    req_rec = tw.req.ComposabilityRequestReconciler(
        store, chaos,
        timing=tw.req.RequestTiming(updating_poll=0.01, cleaning_poll=0.01,
                                    running_poll=5.0, repair_poll=0.01),
        repair=tw.req.RepairConfig(),
    )
    res_rec = tw.rc.ComposableResourceReconciler(
        store, chaos, agent,
        timing=tw.rc.ResourceTiming(health_failure_threshold=2,
                                    health_recovery_threshold=1),
    )
    return store, pool, chaos, req_rec, res_rec


def pump(tw, store, req_rec, res_rec, names, steps=80, done=None):
    for _ in range(steps):
        for name in names:
            try:
                req_rec.reconcile(name)
            except tw.provider.FabricError:
                pass
        for c in store.list(tw.types.ComposableResource):
            try:
                res_rec.reconcile(c.metadata.name)
            except tw.provider.FabricError:
                pass
        if done is not None and done():
            return


def running(tw, store, name):
    req = store.try_get(tw.types.ComposabilityRequest, name)
    return req is not None and \
        req.status.state == tw.types.REQUEST_STATE_RUNNING


def _create(tw, store, name, size):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model=MODEL, size=size))))


def attach_batch(tw, store, req_rec, res_rec, names, size=4):
    for name in names:
        _create(tw, store, name, size)
    pump(tw, store, req_rec, res_rec, names,
         done=lambda: all(running(tw, store, n) for n in names))
    for name in names:
        assert running(tw, store, name), name
        store.delete(tw.types.ComposabilityRequest, name)
    pump(tw, store, req_rec, res_rec, names, steps=120,
         done=lambda: all(store.try_get(tw.types.ComposabilityRequest, n)
                          is None for n in names))


def brownout_trips_attach_slo_and_clears_on_recovery(tw):
    m = tw.metrics
    store, pool, chaos, req_rec, res_rec = make_world(tw)
    recorder = req_rec.recorder
    eng = tw.slo.SloEngine(
        objectives=[tw.slo.Objective(
            "attach_p99", m.attach_to_ready_seconds, 0.1, 0.90,
            "attach-to-ready under brownout")],
        recorder=recorder, fast_window=30.0, slow_window=120.0,
        burn_threshold=2.0)
    eng.evaluate(now=0.0)
    attach_batch(tw, store, req_rec, res_rec, ["ok-1", "ok-2"])
    eng.evaluate(now=10.0)
    assert not eng.breached("attach_p99")
    healthy = eng.breached("attach_p99")

    chaos.blackout()
    for name in ("slow-1", "slow-2"):
        _create(tw, store, name, 4)
    pump(tw, store, req_rec, res_rec, ["slow-1", "slow-2"], steps=5,
         done=lambda: False)
    time.sleep(0.2)
    chaos.heal()
    pump(tw, store, req_rec, res_rec, ["slow-1", "slow-2"],
         done=lambda: running(tw, store, "slow-1")
         and running(tw, store, "slow-2"))
    eng.evaluate(now=20.0)
    assert eng.breached("attach_p99"), eng.burn_rates("attach_p99")
    assert m.slo_breached.value(slo="attach_p99") == 1.0
    evs = [e for e in recorder.all() if e.reason == "SloBreached"]
    assert evs and evs[0].kind == "SLO" and evs[0].name == "attach_p99"
    browned = (eng.breached("attach_p99"),
               m.slo_breached.value(slo="attach_p99"))

    for n2 in ("slow-1", "slow-2"):
        store.delete(tw.types.ComposabilityRequest, n2)
    pump(tw, store, req_rec, res_rec, ["slow-1", "slow-2"], steps=120,
         done=lambda: all(store.try_get(tw.types.ComposabilityRequest, n)
                          is None for n in ("slow-1", "slow-2")))
    attach_batch(tw, store, req_rec, res_rec, ["ok-3", "ok-4"])
    eng.evaluate(now=60.0)
    assert not eng.breached("attach_p99"), eng.burn_rates("attach_p99")
    assert m.slo_breached.value(slo="attach_p99") == 0.0
    assert any(e.reason == "SloRecovered" for e in recorder.all())
    return {"healthy": healthy, "browned": browned,
            "recovered": eng.breached("attach_p99"),
            "slo_reasons": [e.reason for e in recorder.all()
                            if e.kind == "SLO"]}


def brownout_slo_fires_before_repair_breaker_opens(tw):
    m = tw.metrics
    store, pool, chaos, req_rec, res_rec = make_world(tw, nodes=8)
    eng = tw.slo.SloEngine(
        objectives=[tw.slo.Objective(
            "attach_p99", m.attach_to_ready_seconds, 0.1, 0.90)],
        fast_window=30.0, slow_window=120.0, burn_threshold=2.0)
    m.repair_breaker_open.set(0.0)
    _create(tw, store, "steady", 16)
    pump(tw, store, req_rec, res_rec, ["steady"],
         done=lambda: running(tw, store, "steady"))
    assert running(tw, store, "steady")
    eng.evaluate(now=0.0)

    chaos.blackout()
    _create(tw, store, "late", 4)
    pump(tw, store, req_rec, res_rec, ["late"], steps=5, done=lambda: False)
    time.sleep(0.2)
    chaos.heal()
    pump(tw, store, req_rec, res_rec, ["late", "steady"],
         done=lambda: running(tw, store, "late"))
    eng.evaluate(now=10.0)
    assert eng.breached("attach_p99"), eng.burn_rates("attach_p99")
    assert m.repair_breaker_open.value() == 0.0
    return {"breached": eng.breached("attach_p99"),
            "repair_breaker_open": m.repair_breaker_open.value(),
            "late_running": running(tw, store, "late")}


SCENARIOS = [
    empty_series_returns_none_not_a_boundary,
    exact_path_while_samples_complete,
    bucket_interpolation_after_sample_eviction,
    count_le_interpolates_within_bucket,
    no_traffic_means_zero_burn,
    fast_window_trips_before_slow,
    recovery_clears_via_the_fast_window,
    defaults_cover_the_four_objectives,
    brownout_trips_attach_slo_and_clears_on_recovery,
    brownout_slo_fires_before_repair_breaker_opens,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# Cross-package: the same observations on a stepped clock
# ---------------------------------------------------------------------------

def seeded_burn_trace(tw, seed: int):
    """A seeded stream of observations (mostly good, with bad bursts)
    evaluated every 5 s on a stepped clock over 20 minutes: every step's
    burn rates, breach flag and gauges, and the breach/recovery Events."""
    rng = random.Random(seed)
    m = tw.metrics
    h = m.Histogram(f"t_burn_seeded_{seed}", buckets=(0.1, 0.25, 0.5, 1.0,
                                                      2.5, 5.0))
    recorder = tw.events.EventRecorder()
    eng = tw.slo.SloEngine(
        objectives=[tw.slo.Objective("seeded", h, 0.5, 0.95, "seeded")],
        recorder=recorder, fast_window=60.0, slow_window=600.0,
        burn_threshold=2.0)
    trace = []
    bad_until = -1.0
    for step in range(240):
        now = step * 5.0
        if rng.random() < 0.02:
            bad_until = now + rng.uniform(30.0, 240.0)
        for _ in range(rng.randrange(0, 12)):
            bad = rng.random() < (0.6 if now < bad_until else 0.01)
            h.observe(rng.uniform(0.6, 6.0) if bad else rng.uniform(0.0, 0.5))
        snap = eng.evaluate(now=now)
        o = snap["objectives"]["seeded"]
        trace.append((o["windows"]["fast"]["burn_rate"],
                      o["windows"]["slow"]["burn_rate"], o["breached"],
                      m.slo_breached.value(slo="seeded"),
                      m.slo_burn_rate.value(slo="seeded", window="fast")))
    edges = [(e.type, e.reason, e.message) for e in recorder.all()]
    return {"trace": trace, "edges": edges}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_observations_give_the_same_burn_rates_and_edges(seed):
    jax_out, port_out = run_both(seeded_burn_trace, seed)
    assert port_out == jax_out
    # The stream really exercises the engine: breach and recovery edges,
    # and burn rates that move.
    reasons = {e[1] for e in port_out["edges"]}
    assert reasons == {"SloBreached", "SloRecovered"}
    assert len({t[0] for t in port_out["trace"]}) > 3
