"""The port's circuit breaker and chaos provider (tpu_composer_torch/
fabric/{breaker,chaos}.py) against the JAX package's
(tests/test_resilience.py's ``TestCircuitBreaker``,
``TestBreakerFabricProvider`` and ``TestChaosProvider``, and
``TestAttachBudget::test_endpoint_outage_does_not_burn_node_budgets``,
which holds the resource reconciler's breaker exemption).

The breakers run on an injected clock (``FakeClock``, advanced by the
scenario) and a midpoint rng, so the half-open windows are exact and no
wall time passes. Each scenario records breaker states, outcomes (error
classes, messages and scopes), the chaos provider's call and injection
counts, the breaker metrics' values and the pool's listing; the two
packages' records must be equal. Tolerance: exact.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class MidpointRng:
    """random() == 0.5: the breaker's ±20 % reset jitter is exact."""

    def random(self) -> float:
        return 0.5

    def uniform(self, a: float, b: float) -> float:
        return (a + b) / 2


def do(trace, fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        trace.append(("raised", type(e).__name__, str(e),
                      getattr(e, "scope", None)))
        return None
    if hasattr(out, "device_ids"):
        out = ("attach", list(out.device_ids), out.cdi_device_id)
    elif isinstance(out, list):
        out = [d.device_id for d in out]
    trace.append(out)
    return out


# -- CircuitBreaker ------------------------------------------------------------------

def _breaker(tw, threshold, reset, endpoint):
    clock = FakeClock()
    br = tw.breaker.CircuitBreaker(
        endpoint, "w0",
        tw.breaker.BreakerConfig(failure_threshold=threshold,
                                 reset_timeout=reset),
        clock=clock, rng=MidpointRng())
    return br, clock


def _fail(br):
    br.acquire()
    br.failure()


def trips_after_consecutive_failures(tw):
    br, _ = _breaker(tw, 3, 10.0, "ep-trip")
    t = []
    for _ in range(3):
        _fail(br)
        t.append(br.state)
    do(t, br.acquire)
    return t


def success_resets_streak(tw):
    br, _ = _breaker(tw, 2, 10.0, "ep-streak")
    _fail(br)
    br.acquire()
    br.success()
    _fail(br)
    return [br.state]


def half_open_probe_success_closes(tw):
    br, clock = _breaker(tw, 1, 10.0, "ep-probe")
    t = []
    _fail(br)
    t.append(br.state)
    clock.t = 9.9
    do(t, br.acquire)
    clock.t = 10.1
    do(t, br.acquire)
    t.append(br.state)
    do(t, br.acquire)  # one probe at a time
    br.success()
    return t + [br.state]


def half_open_probe_failure_reopens(tw):
    br, clock = _breaker(tw, 1, 10.0, "ep-reopen")
    trips = tw.metrics.fabric_breaker_trips_total
    t = []
    _fail(br)
    before = trips.value(endpoint="ep-reopen", scope="w0")
    clock.t = 10.1
    br.acquire()
    br.failure()
    t.append(br.state)
    t.append(trips.value(endpoint="ep-reopen", scope="w0") - before)
    clock.t = 15.0
    do(t, br.acquire)
    clock.t = 20.2
    do(t, br.acquire)
    return t + [br.state]


def cancel_releases_probe_slot(tw):
    br, clock = _breaker(tw, 1, 10.0, "ep-cancel")
    _fail(br)
    clock.t = 10.1
    br.acquire()
    br.cancel()
    t = []
    do(t, br.acquire)
    br.success()
    return t + [br.state]


BREAKER = [trips_after_consecutive_failures, success_resets_streak,
           half_open_probe_success_closes, half_open_probe_failure_reopens,
           cancel_releases_probe_slot]


# -- BreakerFabricProvider -----------------------------------------------------------

def _world(tw, endpoint, **cfg):
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 8})
    chaos = tw.chaos.ChaosFabricProvider(pool)
    config = tw.breaker.BreakerConfig(**{"failure_threshold": 2,
                                         "reset_timeout": 30.0, **cfg})
    fabric = tw.breaker.BreakerFabricProvider(
        chaos, endpoint=endpoint, config=config, clock=FakeClock(),
        rng=MidpointRng())
    return pool, chaos, fabric


def gpu(tw, name, node, model="gpu-a100"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="gpu", model=model,
                                      target_node=node))


def flaky_node_trips_only_its_own_breaker(tw):
    pool, chaos, fabric = _world(tw, "bp-flaky")
    chaos.fail_node("w0")
    t = []
    for _ in range(2):
        do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    t += [fabric.breaker("w0").state, fabric.breaker().state, chaos.calls]
    do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    t.append(chaos.calls)
    do(t, fabric.add_resource, gpu(tw, "r1", "w1"))
    do(t, fabric.get_resources)
    return t


def blackout_trips_endpoint_breaker(tw):
    pool, chaos, fabric = _world(tw, "bp-blackout", failure_threshold=2,
                                 endpoint_failure_threshold=3)
    chaos.blackout()
    t = []
    for _ in range(3):
        do(t, fabric.get_resources)
    t += [fabric.breaker().state, chaos.calls]
    do(t, fabric.get_resources)
    do(t, fabric.add_resource, gpu(tw, "r0", "w9"))
    return t + [chaos.calls]


def wait_sentinels_and_terminal_errors_do_not_trip(tw):
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 1}, async_steps=3)
    fabric = tw.breaker.BreakerFabricProvider(
        pool, endpoint="bp-wait",
        config=tw.breaker.BreakerConfig(failure_threshold=1))
    t = []
    do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    t.append(fabric.breaker("w0").state)
    do(t, fabric.add_resource, gpu(tw, "r1", "w0", model="nope"))
    return t + [fabric.breaker("w0").state]


def forget_node_drops_breaker_and_metrics(tw):
    pool, chaos, fabric = _world(tw, "bp-forget")
    chaos.fail_node("w0")
    t = []
    for _ in range(2):
        do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    key = (("endpoint", "bp-forget"), ("scope", "w0"))
    state = tw.metrics.fabric_breaker_state
    t += ["w0" in fabric._node_breakers, key in state._values]
    fabric.forget_node("w0")
    t += ["w0" in fabric._node_breakers, key in state._values,
          fabric.breaker("w0").state]
    return t


def recovery_closes_after_reset_timeout(tw):
    pool, chaos, fabric = _world(tw, "bp-recover", reset_timeout=10.0)
    chaos.fail_node("w0")
    t = []
    for _ in range(2):
        do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    chaos.heal_node("w0")
    do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    fabric._clock.t = 10.1
    do(t, fabric.add_resource, gpu(tw, "r0", "w0"))
    return t + [fabric.breaker("w0").state]


PROVIDER = [flaky_node_trips_only_its_own_breaker,
            blackout_trips_endpoint_breaker,
            wait_sentinels_and_terminal_errors_do_not_trip,
            forget_node_drops_breaker_and_metrics,
            recovery_closes_after_reset_timeout]


# -- ChaosFabricProvider -------------------------------------------------------------

def scripted_node_failures_then_heal(tw):
    chaos = tw.chaos.ChaosFabricProvider(
        tw.inmem.InMemoryPool(chips={"gpu-a100": 4}))
    chaos.fail_node("w0", times=2)
    t = []
    for _ in range(3):
        do(t, chaos.add_resource, gpu(tw, "r0", "w0"))
    return t + [chaos.injected, chaos.calls]


def probabilistic_rate_is_seeded(tw):
    runs = []
    for _ in range(2):
        chaos = tw.chaos.ChaosFabricProvider(
            tw.inmem.InMemoryPool(chips={"gpu-a100": 4}), failure_rate=0.5,
            seed=42)
        out = []
        for _ in range(50):
            try:
                chaos.get_resources()
                out.append(True)
            except tw.provider.TransientFabricError:
                out.append(False)
        runs.append(out)
    return runs


def blackout_and_latency(tw):
    sleeps = []
    chaos = tw.chaos.ChaosFabricProvider(
        tw.inmem.InMemoryPool(chips={"gpu-a100": 4}), latency=0.25,
        sleep=sleeps.append)
    t = []
    chaos.blackout()
    do(t, chaos.get_resources)
    chaos.heal()
    do(t, chaos.get_resources)
    return t + [sleeps]


def degrade_flap_vanish(tw):
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 4})
    chaos = tw.chaos.ChaosFabricProvider(pool)
    r0, r1 = gpu(tw, "r0", "w0"), gpu(tw, "r1", "w1")
    t = []
    a0 = do(t, chaos.add_resource, r0)
    do(t, chaos.add_resource, r1)
    r0.status.device_ids = list(a0[1])
    chaos.degrade_node("w0")
    do(t, chaos.check_resource, r0)
    chaos.restore_node("w0")
    chaos.flap_device(a0[1][0])
    do(t, chaos.check_resource, r0)
    chaos.heal_device(a0[1][0])
    chaos.vanish_device(a0[1][0])
    do(t, chaos.get_resources)
    chaos.unvanish_device(a0[1][0])
    do(t, chaos.get_resources)
    chaos.fail_op("add_resource", times=1)
    do(t, chaos.add_resource, gpu(tw, "r2", "w2"))
    return [x if not hasattr(x, "state") else (x.state, x.detail)
            for x in t] + [chaos.injected]


def endpoint_outage_does_not_burn_node_budgets(tw):
    """The resource reconciler's attach budget behind the breaker: an
    endpoint-scoped rejection (``BreakerOpenError`` without a scope)
    carries no evidence against the node and burns no budget."""
    t = tw.types
    store = tw.store.Store()
    node = t.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
    node.status.tpu_slots = 8
    store.create(node)
    pool = tw.inmem.InMemoryPool(chips={"tpu-v4": 64})
    chaos = tw.chaos.ChaosFabricProvider(pool)
    clock = FakeClock()
    fabric = tw.breaker.BreakerFabricProvider(
        chaos, endpoint="bp-outage",
        config=tw.breaker.BreakerConfig(failure_threshold=50,
                                        endpoint_failure_threshold=1,
                                        reset_timeout=60.0),
        clock=clock, rng=MidpointRng())
    rec = tw.rc.ComposableResourceReconciler(
        store, fabric, tw.fake.FakeNodeAgent(pool=pool),
        timing=tw.rc.ResourceTiming(attach_budget=3))
    pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["worker-0"])
    store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="r0"),
        spec=t.ComposableResourceSpec(
            type="tpu", model="tpu-v4", target_node="worker-0", chip_count=4,
            slice_name="s1", worker_id=0, topology="2x2x1")))
    out = []
    do(out, rec.reconcile, "r0")
    chaos.blackout()
    do(out, rec.reconcile, "r0")
    out.append(fabric.breaker().state)
    for _ in range(10):
        do(out, rec.reconcile, "r0")
    cr = store.get(t.ComposableResource, "r0")
    out += [cr.status.quarantined, cr.status.attach_attempts,
            tw.publisher.node_quarantined(store, "worker-0")]
    chaos.heal()
    clock.t = 61.0
    do(out, rec.reconcile, "r0")
    return [x if not hasattr(x, "requeue_after") else x.requeue_after
            for x in out] + [store.get(t.ComposableResource, "r0").status.state]


CHAOS = [scripted_node_failures_then_heal, probabilistic_rate_is_seeded,
         blackout_and_latency, degrade_flap_vanish,
         endpoint_outage_does_not_burn_node_budgets]


@pytest.mark.parametrize("scenario", BREAKER + PROVIDER + CHAOS,
                         ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port


def test_breaker_records_hold_the_reference_contract():
    """A few anchors on the JAX records, so equal records mean the
    contract: the trip, the half-open probe and the node isolation."""
    (jax, _) = run_both(trips_after_consecutive_failures)
    assert jax[:3] == ["closed", "closed", "open"] and jax[3][1] == "BreakerOpenError"
    (jax, _) = run_both(half_open_probe_success_closes)
    assert jax[-1] == "closed" and jax[3] == "half-open"
    (jax, _) = run_both(flaky_node_trips_only_its_own_breaker)
    assert jax[2:4] == ["open", "closed"] and jax[6] == jax[4]
    assert jax[5][1] == "BreakerOpenError" and jax[7][0] == "attach"
    (jax, _) = run_both(endpoint_outage_does_not_burn_node_budgets)
    assert [row[1] for row in jax[3:13]] == ["BreakerOpenError"] * 10
    assert jax[13:16] == [False, 1, False] and jax[-1] == "Online"
