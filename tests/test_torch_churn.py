"""The port's churn generator and simulator against the JAX package's
(tests/test_churn.py's twin): the same seed gives the same plan and
trace digest in both packages, plans are time-ordered with arrivals
first, the simulation is deterministic and, with generous capacity,
queues nothing, and the macro-scale plan (6,000 nodes, 52,000 requests)
generates and simulates alike.

Each scenario runs once per package (``run_both``) and returns the
plans' digests and counts and the simulations' outputs; the reference's
invariants are asserted on the way. Tolerance: exact.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)


def same_seed_same_plan(tw):
    c = tw.churn
    a = c.generate_plan(seed=7, requests=500, duration_s=30.0, nodes=64)
    b = c.generate_plan(seed=7, requests=500, duration_s=30.0, nodes=64)
    assert a.trace_digest() == b.trace_digest() and a.events == b.events
    other = c.generate_plan(seed=8, requests=500, duration_s=30.0, nodes=64)
    assert other.trace_digest() != a.trace_digest()
    return a.trace_digest(), other.trace_digest()


def plan_shape_and_ordering(tw):
    c = tw.churn
    plan = c.generate_plan(seed=3, requests=300, duration_s=20.0, nodes=32)
    counts = plan.counts()
    assert counts[c.ARRIVE] == 300
    assert {e.kind for e in plan.events} <= {c.ARRIVE, c.CANCEL, c.RESIZE,
                                             c.MIGRATE}
    times = [e.at_s for e in plan.events]
    assert times == sorted(times)
    born = set()
    for e in plan.events:
        if e.kind == c.ARRIVE:
            born.add(e.name)
        elif e.kind in (c.CANCEL, c.RESIZE):
            assert e.name in born, f"{e.kind} before arrival: {e.name}"
    return counts, [e.line() for e in plan.events[:40]]


def simulate_deterministic(tw):
    c = tw.churn
    plan = c.generate_plan(seed=11, requests=2000, duration_s=60.0,
                           nodes=128)
    first, second = c.simulate(plan), c.simulate(plan)
    assert first == second and first["digest"] == plan.trace_digest()
    return first


def simulate_invariants_under_generous_capacity(tw):
    c = tw.churn
    plan = c.generate_plan(
        seed=5, requests=200, duration_s=20.0, nodes=512, chips_per_node=8,
        max_size=2, cancel_frac=0.0, resize_frac=0.0, migrate_frac=0.0)
    out = c.simulate(plan)
    assert out["arrivals"] == 200 and out["placed_total"] == 200
    assert out["still_queued"] == 0 and out["queue_wait_p99_s"] == 0.0
    assert out["goodput_ratio"] == 1.0
    return out


def macro_scale_inventory(tw):
    c = tw.churn
    plan = c.generate_plan(seed=17, requests=52_000, duration_s=600.0,
                           nodes=6_000, chips_per_node=4, max_size=4)
    assert plan.counts()[c.ARRIVE] >= 50_000 and plan.nodes >= 5_000
    out = c.simulate(plan)
    assert out["digest"] == plan.trace_digest()
    assert 0.0 <= out["goodput_ratio"] <= 1.0
    assert out["queue_wait_p99_s"] >= out["queue_wait_p50_s"]
    assert out["placed_total"] <= out["arrivals"] + out["migrated_members"]
    assert out["still_running"] <= out["placed_total"]
    assert out["still_running"] + out["still_queued"] <= out["arrivals"]
    assert out["cancelled_before_place"] <= plan.counts().get(c.CANCEL, 0)
    return out


SCENARIOS = [
    same_seed_same_plan,
    plan_shape_and_ordering,
    simulate_deterministic,
    simulate_invariants_under_generous_capacity,
    macro_scale_inventory,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_same_seed_gives_the_same_plan_digest_in_both_packages(seed):
    """The defaults (``models=("tpu-v4",)`` among them) are shared, so one
    seed names one plan whichever package generates it."""
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    pj = jax.churn.generate_plan(seed=seed)
    pp = port.churn.generate_plan(seed=seed)
    assert pp.trace_digest() == pj.trace_digest()
    assert [e.line() for e in pp.events] == [e.line() for e in pj.events]
    h100 = dict(seed=seed, models=("nvidia-h100-sxm",), requests=50)
    assert port.churn.generate_plan(**h100).trace_digest() == \
        jax.churn.generate_plan(**h100).trace_digest()


def test_h100_arrivals_are_gpu_requests():
    """The port's ``ChurnDriver`` posts an H100 arrival as a ``gpu``
    request and a TPU arrival as a ``tpu`` one; the JAX package's posts
    ``tpu`` for both."""
    port = twin(PORT_ROOT)
    posted = []

    class Driver(port.churn.ChurnDriver):
        def _req(self, method, path, body=None):
            posted.append(body["spec"]["resource"])
            return 201, {}

    drv = Driver("http://127.0.0.1:1", plan=None, group="tpu.composer.dev",
                 version="v1alpha1", wire_mux=False)
    try:
        for model in ("nvidia-h100-sxm", "tpu-v4"):
            drv._arrive(port.churn.ChurnEvent(0.0, port.churn.ARRIVE,
                                              f"r-{model}", model, 1))
    finally:
        drv.close()
    assert posted == [
        {"type": "gpu", "model": "nvidia-h100-sxm", "size": 1},
        {"type": "tpu", "model": "tpu-v4", "size": 1},
    ]
