"""The port's controller runtime (tpu_composer_torch/runtime/) against the
JAX package's (tests/test_runtime.py's twin): the work queue (its backoff
drawn from the same seeded ``random.Random`` on both sides), the
controller loop, leader election, the metrics registry and the Manager's
health server. Each scenario runs on both packages and the observable
results must be equal; times are held to bounds, not compared. The port's
globals (metrics registry, trace ring, lifecycle recorder) are its own.
"""

from __future__ import annotations

import random
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import (JAX_ROOT, PORT_ROOT, ROOTS, run_both, twin,
                                  wait_for)

torch.set_num_threads(1)


def _req(tw, name="req-1"):
    t = tw.types
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(type="tpu", model="tpu-v4", size=1)))


# -- the work queue ---------------------------------------------------------

def q_dedup(tw):
    q = tw.queue.RateLimitingQueue()
    q.add("a")
    q.add("a")
    return [q.get(timeout=0.1), q.get(timeout=0.05), len(q)]


def q_readd_while_processing(tw):
    q = tw.queue.RateLimitingQueue()
    q.add("a")
    key = q.get(timeout=0.1)
    q.add("a")  # in flight: dirty
    out = [key, q.get(timeout=0.05)]
    q.done(key)
    return out + [q.get(timeout=0.1)]


def q_add_after(tw):
    q = tw.queue.RateLimitingQueue()
    t0 = time.monotonic()
    q.add_after("a", 0.15)
    early = q.get(timeout=0.05)
    late = q.get(timeout=1.0)
    return [early, late, time.monotonic() - t0 >= 0.15]


def q_backoff(tw):
    """The decorrelated-jitter delays, drawn from one seeded generator."""
    q = tw.queue.RateLimitingQueue(base_delay=0.05, max_delay=1.0,
                                   jitter=random.Random(7))
    delays = []
    for _ in range(6):
        q.add_rate_limited("a")
        delays.append(q._last_delay["a"])
    out = [q.retries("a"), delays]
    q.forget("a")
    return out + [q.retries("a"), q.get(timeout=0.3)]


def q_forget_then_new_failure(tw):
    q = tw.queue.RateLimitingQueue(base_delay=0.03, max_delay=0.1)
    q.add_rate_limited("a")
    q.forget("a")
    q.add_rate_limited("a")
    first = q.get(timeout=1.0)
    q.done("a")
    return [first, q.get(timeout=0.2)]


def q_forget_leaves_add_after(tw):
    q = tw.queue.RateLimitingQueue()
    q.add_after("a", 0.1)
    q.forget("a")
    return [q.get(timeout=1.0)]


def q_fifo(tw):
    q = tw.queue.RateLimitingQueue()
    for i in range(500):
        q.add(i)
    return [q.get(timeout=0.1) for _ in range(500)]


def q_shutdown(tw):
    q = tw.queue.RateLimitingQueue()
    out = []
    t = threading.Thread(target=lambda: out.append(q.get()))
    t.start()
    time.sleep(0.05)
    q.shutdown()
    t.join(timeout=1)
    q.add("late")  # a stopped queue accepts nothing
    return [out, t.is_alive(), len(q)]


QUEUE = [q_dedup, q_readd_while_processing, q_add_after, q_backoff,
         q_forget_then_new_failure, q_forget_leaves_add_after, q_fifo,
         q_shutdown]


@pytest.mark.parametrize("scenario", QUEUE, ids=lambda f: f.__name__)
def test_queue_twin(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_backoff_grows_within_its_bounds():
    _, (retries, delays, *_) = run_both(q_backoff)
    assert retries == 6
    assert all(0.05 <= d <= 1.0 for d in delays) and delays[-1] > delays[0]


# -- the controller loop ----------------------------------------------------

def _controller(tw, fail_first=0, requeue_once=False, primary="ComposabilityRequest"):
    class Counting(tw.controller.Controller):
        primary_kind = primary

        def __init__(self, store):
            super().__init__(store)
            self.seen = []
            self.done = threading.Event()

        def reconcile(self, name):
            self.seen.append(name)
            if len(self.seen) <= fail_first:
                raise RuntimeError("boom")
            if requeue_once and len(self.seen) == 1:
                return tw.controller.Result(requeue_after=0.05)
            self.done.set()
            return tw.controller.Result()

    return Counting


def loop_events(tw):
    store = tw.store.Store()
    c = _controller(tw)(store)
    c.start()
    try:
        store.create(_req(tw))
        assert c.done.wait(5)
        return c.seen
    finally:
        c.stop()


def loop_initial_wave(tw):
    store = tw.store.Store()
    store.create(_req(tw, "pre-existing"))
    c = _controller(tw)(store)
    c.start()
    try:
        assert c.done.wait(5)
        return c.seen
    finally:
        c.stop()


def loop_secondary_watch(tw):
    store = tw.store.Store()
    c = _controller(tw, primary="")(store)
    c.watch("ComposabilityRequest",
            mapper=lambda ev: [f"mapped-{ev.obj.metadata.name}"],
            predicate=lambda ev: ev.obj.metadata.name != "skip")
    c.start()
    try:
        store.create(_req(tw, "skip"))
        store.create(_req(tw, "take"))
        assert c.done.wait(5)
        time.sleep(0.1)
        return c.seen
    finally:
        c.stop()


def loop_error_backoff(tw):
    store = tw.store.Store()
    c = _controller(tw, fail_first=2)(store)
    c.start()
    try:
        store.create(_req(tw))
        assert c.done.wait(5)
        return c.seen
    finally:
        c.stop()


def loop_requeue_after(tw):
    store = tw.store.Store()
    c = _controller(tw, requeue_once=True)(store)
    c.start()
    try:
        store.create(_req(tw))
        assert c.done.wait(5)
        return c.seen
    finally:
        c.stop()


LOOP = [loop_events, loop_initial_wave, loop_secondary_watch,
        loop_error_backoff, loop_requeue_after]


@pytest.mark.parametrize("scenario", LOOP, ids=lambda f: f.__name__)
def test_controller_loop_twin(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out and port_out


# -- the manager ------------------------------------------------------------

def _get(port, path):
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def manager_health(tw):
    store = tw.store.Store()
    m = tw.manager.Manager(store=store, health_addr="127.0.0.1:0")
    c = _controller(tw)(store)
    m.add_controller(c)
    ran = threading.Event()
    m.add_runnable(lambda stop: (ran.set(), stop.wait(5)))
    hooked = []
    m.add_startup_hook(lambda: hooked.append(c.done.is_set()))
    out = [m.ready()]
    m.start()
    try:
        port = m.health_port
        store.create(_req(tw))
        assert c.done.wait(5) and ran.wait(5)
        out.append(hooked)
        for path in ("/healthz", "/readyz", "/nope"):
            out.append((path, *_get(port, path)))
        code, metrics = _get(port, "/metrics")
        out.append(("/metrics", code, "tpuc_attach_to_ready_seconds" in metrics,
                    "tpuc_reconcile_duration_seconds" in metrics or
                    "tpuc_queue_wait_seconds" in metrics))
        code, body = _get(port, "/debug/traces/summary")
        out.append(("/debug/traces/summary", code))
        # The lifecycle watch records the request's timeline.
        out.append(("/debug/requests/req-1", wait_for(
            lambda: _get(port, "/debug/requests/req-1")[0] == 200, timeout=5)))
        out.append(("/debug/requests/nope", _get(port, "/debug/requests/nope")[0]))
    finally:
        m.stop()
    out.append(m.ready())
    out.append(m.health_port)
    return out


def test_manager_health_endpoints_twin():
    jax_out, port_out = run_both(manager_health)
    assert port_out == jax_out
    assert port_out[2] == ["/healthz", 200, "ok"]
    assert port_out[3] == ["/readyz", 200, "ok"]
    assert port_out[7] == ["/debug/requests/req-1", True]


@pytest.mark.parametrize("root", ROOTS)
def test_manager_stops_runnables_and_leader_lock(root, tmp_path):
    tw = twin(root)
    stopped = threading.Event()

    def runnable(stop_event):
        stop_event.wait(5)
        stopped.set()

    lock = str(tmp_path / "leader.lock")
    m = tw.manager.Manager(store=tw.store.Store(), leader_elect=True,
                           leader_lock_path=lock)
    m.add_runnable(runnable)
    m.start()
    other = tw.leader.LeaderElector(lock)
    held = other.try_acquire()
    m.stop()
    assert stopped.wait(1) and not held
    assert other.try_acquire()
    other.release()


def leader(tw, tmp):
    path = str(tmp / f"{tw.root}.lock")
    a, b = tw.leader.LeaderElector(path), tw.leader.LeaderElector(path)
    out = [a.try_acquire(), b.try_acquire(), a.is_leader, b.is_leader]
    a.release()
    out += [b.try_acquire(), b.is_leader]
    b.release()
    return out


def test_leader_election_twin(tmp_path):
    jax_out, port_out = run_both(leader, tmp_path)
    assert port_out == jax_out == [True, False, True, False, True, True]


def registry(tw):
    r = tw.metrics.Registry()
    r.counter("c_total", "help").inc(controller="x")
    r.counter("c_total", "help").inc(2, err='quo"te\\back\nnewline')
    r.gauge("g", "help").set(3.5, node="n0")
    h = r.histogram("h_seconds", "help", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, op="attach")
    h.observe(0.2, op="detach")
    return [r.expose_text(), h.count(op="attach"), h.percentile(0.5, op="attach")]


def test_metrics_exposition_twin():
    jax_out, port_out = run_both(registry)
    assert port_out == jax_out
    assert 'h_seconds_bucket{op="attach",le="+Inf"} 3' in port_out[0]


def test_the_port_keeps_its_own_globals():
    """Twin tests run both runtimes in one process: each has its own
    metrics registry, trace ring and lifecycle recorder."""
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    assert port.metrics.global_registry is not jax.metrics.global_registry
    assert port.lifecycle.recorder is not jax.lifecycle.recorder
    assert port.tracing is not jax.tracing
    port.metrics.reconcile_total.inc(controller="twin-probe", outcome="ok")
    assert "twin-probe" in port.metrics.global_registry.expose_text()
    assert "twin-probe" not in jax.metrics.global_registry.expose_text()
    # Each package registers its own crash hooks, once.
    jax.lifecycle.install()
    port.lifecycle.install()
    assert port.lifecycle._installed and jax.lifecycle._installed
    assert port.lifecycle._thread_hook is not jax.lifecycle._thread_hook
