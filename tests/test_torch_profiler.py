"""The port's control-plane observatory against the JAX package's
(tests/test_profiler.py's twin): the sampling profiler
(tpu_composer_torch/runtime/profiler.py), the lock-contention telemetry
(runtime/contention.py), the queue's wait histogram and the Manager's
``/debug/profile*`` routes.

Each scenario runs once per package and returns structure and
attribution: the subsystem bucket of every thread name, observation
counts, which subsystems a sampled wave attributed, the keys of the
summaries and the routes served. The profiler reads per-thread CPU time
from ``/proc`` and samples on wall time, so ratios, sample counts and
times are never compared; the scenario asserts the reference test's
bounds on them (a spinning thread is not all blocked samples, a parked
condition records no long wait) on each package. Tolerance: exact.

Not twinned: the ``/debug/slo`` half of the endpoint test (the SLO engine
comes with the fleet plane).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from tests.torch_operator import run_both, wait_for

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

THREAD_NAMES = [
    "fabric-dispatch-3", "ComposableResourceReconciler-worker-0",
    "ComposabilityRequestReconciler-dispatch-Node", "UpstreamSyncer",
    "lease-renew", "shard-lease-renew", "fabric-events-fabric",
    "FabricSession", "informer-ComposableResource", "kubecache-Node",
    "lifecycle-watch", "health", "profiler", "slo-engine", "MainThread",
    "Thread-4 (process_request_thread)", "Thread-17", "FabricDispatcher",
    "DefragLoop", "leader-watchdog", "metrics",
]


def names_map_to_stable_buckets(tw):
    out = {n: tw.profiler.subsystem_for(n) for n in THREAD_NAMES}
    assert out["shard-lease-renew"] == "elector" and out["Thread-17"] == "other"
    return out


# -- ObservedLock and the busy tracker -----------------------------------------

def wait_and_hold_observed_once_per_outermost_pair(tw):
    m = tw.metrics
    lk = tw.contention.ObservedLock("t_ol_reent", reentrant=True)
    h0 = m.lock_hold_seconds.count(lock="t_ol_reent")
    w0 = m.lock_wait_seconds.count(lock="t_ol_reent")
    with lk:
        with lk:
            pass
    rec = [m.lock_hold_seconds.count(lock="t_ol_reent") - h0,
           m.lock_wait_seconds.count(lock="t_ol_reent") - w0]
    assert rec == [1, 1]
    return rec


def contended_acquire_records_the_wait(tw):
    lk = tw.contention.ObservedLock("t_ol_contend")
    release, held = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(2.0)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(2.0)
    t0 = time.perf_counter()
    threading.Timer(0.05, release.set).start()
    with lk:
        waited = time.perf_counter() - t0
    t.join()
    p100 = tw.metrics.lock_wait_seconds.percentile(1.0, lock="t_ol_contend")
    rec = [waited >= 0.04, p100 is not None and p100 >= 0.04]
    assert rec == [True, True]
    return rec


def condition_park_is_not_wait_or_hold(tw):
    lk = tw.contention.ObservedLock("t_ol_park", reentrant=True)
    cond = threading.Condition(lk)

    def parker():
        with cond:
            cond.wait(timeout=0.3)

    t = threading.Thread(target=parker)
    t.start()
    t.join()
    rec = []
    for hist in (tw.metrics.lock_wait_seconds, tw.metrics.lock_hold_seconds):
        worst = hist.percentile(1.0, lock="t_ol_park")
        rec.append(worst is not None and worst < 0.25)
    assert rec == [True, True]
    return rec


def disabled_mode_observes_nothing_but_still_locks(tw):
    m = tw.metrics
    tw.contention.set_enabled(False)
    try:
        lk = tw.contention.ObservedLock("t_ol_off")
        with lk:
            pass
        rec = [m.lock_hold_seconds.count(lock="t_ol_off"),
               m.lock_wait_seconds.count(lock="t_ol_off"),
               lk.acquire(blocking=False)]
        lk.release()
    finally:
        tw.contention.set_enabled(True)
    assert rec == [0, 0, True]
    return rec


def busy_tracker_sets_the_gauge_after_a_window(tw):
    tr = tw.contention.BusyTracker("t_pool", workers=2, window=0.01)
    tr.add(0.02)
    time.sleep(0.02)
    tr.add(0.02)
    ratio = tw.metrics.worker_busy_ratio.value(pool="t_pool")
    assert 0.0 < ratio <= 1.0
    return 0.0 < ratio <= 1.0


def enqueue_to_dequeue_wait_is_observed(tw):
    qw = tw.metrics.queue_wait_seconds
    q = tw.queue.RateLimitingQueue(name="t_queue_wait")
    before = qw.count(queue="t_queue_wait")
    q.add("k1")
    time.sleep(0.03)
    rec = [q.get(timeout=1.0), qw.count(queue="t_queue_wait") - before]
    worst = qw.percentile(1.0, queue="t_queue_wait")
    rec.append(worst is not None and worst >= 0.02)
    assert rec == ["k1", 1, True]
    return rec


def delayed_entries_time_from_promotion_not_add_after(tw):
    q = tw.queue.RateLimitingQueue(name="t_queue_delay")
    q.add_after("k1", 0.1)
    rec = [q.get(timeout=2.0)]
    worst = tw.metrics.queue_wait_seconds.percentile(1.0, queue="t_queue_delay")
    rec.append(worst is not None and worst < 0.09)
    assert rec == ["k1", True]
    return rec


# -- the sampler ---------------------------------------------------------------

#: Sampler ticks of the busy-thread burst; each lands after the spinner
#: has finished another lap of its loop, however the host schedules it.
BURST_TICKS = 50

_BURST_CHILD = r"""
import importlib, json, sys, threading, time
profiler = importlib.import_module(sys.argv[1] + ".runtime.profiler")
stop, running = threading.Event(), threading.Event()
laps = [0]


def spin():
    while not stop.is_set():
        sum(i * i for i in range(500))
        laps[0] += 1
        if laps[0] == 1:
            running.set()


t = threading.Thread(target=spin, name="CRR-worker-0")
t.start()
try:
    assert running.wait(60.0), "the spinner never ran"
    prof = profiler.SamplingProfiler(interval=0.005, window_s=3600.0)
    prof._own_ident = threading.get_ident()
    for _ in range(int(sys.argv[2])):
        seen = laps[0]
        while laps[0] == seen:
            time.sleep(0.0005)
        prof.sample_once()
finally:
    stop.set()
    t.join()
rw = prof.thread_summary()["reconcile-worker"]
top = prof.top(5)
stack, count = prof.collapsed().splitlines()[0].rsplit(" ", 1)
print(json.dumps([
    rw["samples"] > 0, rw["blocked_samples"] < rw["samples"],
    any("spin" in f["frame"] or "genexpr" in f["frame"] for f in top),
    int(count) > 0 and ";" in stack, sorted(rw), sorted(top[0])]))
"""


def burst_catches_a_busy_thread_with_cpu_split(tw):
    """A burst sampler (``profile_burst``'s: interval 5 ms, the calling
    thread excluded) ticks BURST_TICKS times while a thread spins, in a
    fresh interpreter. The ticks are paced by the spinner's laps, not by
    the wall clock, so a loaded host cannot starve the spinner out of the
    sample; and the process holds only the spinner and the sampler, so no
    thread another test left behind crowds the spinner out of the top
    frames."""
    res = subprocess.run(
        [sys.executable, "-c", _BURST_CHILD, tw.root, str(BURST_TICKS)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.splitlines()[-1])
    assert rec[:4] == [True, True, True, True]
    return rec


def window_ring_is_bounded(tw):
    prof = tw.profiler.SamplingProfiler(interval=0.001, window_s=0.001, ring=3)
    prof._own_ident = -1
    for _ in range(30):
        prof.sample_once()
        time.sleep(0.002)
    assert len(prof.windows()) <= 4
    return len(prof.windows()) <= 4


def dump_file_writes_the_ring(tw, root):
    prof = tw.profiler.SamplingProfiler(interval=0.005)
    prof._own_ident = -1
    for _ in range(3):
        prof.sample_once()
    old = tw.profiler._active
    tw.profiler._active = prof
    try:
        out = root / f"{tw.root}-profile.json"
        written = tw.profiler.dump_file(str(out))
    finally:
        tw.profiler._active = old
    doc = json.loads(out.read_text())
    rec = [written == str(out), sorted(doc), doc["interval_s"]]
    assert rec[0] and "summary" in doc and doc["interval_s"] == 0.005
    return rec


def crash_dump_writes_the_profile_ring(tw, root):
    """``lifecycle.dump_crash`` leaves the active profiler's ring beside
    the flight and trace black boxes ($TPUC_PROFILE_FILE)."""
    import os

    prof = tw.profiler.SamplingProfiler(interval=0.005)
    prof._own_ident = -1
    prof.sample_once()
    out = root / f"{tw.root}-crash-profile.json"
    old_active, old_env = tw.profiler._active, os.environ.get("TPUC_PROFILE_FILE")
    tw.profiler._active = prof
    os.environ["TPUC_PROFILE_FILE"] = str(out)
    try:
        tw.lifecycle.dump_crash("test")
    finally:
        tw.profiler._active = old_active
        if old_env is None:
            os.environ.pop("TPUC_PROFILE_FILE", None)
        else:
            os.environ["TPUC_PROFILE_FILE"] = old_env
    return sorted(json.loads(out.read_text()))


# -- the sampler under a wave, and the routes ----------------------------------

def _wave_world(tw, children=32):
    t = tw.types
    store = tw.store.Store()
    n = t.Node(metadata=tw.meta.ObjectMeta(name="wave-node"))
    n.status.tpu_slots = children
    store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": children})
    dispatcher = tw.dispatcher.FabricDispatcher(
        pool, batch_window=0.02, poll_interval=0.01, concurrency=8)
    session = tw.fevents.FabricSession(pool, poll_timeout=0.5, retry_base=0.01)
    dispatcher.attach_session(session)
    mgr = tw.manager.Manager(
        store=store, health_addr="127.0.0.1:0",
        profiler=tw.profiler.SamplingProfiler(interval=0.005, window_s=0.25))
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, pool, tw.fake.FakeNodeAgent(pool=pool), dispatcher=dispatcher,
        timing=tw.rc.ResourceTiming(attach_poll=0.01, visibility_poll=0.01,
                                    detach_poll=0.01, detach_fast=0.01,
                                    busy_poll=0.01)))
    mgr.add_runnable(dispatcher.run)
    mgr.add_runnable(session.run)
    mgr.add_runnable(tw.syncer.UpstreamSyncer(store, pool, period=0.1))
    return store, dispatcher, mgr


SUBSYSTEMS = ("reconcile-worker", "dispatcher-lane", "syncer", "session",
              "watch-dispatch", "lifecycle")


def wave_converges_with_sampler_on_and_all_subsystems_attributed(tw):
    t = tw.types
    store, dispatcher, mgr = _wave_world(tw)
    mgr.start(workers_per_controller=4)
    try:
        names = [f"w-{i}" for i in range(32)]
        for name in names:
            store.create(t.ComposableResource(
                metadata=tw.meta.ObjectMeta(name=name),
                spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                              target_node="wave-node")))

        def online():
            return all((r := store.try_get(t.ComposableResource, n)) is not None
                       and r.status.state == "Online" for n in names)

        rec = [wait_for(online, timeout=30, interval=0.01)]
        time.sleep(0.3)
        summary = mgr.profiler.thread_summary()
        rw = summary["reconcile-worker"]
        rec += [sorted(s for s in SUBSYSTEMS if s in summary),
                rw["wall_s"] > 0, rw["gil_wait_s"] >= 0.0,
                bool(mgr.profiler.collapsed())]
    finally:
        mgr.stop()
        dispatcher.stop()
    assert rec == [True, sorted(SUBSYSTEMS), True, True, True]
    return rec


def debug_endpoints_serve_the_observatory(tw):
    store, dispatcher, mgr = _wave_world(tw, children=4)
    mgr.start(workers_per_controller=2)
    try:
        port = mgr.health_port

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
                return resp.read().decode()

        idx = json.loads(get("/debug"))
        rec = [[r for r in ("/debug/profile", "/debug/profile/continuous",
                            "/debug/traces") if r in idx["endpoints"]]]
        time.sleep(0.3)
        cont = json.loads(get("/debug/profile/continuous"))
        burst = json.loads(get("/debug/profile?seconds=0.2"))
        folded = get("/debug/profile?seconds=0.2&format=collapsed")
        as_json = json.loads(get("/debug/profile?seconds=0.1&format=json"))
        rec += [sorted(cont), bool(cont["windows"]), sorted(burst),
                bool(burst["threads"]),
                all(line.rsplit(" ", 1)[1].isdigit()
                    for line in folded.splitlines() if line),
                sorted(as_json)]
    finally:
        mgr.stop()
        dispatcher.stop()
    assert rec[0] == ["/debug/profile", "/debug/profile/continuous",
                      "/debug/traces"]
    assert rec[2] and rec[4] and rec[5]
    return rec


def profile_disabled_constructs_no_observatory(tw):
    prev = tw.profiler.enabled()
    tw.profiler.set_enabled(False)
    try:
        off = tw.manager.Manager(store=tw.store.Store()).profiler
    finally:
        tw.profiler.set_enabled(prev)
    on = tw.manager.Manager(store=tw.store.Store()).profiler
    rec = [off, type(on).__name__]
    assert rec == [None, "SamplingProfiler"]
    return rec


SCENARIOS = [
    names_map_to_stable_buckets,
    wait_and_hold_observed_once_per_outermost_pair,
    contended_acquire_records_the_wait,
    condition_park_is_not_wait_or_hold,
    disabled_mode_observes_nothing_but_still_locks,
    busy_tracker_sets_the_gauge_after_a_window,
    enqueue_to_dequeue_wait_is_observed,
    delayed_entries_time_from_promotion_not_add_after,
    burst_catches_a_busy_thread_with_cpu_split,
    window_ring_is_bounded,
    wave_converges_with_sampler_on_and_all_subsystems_attributed,
    debug_endpoints_serve_the_observatory,
    profile_disabled_constructs_no_observatory,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port


@pytest.mark.parametrize("scenario", [dump_file_writes_the_ring,
                                      crash_dump_writes_the_profile_ring],
                         ids=lambda f: f.__name__)
def test_dump_matches_jax(scenario, tmp_path):
    jax, port = run_both(scenario, tmp_path)
    assert jax == port
