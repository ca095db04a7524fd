"""The port's survival layer against the JAX package's
(tests/test_overload.py's twin): the store circuit breaker
(tpu_composer_torch/runtime/storebreaker.py), the overload governor
(runtime/overload.py), the subsystem watchdog (runtime/watchdog.py), the
queue's herd re-spread (runtime/queue.py) and the Manager's respawn hook.

Each scenario runs once per package on a fake clock and a seeded
``random.Random`` and returns the breaker's states, its wire-call counts,
its injected sleeps and snapshot, the governor's state sequence and
stretched cadences, the ledger's explain record, the watchdog's scan
counts, restarts and snapshot, and the queue's promoted and re-spread
counts; the scenario also asserts the reference test's invariants.
Tolerance: exact.

The herd scenarios sleep real time (0.05–0.35 s) for the queue's
staleness rule, as the reference does; they compare counts, not times.
"""

from __future__ import annotations

import random
import threading
import time

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def flaky_store(tw):
    """A store stub whose reads fail with StoreError while dark."""
    st = tw.store

    class FlakyStore:
        def __init__(self):
            self.dark = False
            self.calls = 0

        def get(self, cls, name):
            self.calls += 1
            if self.dark:
                raise st.StoreError("dark")
            if name == "missing":
                raise st.NotFoundError(name)
            return name

        def list(self, cls, label_selector=None):
            self.calls += 1
            if self.dark:
                raise st.StoreError("dark")
            return []

        @property
        def scheme(self):
            class _S:
                @staticmethod
                def kinds():
                    return ["Thing"]

                @staticmethod
                def lookup(kind):
                    return object

            return _S()

    return FlakyStore()


def raised(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 - class and message are compared
        return (type(e).__name__, str(e))
    return None


def breaker(tw, inner=None, **kw):
    clk = FakeClock()
    sleeps = []
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("reset_timeout", 5.0)
    b = tw.storebreaker.BreakingStore(
        inner or flaky_store(tw), clock=clk, sleep=sleeps.append,
        rng=random.Random(42), **kw)
    return b, clk, sleeps


def _trip(b):
    b._inner.dark = True
    return [raised(b.get, object, "x") for _ in range(3)]


# -- BreakingStore -------------------------------------------------------------

def trips_after_consecutive_failures_and_fails_fast(tw):
    b, clk, _ = breaker(tw)
    rec = [_trip(b), b.state()]
    wire = b._inner.calls
    err = raised(b.get, object, "x")
    rec += [err[0], "breaker open" in err[1], b._inner.calls - wire]
    assert rec[1] == tw.storebreaker.OPEN and rec[3:] == [True, 0]
    return rec


def conflict_and_notfound_reset_the_streak(tw):
    b, clk, _ = breaker(tw)
    inner = b._inner
    inner.dark = True
    rec = [raised(b.get, object, "x") for _ in range(2)]
    inner.dark = False
    rec.append(b.try_get(object, "missing"))
    inner.dark = True
    rec += [raised(b.get, object, "x") for _ in range(2)]
    rec.append(b.state())
    assert rec[-1] == tw.storebreaker.CLOSED
    return rec


def probe_heals_idle_plane_without_traffic(tw):
    b, clk, _ = breaker(tw)
    inner = b._inner
    _trip(b)
    wire = inner.calls
    rec = [b.is_open(), b.probe(), inner.calls - wire]
    clk.advance(10.0)
    rec += [b.probe(), inner.calls - wire, b.is_open()]
    clk.advance(10.0)
    inner.dark = False
    rec += [b.probe(), b.state(), b.probe()]
    assert rec == [True, False, 0, False, 1, True, True,
                   tw.storebreaker.CLOSED, True]
    return rec


def half_open_probe_closes_on_success(tw):
    b, clk, _ = breaker(tw)
    _trip(b)
    clk.advance(1.0)
    err = raised(b.get, object, "x")
    clk.advance(6.0)
    b._inner.dark = False
    got = b.get(object, "y")
    snap = b.snapshot()
    rec = [err[0], "breaker open" in err[1], got, b.state(), snap]
    assert rec[1:4] == [True, "y", tw.storebreaker.CLOSED]
    assert snap["trips"] == 1 and snap["outage_seconds_total"] >= 7.0
    return rec


def failed_probe_reopens(tw):
    b, clk, _ = breaker(tw)
    _trip(b)
    clk.advance(7.0)
    rec = [raised(b.get, object, "x"), b.state()]
    assert rec == [("StoreError", "dark"), tw.storebreaker.OPEN]
    return rec


def resync_pacing_gates_the_post_heal_herd(tw):
    b, clk, sleeps = breaker(tw, resync_rate=10.0, resync_window=5.0)
    _trip(b)
    clk.advance(7.0)
    b._inner.dark = False

    def sleeping(dt):
        sleeps.append(dt)
        clk.advance(dt)

    b._sleep = sleeping
    rec = [b.get(object, "probe")]
    for i in range(5):
        b.get(object, f"k{i}")
    rec += [list(sleeps), b.snapshot()["resyncs_paced_total"]]
    clk.advance(10.0)
    n = len(sleeps)
    b.get(object, "later")
    rec.append(len(sleeps) - n)
    assert rec[1] and rec[2] >= 5 and rec[3] == 0
    return rec


def watch_passthrough_is_ungated(tw):
    store = tw.store.Store()
    b = tw.storebreaker.BreakingStore(store, failure_threshold=1)
    b._state = tw.storebreaker.OPEN
    q = b.watch("Node")
    store.stop_watch(q)
    assert q is not None
    return q is not None


# -- OverloadGovernor ----------------------------------------------------------

class Cadenced:
    period = 2.0


def governor(tw, **kw):
    # The governor reads process-global gauges; a worker's last busy
    # sample left by an earlier test would trip the Warn signal.
    busy = tw.metrics.worker_busy_ratio
    for labels in busy.label_sets():
        busy.remove(**labels)
    kw.setdefault("enter_ticks", 2)
    kw.setdefault("exit_ticks", 2)
    return tw.overload.OverloadGovernor(rng=random.Random(7), **kw)


def hysteresis_enter_and_step_down(tw):
    g = governor(tw, depth_warn=10, depth_shed=100)
    depth = [0]
    g.add_queue(lambda: depth[0])
    rec = [g.tick()]
    depth[0] = 500
    rec += [g.tick(), g.tick()]
    depth[0] = 0
    rec += [g.tick() for _ in range(4)]
    ov = tw.overload
    assert rec == [ov.OK, ov.OK, ov.SHED, ov.SHED, ov.WARN, ov.WARN, ov.OK]
    return rec


def warn_stretches_and_ok_restores_cadences(tw):
    g = governor(tw, depth_warn=10, depth_shed=100, stretch_factor=4.0)
    target = Cadenced()
    g.stretch(target, "period")
    depth = [50]
    g.add_queue(lambda: depth[0])
    g.tick()
    g.tick()
    rec = [g.state, target.period]
    depth[0] = 0
    g.tick()
    g.tick()
    rec += [g.state, target.period]
    assert rec == [tw.overload.WARN, 8.0, tw.overload.OK, 2.0]
    return rec


def store_breaker_open_is_a_shed_signal(tw):
    class Brk:
        def is_open(self):
            return True

    g = governor(tw, store_breaker=Brk())
    g.tick()
    g.tick()
    snap = g.snapshot()
    rec = [g.state, snap["signals"], snap["transitions"]]
    assert rec[0] == tw.overload.SHED and snap["signals"]["store_breaker_open"]
    return rec


def tick_probes_open_breaker_so_idle_planes_recover(tw):
    clk = FakeClock()
    inner = flaky_store(tw)
    b = tw.storebreaker.BreakingStore(
        inner, failure_threshold=3, reset_timeout=5.0, clock=clk,
        sleep=lambda s: None, rng=random.Random(42))
    _trip(b)
    g = governor(tw, store_breaker=b, enter_ticks=1, exit_ticks=1)
    rec = [b.is_open(), g.tick()]
    inner.dark = False
    clk.advance(10.0)
    rec += [g.tick(), b.state(), g.tick()]
    ov = tw.overload
    assert rec == [True, ov.SHED, ov.WARN, tw.storebreaker.CLOSED, ov.OK]
    return rec


def shed_delay_policy(tw):
    g = governor(tw, priority_cutoff=50, shed_quantum=4.0)
    rec = [g.shed_delay(0)]
    g.state = tw.overload.SHED
    d = g.shed_delay(0)
    rec += [d, g.shed_delay(100), g.shed_delay(0, deleting=True)]
    assert rec[0] is None and 2.0 <= d <= 4.0 and rec[2:] == [None, None]
    return rec


def note_shed_lands_in_the_ledger_with_reason_overload(tw):
    led = tw.ledger.DecisionLedger()
    g = governor(tw, ledger=led)
    g.state = tw.overload.SHED
    for _ in range(3):
        g.note_shed("req-low", priority=0)
    latest = led.explain("req-low")["decisions"][-1]
    rec = [latest["outcome"], latest["binding"], latest["repeats"],
           latest["summary"], g.sheds]
    assert rec[0] == tw.ledger.OUTCOME_HELD_BACK
    assert latest["binding"]["resource"] == latest["binding"]["reason"] \
        == "overload"
    assert rec[2] == 3 and g.sheds == 3
    return rec


def request_shed_gate_reads_priority_and_deletion(tw):
    t = tw.types
    store = tw.store.Store()
    for name, prio in (("low", 0), ("high", 100)):
        store.create(t.ComposabilityRequest(
            metadata=tw.meta.ObjectMeta(name=name),
            spec=t.ComposabilityRequestSpec(
                resource=t.ResourceDetails(type="tpu", model="v4", size=1),
                priority=prio)))
    g = governor(tw, priority_cutoff=50, shed_quantum=4.0)
    gate = tw.overload.request_shed_gate(g, store)
    rec = [gate("low")]
    g.state = tw.overload.SHED
    low = gate("low")
    rec += [low is not None, gate("high"), gate("gone")]
    assert rec == [None, True, None, None]
    return rec + [low]


# -- Watchdog ------------------------------------------------------------------

def slow_but_progressing_never_trips(tw):
    clk = FakeClock()
    wd = tw.watchdog.Watchdog(stall_after=10.0, capture_burst=False, clock=clk)
    wd.register("slowpoke")
    scans = []
    for _ in range(40):
        clk.advance(5.0)
        wd.beat("slowpoke")
        scans.append(wd.scan())
    snap = wd.snapshot()["subsystems"]["slowpoke"]
    assert not any(scans) and snap["stalls"] == 0
    return [scans, snap]


def wedged_subsystem_restarted_exactly_once_per_stall(tw):
    clk = FakeClock()
    restarts = []
    wd = tw.watchdog.Watchdog(stall_after=10.0, restart_budget=3,
                              capture_burst=False, clock=clk)
    wd.register("wedged", restartable=True,
                restart=lambda: restarts.append(1) or True)
    clk.advance(11.0)
    rec = [wd.scan(), len(restarts), wd.scan(), len(restarts)]
    clk.advance(11.0)
    rec += [wd.scan(), len(restarts), wd.snapshot()["subsystems"]["wedged"]]
    assert rec[:6] == [1, 1, 0, 1, 1, 2]
    return rec


def restart_budget_bounds_respawns(tw):
    clk = FakeClock()
    restarts = []
    wd = tw.watchdog.Watchdog(stall_after=10.0, restart_budget=2,
                              capture_burst=False, clock=clk)
    wd.register("chronic", restartable=True,
                restart=lambda: restarts.append(1) or True)
    scans = []
    for _ in range(5):
        clk.advance(11.0)
        scans.append(wd.scan())
    snap = wd.snapshot()["subsystems"]["chronic"]
    assert len(restarts) == 2 and snap["stalls"] >= 3
    return [scans, len(restarts), snap]


def beat_auto_registers_and_unregister_stops_tracking(tw):
    clk = FakeClock()
    wd = tw.watchdog.Watchdog(stall_after=10.0, capture_burst=False, clock=clk)
    wd.beat("anon-worker")
    rec = ["anon-worker" in wd.snapshot()["subsystems"]]
    wd.unregister("anon-worker")
    clk.advance(100.0)
    rec.append(wd.scan())
    assert rec == [True, 0]
    return rec


# -- the queue's herd re-spread ------------------------------------------------

def stale_backoff_herd_released_over_spread_quantum(tw):
    q = tw.queue.RateLimitingQueue(
        base_delay=0.001, jitter=random.Random(3),
        herd_threshold=4, herd_spread=1.0, herd_stale=0.25)
    for i in range(20):
        q.add_rate_limited(f"k{i}")
    time.sleep(0.35)
    with q._cond:
        q._promote_ready(time.monotonic())
        promoted = len(q._queue)
        remaining = [t for t, _, _, _ in q._delayed]
    now = time.monotonic()
    rec = [promoted, len(remaining),
           all(now - 0.01 <= t <= now + 1.05 for t in remaining),
           max(remaining) - min(remaining) > 0.2]
    assert rec == [4, 16, True, True]
    return rec


def fresh_backoff_entries_promote_unthrottled(tw):
    q = tw.queue.RateLimitingQueue(
        base_delay=0.001, jitter=random.Random(3),
        herd_threshold=4, herd_spread=1.0, herd_stale=0.25)
    for i in range(20):
        q.add_rate_limited(f"k{i}")
    time.sleep(0.05)
    with q._cond:
        q._promote_ready(time.monotonic())
        rec = [len(q._queue), len(q._delayed)]
    assert rec == [20, 0]
    return rec


def plain_add_after_entries_never_re_spread(tw):
    q = tw.queue.RateLimitingQueue(
        base_delay=0.001, jitter=random.Random(3),
        herd_threshold=2, herd_spread=5.0, herd_stale=0.25)
    for i in range(10):
        q.add_after(f"poll{i}", 0.01)
    time.sleep(0.35)
    with q._cond:
        q._promote_ready(time.monotonic())
        rec = len(q._queue)
    assert rec == 10
    return rec


# -- the Manager's respawn hook ------------------------------------------------

def manager_respawn_hook_restarts_a_dead_runnable(tw):
    runs = []
    lives = threading.Semaphore(0)

    class Flaky:
        def run(self, stop_event):
            runs.append(threading.current_thread().name)
            lives.release()
            if len(runs) > 1:
                stop_event.wait(30)

    wd = tw.watchdog.Watchdog(stall_after=30.0, capture_burst=False)
    mgr = tw.manager.Manager(tw.store.Store(), watchdog=wd)
    mgr.add_runnable(Flaky().run)
    mgr.start()
    try:
        rec = [lives.acquire(timeout=5), wd.restarter is not None,
               wd.restarter("Flaky"), lives.acquire(timeout=5), list(runs),
               wd.restarter("NoSuchRunnable")]
    finally:
        mgr.stop()
    assert rec == [True, True, True, True, ["Flaky", "Flaky"], False]
    return rec


def debug_routes_answer_or_503(tw):
    """The Manager's survival routes: 200 with the collaborator's snapshot
    when it is wired, the reference's 503 when it is off."""
    import json
    import urllib.error
    import urllib.request

    def get(port, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    store = tw.store.Store()
    brk = tw.storebreaker.BreakingStore(store)
    gov = tw.overload.OverloadGovernor(store_breaker=brk, rng=random.Random(7))
    wd = tw.watchdog.Watchdog(capture_burst=False)
    on = tw.manager.Manager(store=brk, health_addr="127.0.0.1:0",
                            overload=gov, watchdog=wd, storebreaker=brk,
                            profiler=tw.profiler.SamplingProfiler())
    off = tw.manager.Manager(store=tw.store.Store(), health_addr="127.0.0.1:0")
    off.profiler = None
    rec = []
    for mgr in (on, off):
        mgr.start()
        try:
            for path in ("/debug/overload", "/debug/watchdog",
                         "/debug/storebreaker", "/debug/profile/continuous"):
                code, body = get(mgr.health_port, path)
                rec.append((path, code, sorted(body) if code == 200 else body))
            code, body = get(mgr.health_port, "/debug")
            rec.append(("/debug", code, sorted(body)))
        finally:
            mgr.stop()
    assert [r[1] for r in rec] == [200] * 5 + [503] * 4 + [200]
    return rec


SCENARIOS = [
    trips_after_consecutive_failures_and_fails_fast,
    conflict_and_notfound_reset_the_streak,
    probe_heals_idle_plane_without_traffic,
    half_open_probe_closes_on_success,
    failed_probe_reopens,
    resync_pacing_gates_the_post_heal_herd,
    watch_passthrough_is_ungated,
    hysteresis_enter_and_step_down,
    warn_stretches_and_ok_restores_cadences,
    store_breaker_open_is_a_shed_signal,
    tick_probes_open_breaker_so_idle_planes_recover,
    shed_delay_policy,
    note_shed_lands_in_the_ledger_with_reason_overload,
    request_shed_gate_reads_priority_and_deletion,
    slow_but_progressing_never_trips,
    wedged_subsystem_restarted_exactly_once_per_stall,
    restart_budget_bounds_respawns,
    beat_auto_registers_and_unregister_stops_tracking,
    stale_backoff_herd_released_over_spread_quantum,
    fresh_backoff_entries_promote_unthrottled,
    plain_add_after_entries_never_re_spread,
    manager_respawn_hook_restarts_a_dead_runnable,
    debug_routes_answer_or_503,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port
