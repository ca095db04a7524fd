"""The port's lock-order witness against the JAX package's (the twin of
tests/test_analysis.py's ``TestLockdepUnits``, ``TestAbbaRegression``
and ``TestLockdepEndpoint``): cycle detection, strict mode, transitive
cycles, reentrancy, same-class nesting, cond-park bookkeeping, declared
orders, failed non-blocking acquires, report dedup, the snapshot dump,
witness swaps, the ABBA regression with two real threads, the suite's
standing witness, and ``/debug/lockdep`` on the Manager.

Each scenario runs once per package (``run_both``) with that package's
``analysis.lockdep`` and ``runtime.contention.ObservedLock`` and returns
the structure the reference asserts on: report kinds, closing edges,
cycles, thread names, edges and counters (never the stacks' text, which
names each package's files). Tolerance: exact.

The suite witness of the port is the one ``tests/torch_operator.py``
enables, strict, for the port's operator twins.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)


def _edges(w):
    return sorted((e["held"], e["acquired"]) for e in w.snapshot()["edges"])


def _report(r):
    return {k: r.get(k) for k in ("kind", "closing_edge", "cycle", "thread",
                                  "declared")}


# ---------------------------------------------------------------------------
# unit semantics
# ---------------------------------------------------------------------------

def two_lock_cycle_detected_nonstrict(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=False) as w:
        a, b = ObservedLock("a"), ObservedLock("b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert len(w.reports) == 1
        report = w.reports[0]
        assert report["kind"] == "cycle"
        assert report["closing_edge"] == {"held": "b", "acquired": "a"}
        text = lockdep.format_report(report)
        assert "prior edge a -> b" in text and "acquisition stack" in text
        return [_report(r) for r in w.reports], _edges(w)


def strict_mode_raises_at_the_closing_acquire(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        a, b = ObservedLock("a"), ObservedLock("b")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(lockdep.LockOrderViolation):
                a.acquire()
        return [_report(r) for r in w.reports]


def transitive_cycle_through_three_classes(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=False) as w:
        a, b, c = ObservedLock("a"), ObservedLock("b"), ObservedLock("c")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
        assert len(w.reports) == 1
        assert w.reports[0]["cycle"] == ["a", "b", "c", "a"]
        return [_report(r) for r in w.reports], _edges(w)


def reentrant_reacquire_is_not_an_ordering_event(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        lock = ObservedLock("r", reentrant=True)
        with lock:
            with lock:
                pass
        assert w.snapshot()["edges"] == [] and w.reports == []
        return w.snapshot()


def same_class_nesting_is_counted_not_cycled(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        s1, s2 = ObservedLock("store"), ObservedLock("store")
        with s1:
            with s2:
                pass
        assert w.reports == [] and w.nested_same_class == 1
        return w.nested_same_class, _edges(w)


def cond_park_releases_the_held_entry(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        cond_lock = ObservedLock("cond", reentrant=True)
        cond = threading.Condition(cond_lock)
        other = ObservedLock("other")
        woke = []

        def waiter():
            with cond:
                cond.wait(timeout=2.0)
            with other:
                woke.append(True)

        t = threading.Thread(target=waiter, name="lockdep-park")
        t.start()
        time.sleep(0.05)
        with cond:
            cond.notify_all()
        t.join(timeout=5)
        assert woke
        assert ("cond", "other") not in _edges(w) and w.reports == []
        return woke, _edges(w)


def declared_order_raises_without_a_full_cycle(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        w.declare_order("store", "informer:*")
        store = ObservedLock("store", reentrant=True)
        informer = ObservedLock("informer:composableresources")
        with store:
            with informer:
                pass
        with informer:
            with pytest.raises(lockdep.LockOrderViolation) as exc:
                store.acquire()
        assert "declared" in str(exc.value)
        assert w.reports[0]["kind"] == "declared-order"
        return [_report(r) for r in w.reports]


def failed_nonblocking_acquire_leaves_no_phantom_hold(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        contended = ObservedLock("contended")
        other = ObservedLock("other2")
        contended.acquire()
        try:
            fail = []

            def contender():
                fail.append(contended.acquire(blocking=False))
                with other:
                    pass

            t = threading.Thread(target=contender, name="lockdep-fail")
            t.start()
            t.join(timeout=5)
            assert fail == [False]
            assert ("contended", "other2") not in _edges(w)
        finally:
            contended.release()
        return fail, _edges(w)


def report_dedup_one_report_per_bad_edge(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=False) as w:
        a, b = ObservedLock("a"), ObservedLock("b")
        with a:
            with b:
                pass
        for _ in range(5):
            with b:
                with a:
                    pass
        assert len(w.reports) == 1
        return [_report(r) for r in w.reports]


def snapshot_dump_roundtrip(tw, tmp_path):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=False) as w:
        a, b = ObservedLock("a"), ObservedLock("b")
        with a:
            with b:
                pass
        path = tmp_path / f"lockdep-{tw.root}.json"
        w.dump(str(path))
        doc = json.loads(path.read_text())
        assert doc["classes"] == ["a", "b"]
        assert doc["edges"][0]["held"] == "a"
        assert doc["edges"][0]["acquired"] == "b"
        assert doc["edges"][0]["stack"]
        doc["edges"] = [{k: v for k, v in e.items() if k != "stack"}
                        for e in doc["edges"]]
        return doc


def scoped_witness_restores_the_suite_witness(tw):
    lockdep = tw.lockdep
    before = lockdep.current()
    with lockdep.scoped_witness(strict=False) as w:
        assert lockdep.current() is w
    assert lockdep.current() is before
    return before is not None


def held_stack_survives_a_witness_swap(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as outer_w:
        lock = ObservedLock("swap-held")
        other = ObservedLock("swap-other")
        lock.acquire()
        with lockdep.scoped_witness(strict=True):
            lock.release()
        with other:
            pass
        assert ("swap-held", "swap-other") not in _edges(outer_w)
        return _edges(outer_w)


# ---------------------------------------------------------------------------
# the ABBA regression: two real threads, opposite orders
# ---------------------------------------------------------------------------

def _run_both_orders(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    store = ObservedLock("store", reentrant=True)
    informer = ObservedLock("informer:composableresources")
    first_done = threading.Event()
    caught = []

    def admission_hook_path():
        with store:
            with informer:
                pass
        first_done.set()

    def lazy_informer_start_path():
        first_done.wait(timeout=5)
        try:
            with informer:
                with store:
                    pass
        except lockdep.LockOrderViolation as e:
            caught.append(e)

    t1 = threading.Thread(target=admission_hook_path, name="admission-hook")
    t2 = threading.Thread(target=lazy_informer_start_path,
                          name="informer-start")
    t1.start()
    t2.start()
    t1.join(timeout=5)
    t2.join(timeout=5)
    return caught


def witness_catches_the_abba_shape(tw):
    with tw.lockdep.scoped_witness(strict=True) as w:
        caught = _run_both_orders(tw)
        assert caught, "witness missed the ABBA shape"
        assert len(w.reports) == 1
        report = w.reports[0]
        assert report["kind"] == "cycle"
        assert set(report["cycle"]) == {"store",
                                        "informer:composableresources"}
        assert report["thread"] == "informer-start"
        assert report["evidence"][0]["thread"] == "admission-hook"
        return [_report(r) for r in w.reports], len(caught)


def declared_order_catches_it_even_first(tw):
    lockdep, ObservedLock = tw.lockdep, tw.contention.ObservedLock
    with lockdep.scoped_witness(strict=True) as w:
        w.declare_order("store", "informer:*")
        store = ObservedLock("store", reentrant=True)
        informer = ObservedLock("informer:composableresources")
        with informer:
            with pytest.raises(lockdep.LockOrderViolation):
                store.acquire()
        assert w.reports[0]["kind"] == "declared-order"
        return [_report(r) for r in w.reports]


def suite_witness_runs_and_declares_the_store_order(tw):
    w = tw.lockdep.current()
    if w is None:
        pytest.skip("suite lockdep disabled via TPUC_LOCKDEP=0")
    declared = {(d["earlier"], d["later"]) for d in w.snapshot()["declared"]}
    assert ("store", "informer:*") in declared
    assert w.strict
    return sorted(declared), w.strict


# ---------------------------------------------------------------------------
# /debug/lockdep endpoint
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.read().decode()


def debug_lockdep_serves_the_graph(tw):
    if tw.lockdep.current() is None:
        pytest.skip("suite lockdep disabled via TPUC_LOCKDEP=0")
    mgr = tw.manager.Manager(store=tw.store.Store(),
                             health_addr="127.0.0.1:0")
    mgr.start()
    try:
        doc = json.loads(_get(mgr.health_port, "/debug/lockdep"))
        assert {"classes", "edges", "reports", "declared"} <= set(doc)
        idx = json.loads(_get(mgr.health_port, "/debug"))
        assert "/debug/lockdep" in idx["endpoints"]
    finally:
        mgr.stop()
    return sorted(doc), idx["endpoints"]["/debug/lockdep"]


def debug_lockdep_503_when_disabled(tw):
    lockdep = tw.lockdep
    prev = lockdep.current()
    lockdep.disable()
    try:
        mgr = tw.manager.Manager(store=tw.store.Store(),
                                 health_addr="127.0.0.1:0")
        mgr.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(mgr.health_port, "/debug/lockdep")
            assert exc.value.code == 503
            out = (exc.value.code, exc.value.read().decode())
        finally:
            mgr.stop()
    finally:
        if prev is not None:
            with lockdep._witness_lock:
                lockdep._witness = prev
    return out


SCENARIOS = [
    two_lock_cycle_detected_nonstrict,
    strict_mode_raises_at_the_closing_acquire,
    transitive_cycle_through_three_classes,
    reentrant_reacquire_is_not_an_ordering_event,
    same_class_nesting_is_counted_not_cycled,
    cond_park_releases_the_held_entry,
    declared_order_raises_without_a_full_cycle,
    failed_nonblocking_acquire_leaves_no_phantom_hold,
    report_dedup_one_report_per_bad_edge,
    scoped_witness_restores_the_suite_witness,
    held_stack_survives_a_witness_swap,
    witness_catches_the_abba_shape,
    declared_order_catches_it_even_first,
    suite_witness_runs_and_declares_the_store_order,
    debug_lockdep_serves_the_graph,
    debug_lockdep_503_when_disabled,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_snapshot_dump_roundtrip_matches_jax(tmp_path):
    jax_out, port_out = run_both(snapshot_dump_roundtrip, tmp_path)
    assert port_out == jax_out


def test_port_witness_is_separate_from_the_jax_witness():
    """Each package's ObservedLocks feed only that package's witness: an
    order recorded on the port's locks never reaches the JAX graph."""
    from tests.torch_operator import JAX_ROOT, PORT_ROOT, twin

    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    with jax.lockdep.scoped_witness(strict=True) as jw, \
            port.lockdep.scoped_witness(strict=True) as pw:
        a, b = port.contention.ObservedLock("xa"), \
            port.contention.ObservedLock("xb")
        with a:
            with b:
                pass
        assert _edges(pw) == [("xa", "xb")]
        assert _edges(jw) == []
