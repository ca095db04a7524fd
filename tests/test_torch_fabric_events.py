"""The port's fabric event plane (tpu_composer_torch/fabric/events.py's
``FabricSession`` and the dispatcher's consumption of it) against the JAX
package's (tests/test_fabric_events.py's twin).

Each scenario runs once per package and records what the session
delivered (sequence numbers, cursors polled, gap and state transitions,
the dormancy gauge) or, for the dispatcher, the outcome of a wave: op
states, the pool's materializations by intent nonce, whether the poll
safety net or the gap resync fired, and the attach results. Elapsed
times are never compared (the reference's own latency bounds are
wall-clock claims, not outcomes). The two packages' records must be
equal. Tolerance: exact.

Extra row: the session streams through the REST client over
``tests/fake_fabric`` (the wire the remote operator uses).
"""

from __future__ import annotations

import time

import pytest
import torch

from tests.fake_fabric import FakeFabricServer
from tests.torch_operator import run_both, run_both_served, wait_for

torch.set_num_threads(1)


def _wait(cond, timeout=10.0, msg="condition never held"):
    assert wait_for(cond, timeout=timeout, interval=0.002), msg


def _scripted(tw, script, head=0):
    class ScriptedEventProvider(tw.provider.FabricProvider):
        def __init__(self):
            self.script = list(script)
            self.head = head
            self.polled_cursors = []

        def poll_events(self, cursor, timeout=5.0):
            self.polled_cursors.append(cursor)
            if not self.script:
                time.sleep(min(timeout, 0.01))
                return [], max(cursor, self.head)
            step = self.script.pop(0)
            if isinstance(step, Exception):
                raise step
            return step

        def add_resource(self, resource):  # pragma: no cover
            raise NotImplementedError

        def remove_resource(self, resource):  # pragma: no cover
            raise NotImplementedError

        def check_resource(self, resource):  # pragma: no cover
            raise NotImplementedError

        def get_resources(self):
            return []

    return ScriptedEventProvider()


def ev(tw, seq, resource="r", verb="add", **kw):
    return tw.fevents.FabricEvent(seq=seq, type="op_completed",
                                  resource=resource, verb=verb, **kw)


def _session(tw, provider, **kw):
    return tw.fevents.FabricSession(provider, poll_timeout=0.05, **kw)


# -- FabricSession -------------------------------------------------------------------

def tail_start_then_in_order_delivery(tw):
    p = _scripted(tw, [([], 7), ([ev(tw, 8), ev(tw, 9)], 9)])
    got = []
    s = _session(tw, p)
    s.on_event(got.append)
    s.start()
    _wait(lambda: len(got) == 2)
    s.stop()
    return [[e.seq for e in got], s.cursor(), p.polled_cursors[:2]]


def duplicates_and_batch_reorder_never_double_apply(tw):
    p = _scripted(tw, [([], 0),
                       ([ev(tw, 2), ev(tw, 1), ev(tw, 2), ev(tw, 1)], 2),
                       ([ev(tw, 1), ev(tw, 2)], 2), ([ev(tw, 3)], 3)])
    got = []
    s = _session(tw, p)
    s.on_event(got.append)
    s.start()
    _wait(lambda: any(e.seq == 3 for e in got))
    s.stop()
    return [[e.seq for e in got], s.gaps]


def gap_fires_once_and_cursor_advances(tw):
    p = _scripted(tw, [([], 0), ([ev(tw, 1)], 1),
                       ([ev(tw, 4), ev(tw, 5)], 5)])
    gaps = []
    s = _session(tw, p)
    s.on_gap(lambda: gaps.append(1))
    s.start()
    _wait(lambda: s.cursor() == 5)
    s.stop()
    return [len(gaps), s.gaps, s.cursor()]


def reconnect_resumes_from_cursor(tw):
    err = tw.provider.TransientFabricError
    p = _scripted(tw, [([], 0), ([ev(tw, 1), ev(tw, 2)], 2),
                       err("stream died"), err("still dead"), ([ev(tw, 3)], 3)])
    s = _session(tw, p, retry_base=0.01)
    s.start()
    _wait(lambda: s.cursor() == 3)
    s.stop()
    return [p.polled_cursors[:5], s.cursor()]


def unsupported_provider_goes_dormant(tw):
    p = _scripted(tw, [tw.provider.UnsupportedEvents("no stream")])
    states = []
    s = _session(tw, p, name="dormant-twin")
    s.on_state(states.append)
    s.start()
    _wait(lambda: not s.supported())
    s.stop()
    return [s.healthy(), s.supported(), states,
            tw.metrics.fabric_session_state.value(endpoint="dormant-twin"),
            tw.fevents.SESSION_UNSUPPORTED]


def mid_life_unsupported_snaps_state_down(tw):
    p = _scripted(tw, [([], 0), tw.provider.UnsupportedEvents("rolled back")])
    states = []
    s = _session(tw, p)
    s.on_state(states.append)
    s.start()
    _wait(lambda: not s.supported())
    s.stop()
    return [states]


def state_transitions_fire_handlers(tw):
    p = _scripted(tw, [([], 0), tw.provider.TransientFabricError("blip"),
                       ([], 0)])
    states = []
    s = _session(tw, p, retry_base=0.01)
    s.on_state(states.append)
    s.start()
    _wait(lambda: len(states) >= 3)
    s.stop()
    return [states[:3]]


def make_resource(tw, name, node="evt-node", nonce=""):
    t = tw.types
    status = t.ComposableResourceStatus()
    if nonce:
        status.pending_op = t.PendingOp(verb="add", nonce=nonce)
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                      target_node=node, chip_count=1),
        status=status)


def session_streams_through_breaker_wrapper(tw):
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 2})
    s = tw.fevents.FabricSession(
        tw.breaker.BreakerFabricProvider(pool, endpoint="brk-twin"),
        poll_timeout=0.1)
    got = []
    s.on_event(got.append)
    s.start()
    _wait(s.healthy)
    pool.add_resource(make_resource(tw, "brk-r", nonce="brk-n"))
    _wait(lambda: any(e.resource == "brk-r" for e in got))
    s.stop()
    return [s.supported(), [e.to_wire() for e in got]]


def inventory_publisher_wakes_on_session_events(tw):
    """``InventoryPublisher(session=)`` against a live FabricSession: its
    timed pass stretches while the session streams, an inventory event
    rings its doorbell, and a gap does too."""
    pool = tw.inmem.InMemoryPool(chips={"gpu-a100": 2})
    session = tw.fevents.FabricSession(pool, poll_timeout=0.1)
    pub = tw.publisher.InventoryPublisher(tw.store.Store(), pool,
                                          session=session, period=2.0,
                                          fallback_multiplier=5.0)
    out = [pub.effective_period()]
    session.start()
    try:
        _wait(session.healthy)
        out += [pub.effective_period(), pub._wake.is_set()]
        pool.add_resource(make_resource(tw, "inv-r", nonce="inv-n"))
        _wait(pub._wake.is_set)
        pub._wake.clear()
        session._gap_handlers[0]()
        out.append(pub._wake.is_set())
    finally:
        session.stop()
    return out + [pub.effective_period()]


SESSION = [inventory_publisher_wakes_on_session_events,
           tail_start_then_in_order_delivery,
           duplicates_and_batch_reorder_never_double_apply,
           gap_fires_once_and_cursor_advances, reconnect_resumes_from_cursor,
           unsupported_provider_goes_dormant,
           mid_life_unsupported_snaps_state_down,
           state_transitions_fire_handlers,
           session_streams_through_breaker_wrapper]


# -- the dispatcher's event plane ----------------------------------------------------

def recording_pool(tw, **kw):
    class RecordingPool(tw.inmem.InMemoryPool):
        """Every ACTUAL attach materialization as (resource, nonce)."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.materializations = []

        def _attach_loose(self, resource):
            att = super()._attach_loose(resource)
            po = resource.status.pending_op
            self.materializations.append(
                (resource.metadata.name, po.nonce if po else ""))
            return att

    return RecordingPool(**kw)


def _wired(tw, pool_kw, chaos=False, poll_interval=1.0, mult=20.0):
    pool = recording_pool(tw, chips={"gpu-a100": 64}, **pool_kw)
    provider = tw.chaos.ChaosFabricProvider(pool, seed=7) if chaos else pool
    disp = tw.dispatcher.FabricDispatcher(
        provider, batch_window=0.0, poll_interval=poll_interval,
        concurrency=4, fallback_multiplier=mult)
    session = tw.fevents.FabricSession(provider, poll_timeout=0.25,
                                       retry_base=0.01)
    disp.attach_session(session)
    session.start()
    _wait(session.healthy)
    return pool, provider, disp, session


def _submit(tw, disp, n, prefix):
    rs = [make_resource(tw, f"{prefix}{i}", nonce=f"{prefix}-nonce-{i}")
          for i in range(n)]
    for r in rs:
        try:
            disp.add_resource(r)
        except tw.provider.FabricError:
            pass  # the dispatch sentinel
    return rs


def _settled(disp, rs, timeout=10.0):
    _wait(lambda: all(disp.op_state("add", r.metadata.name) == "done"
                      for r in rs), timeout=timeout)


def _results(disp, rs):
    """Every member's consumed attach result; concurrent lanes hand out
    ids in any order, so the record is the sorted set of id lists."""
    return sorted(list(disp.add_resource(r).device_ids) for r in rs)


def steady_wave_settles_via_push_zero_fallbacks(tw):
    pool, _, disp, session = _wired(tw, {"async_delay": 0.03})
    fb = tw.metrics.fabric_poll_fallbacks_total
    try:
        fb0 = fb.total()
        rs = _submit(tw, disp, 8, "w")
        _settled(disp, rs)
        return [fb.total() - fb0, sorted(n for _, n in pool.materializations),
                sorted(map(len, _results(disp, rs)))]
    finally:
        session.stop()
        disp.stop()


def pending_parks_at_stretched_interval(tw):
    pool, _, disp, session = _wired(tw, {"async_delay": 5.0},
                                    poll_interval=0.2)
    try:
        _submit(tw, disp, 1, "stretch")
        _wait(lambda: disp.op_state("add", "stretch0") == "pending")
        with disp._cond:
            lead = disp._ops[("add", "stretch0")].next_poll - time.monotonic()
        return [lead > 0.2 * 5]
    finally:
        session.stop()
        disp.stop()


def session_drop_mid_wave_falls_back_to_polling(tw):
    pool, provider, disp, session = _wired(
        tw, {"async_delay": 0.15}, chaos=True, poll_interval=0.2, mult=50.0)
    fb = tw.metrics.fabric_poll_fallbacks_total
    try:
        fb0 = fb.total()
        rs = _submit(tw, disp, 32, "drop")
        _wait(lambda: any(disp.op_state("add", r.metadata.name) == "pending"
                          for r in rs))
        provider.kill_session(-1)
        _wait(lambda: not session.healthy())
        _settled(disp, rs)
        nonces = [n for _, n in pool.materializations]
        return [sorted(map(len, _results(disp, rs))), fb.total() - fb0 > 0,
                sorted(nonces), len(set(nonces)) == len(nonces)]
    finally:
        session.stop()
        disp.stop()


def snap_back_caps_parked_polls(tw):
    pool, provider, disp, session = _wired(
        tw, {"async_delay": 5.0}, chaos=True, poll_interval=0.25, mult=40.0)
    try:
        _submit(tw, disp, 1, "snap")
        _wait(lambda: disp.op_state("add", "snap0") == "pending")
        provider.kill_session(-1)
        _wait(lambda: not session.healthy())
        _wait(lambda: (disp._ops[("add", "snap0")].next_poll
                       - time.monotonic()) <= 0.3)
        return [disp.op_state("add", "snap0")]
    finally:
        session.stop()
        disp.stop()


def event_gap_forces_exactly_one_resync(tw):
    pool, provider, disp, session = _wired(
        tw, {"async_delay": 0.05}, chaos=True, poll_interval=1.0, mult=30.0)
    rsy = tw.metrics.fabric_event_resyncs_total
    try:
        rs0 = rsy.total()
        rs = _submit(tw, disp, 1, "gap")
        _wait(lambda: disp.op_state("add", "gap0") == "pending")
        provider.drop_events(next_n=1)
        _wait(lambda: disp.op_state("add", "gap0") == "done", timeout=5.0)
        return [rsy.total() - rs0, _results(disp, rs)]
    finally:
        session.stop()
        disp.stop()


def duplicate_and_reordered_events_are_harmless(tw):
    pool, provider, disp, session = _wired(
        tw, {"async_delay": 0.03}, chaos=True, poll_interval=1.0)
    try:
        provider.duplicate_events(0.5)
        provider.reorder_events(0.3)
        rs = _submit(tw, disp, 12, "dup")
        _settled(disp, rs)
        nonces = [n for _, n in pool.materializations]
        return [sorted(nonces), len(set(nonces)),
                sorted(map(len, _results(disp, rs)))]
    finally:
        session.stop()
        disp.stop()


def no_session_keeps_poll_path_and_counts_nothing(tw):
    pool = recording_pool(tw, chips={"gpu-a100": 8}, async_delay=0.02)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=0.1, concurrency=4,
                                          fallback_multiplier=20.0)
    fb = tw.metrics.fabric_poll_fallbacks_total
    try:
        fb0 = fb.total()
        rs = _submit(tw, disp, 4, "plain")
        _settled(disp, rs)
        return [fb.total() - fb0, _results(disp, rs)]
    finally:
        disp.stop()


def stale_nonce_event_does_not_mark_op_evented(tw):
    pool = recording_pool(tw, chips={"gpu-a100": 8}, async_delay=5.0)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=5.0, concurrency=2)
    session = tw.fevents.FabricSession(pool, poll_timeout=0.1)
    disp.attach_session(session)
    try:
        r = make_resource(tw, "stale-n", nonce="current-nonce")
        try:
            disp.add_resource(r)
        except tw.provider.FabricError:
            pass
        _wait(lambda: disp.op_state("add", "stale-n") == "pending")
        disp._on_fabric_event(ev(tw, 99, "stale-n", nonce="ANCIENT-nonce"))
        with disp._cond:
            op = disp._ops[("add", "stale-n")]
            out = [op.evented, op.next_poll > time.monotonic() + 1.0]
        disp._on_fabric_event(ev(tw, 100, "stale-n", nonce="current-nonce"))
        with disp._cond:
            out.append(disp._ops[("add", "stale-n")].evented)
        return out
    finally:
        session.stop()
        disp.stop()


def controller_wave_session_drop_converges(tw):
    """16 CRs through the live resource controller with the event plane
    streaming, the session killed mid-wave: every CR Online, one fabric
    materialization per durable intent nonce."""
    t = tw.types
    store = tw.store.Store()
    n = t.Node(metadata=tw.meta.ObjectMeta(name="evt-node"))
    n.status.tpu_slots = 16
    store.create(n)
    pool = recording_pool(tw, chips={"gpu-a100": 16}, async_delay=0.1)
    provider = tw.chaos.ChaosFabricProvider(pool, seed=3)
    disp = tw.dispatcher.FabricDispatcher(provider, batch_window=0.01,
                                          poll_interval=0.1, concurrency=4,
                                          fallback_multiplier=30.0)
    session = tw.fevents.FabricSession(provider, poll_timeout=0.25,
                                       retry_base=0.01)
    disp.attach_session(session)
    session.start()
    _wait(session.healthy)
    mgr = tw.manager.Manager(store=store)
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, provider, tw.fake.FakeNodeAgent(pool=pool), dispatcher=disp,
        timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.01,
                                    detach_poll=0.05, detach_fast=0.01,
                                    busy_poll=0.01)))
    mgr.start(workers_per_controller=4)
    names = [f"wave-{i}" for i in range(16)]
    try:
        for name in names:
            store.create(t.ComposableResource(
                metadata=tw.meta.ObjectMeta(name=name),
                spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                              target_node="evt-node")))
        _wait(lambda: sum(disp.op_state("add", nm) in ("pending", "done")
                          for nm in names) >= 4)
        provider.kill_session(-1)
        _wait(lambda: all(
            (r := store.try_get(t.ComposableResource, nm)) is not None
            and r.status.state == "Online" for nm in names), timeout=30.0)
        nonces = [nn for _, nn in pool.materializations]
        return [len(nonces), len(set(nonces)),
                sorted(nm for nm, _ in pool.materializations)]
    finally:
        mgr.stop()
        session.stop()
        disp.stop()


DISPATCHER = [steady_wave_settles_via_push_zero_fallbacks,
              pending_parks_at_stretched_interval,
              session_drop_mid_wave_falls_back_to_polling,
              snap_back_caps_parked_polls,
              event_gap_forces_exactly_one_resync,
              duplicate_and_reordered_events_are_harmless,
              no_session_keeps_poll_path_and_counts_nothing,
              stale_nonce_event_does_not_mark_op_evented,
              controller_wave_session_drop_converges]


@pytest.mark.parametrize("scenario", SESSION + DISPATCHER,
                         ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax, port = run_both(scenario)
    assert jax == port


def test_records_hold_the_reference_contract():
    jax, _ = run_both(duplicates_and_batch_reorder_never_double_apply)
    assert jax == [[1, 2, 3], 0]
    jax, _ = run_both(gap_fires_once_and_cursor_advances)
    assert jax == [1, 1, 5]
    jax, _ = run_both(event_gap_forces_exactly_one_resync)
    assert jax[0] == 1
    jax, _ = run_both(inventory_publisher_wakes_on_session_events)
    assert jax == [2.0, 10.0, False, True, 2.0]


# -- the session over the REST wire ---------------------------------------------------

def session_over_rest_settles_a_wave(tw, srv):
    client = tw.rest.RestPoolClient(srv.url, token_cache=None)
    disp = tw.dispatcher.FabricDispatcher(client, batch_window=0.0,
                                          poll_interval=1.0, concurrency=2,
                                          fallback_multiplier=20.0)
    session = tw.fevents.FabricSession(client, poll_timeout=0.25,
                                       retry_base=0.01)
    disp.attach_session(session)
    got = []
    session.on_event(lambda e: got.append((e.type, e.resource, e.verb)))
    session.start()
    try:
        _wait(session.healthy)
        rs = _submit(tw, disp, 3, "wire")
        _settled(disp, rs)
        _wait(lambda: sum(k == "op_completed" for k, _, _ in got) >= 3)
        return [_results(disp, rs), sorted(x for x in got
                                           if x[0] == "op_completed"),
                session.supported(), session.healthy()]
    finally:
        session.stop()
        disp.stop()


def test_session_over_rest_matches_jax():
    from tpu_composer.fabric.inmem import InMemoryPool

    srv = FakeFabricServer()
    try:
        jax, port = run_both_served(
            session_over_rest_settles_a_wave, srv,
            lambda: InMemoryPool(chips={"gpu-a100": 8}, async_delay=0.05))
    finally:
        srv.close()
    assert jax == port
    assert jax[2:] == [True, True] and len(jax[1]) == 3
