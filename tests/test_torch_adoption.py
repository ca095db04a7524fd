"""The port's cold-start adoption (tpu_composer_torch/controllers/adoption.py)
against the JAX package's (tests/test_adoption.py's twin).

Each scenario builds the same crash state in both packages — a CR whose
``status.pending_op`` intent was persisted and whose outcome was not —
runs ``adopt_pending_ops(store, fabric)`` and compares the report, the
CR's status (device ids, CDI id, intent, attempts, quarantine) and the
pool's free chips. The Manager wiring runs the pass as a startup hook
(``Manager.add_startup_hook``), before any controller worker starts, as
``tpu_composer/cmd/main.py`` wires it. Masked: uid, timestamps, intent
nonces, trace ids. Tolerance: exact.

With a ``FabricDispatcher`` (``dispatcher=``) the in-progress ops go to
its shared per-node re-poll pass: ``async_attach_handed_to_dispatcher_repoll``
and ``ineffective_detach_repolled_and_ids_adopted`` record the report,
the CR's status and the dispatcher's op states after the pass drove them
to completion. Without a dispatcher the same crash states are deferred
to the reconcile's poll timers, which the cases below hold (with the ids
still adopted).
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

from tests.torch_operator import (
    JAX_ROOT,
    PORT_ROOT,
    run_both,
    seeded_uuids,
    twin,
    wait_for,
)

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


def make_cr(tw, store, name, node="worker-0", state=None, verb="add",
            model="tpu-v4", chip_count=1, type_="tpu", **spec):
    t = tw.types
    state = t.RESOURCE_STATE_ATTACHING if state is None else state
    res = t.ComposableResource(metadata=tw.meta.ObjectMeta(name=name))
    res.spec.type, res.spec.model = type_, model
    res.spec.target_node, res.spec.chip_count = node, chip_count
    for k, v in spec.items():
        setattr(res.spec, k, v)
    res.status.state = state
    store.create(res)
    got = store.get(t.ComposableResource, name)
    got.status.state = state
    if verb:
        got.status.pending_op = t.PendingOp(verb=verb, nonce=f"nonce-{name}",
                                            node=node,
                                            started_at=tw.meta.now_iso())
    return store.update_status(got)


def world(tw, **pool_kw):
    store = tw.store.Store()
    store.create(tw.types.Node(metadata=tw.meta.ObjectMeta(name="worker-0")))
    return store, tw.inmem.InMemoryPool(**pool_kw)


def report_view(r):
    return dict(adopted=r.adopted, reissued=r.reissued, repolled=r.repolled,
                cleared=r.cleared, deferred=r.deferred, errors=r.errors)


def cr_view(tw, store, name):
    got = store.get(tw.types.ComposableResource, name)
    po = got.status.pending_op
    return dict(device_ids=got.status.device_ids,
                cdi=got.status.cdi_device_id, state=got.status.state,
                pending=None if po is None else (po.verb, po.nonce),
                attempts=got.status.attach_attempts,
                quarantined=got.status.quarantined)


# -- add intents ------------------------------------------------------------------

def completed_but_unrecorded_attach_is_adopted(tw):
    store, pool = world(tw)
    res = make_cr(tw, store, "r0")
    result = pool.add_resource(res)
    free_before = pool.free_chips("tpu-v4")
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.adopted == ["r0"]
    view = cr_view(tw, store, "r0")
    assert view["device_ids"] == result.device_ids and view["pending"] is None
    assert pool.free_chips("tpu-v4") == free_before
    return [report_view(report), view]


def never_issued_attach_cleared_when_fabric_rejects(tw):
    store, pool = world(tw)
    make_cr(tw, store, "r0")
    pool.inject_add_failure("r0", times=99)
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.reissued == ["r0"]
    view = cr_view(tw, store, "r0")
    assert view["pending"] is None and view["attempts"] == 0
    return [report_view(report), view]


def never_issued_attach_probe_completes_synchronously(tw):
    store, pool = world(tw)
    make_cr(tw, store, "r0")
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.adopted == ["r0"]
    assert len(cr_view(tw, store, "r0")["device_ids"]) == 1
    return [report_view(report), cr_view(tw, store, "r0"),
            pool.free_chips("tpu-v4")]


def async_attach_without_dispatcher_is_deferred(tw):
    store, pool = world(tw, async_steps=3)
    res = make_cr(tw, store, "r0")
    with pytest.raises(Exception):
        pool.add_resource(res)
    report = tw.adoption.adopt_pending_ops(store, pool, dispatcher=None)
    assert report.deferred == ["r0"]
    assert cr_view(tw, store, "r0")["pending"] is not None
    return [report_view(report), cr_view(tw, store, "r0")]


def quarantined_intent_cleared_without_fabric_probe(tw):
    store, pool = world(tw)
    res = make_cr(tw, store, "r0")
    res.status.quarantined = True
    res.status.attach_attempts = 5
    store.update_status(res)
    free_before = pool.free_chips("tpu-v4")
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.cleared == ["r0"]
    view = cr_view(tw, store, "r0")
    assert view["quarantined"] is True and view["attempts"] == 5
    assert pool.free_chips("tpu-v4") == free_before
    return [report_view(report), view]


def deleted_owner_with_nothing_materialized_cleared(tw):
    t = tw.types
    store, pool = world(tw)
    res = make_cr(tw, store, "r0")
    res.add_finalizer("tpu.composer.dev/finalizer")
    store.update(res)
    store.delete(t.ComposableResource, "r0")
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.cleared == ["r0"]
    return [report_view(report), cr_view(tw, store, "r0")]


# -- remove intents ------------------------------------------------------------------

def effective_detach_cleared_for_reconcile_tail(tw):
    store, pool = world(tw)
    make_cr(tw, store, "r0", state=tw.types.RESOURCE_STATE_DETACHING,
            verb="remove")
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.cleared == ["r0"]
    return [report_view(report), cr_view(tw, store, "r0")]


def ineffective_detach_ids_adopted_and_deferred(tw):
    store, pool = world(tw)
    res = make_cr(tw, store, "r0", state=tw.types.RESOURCE_STATE_DETACHING,
                  verb="remove")
    attach = pool.add_resource(res)
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.deferred == ["r0"]
    view = cr_view(tw, store, "r0")
    assert view["device_ids"] == sorted(attach.device_ids)
    assert view["pending"] is not None
    return [report_view(report), view]


# -- degraded stores ---------------------------------------------------------------

def dark_fabric_defers_everything(tw):
    store, _ = world(tw)
    make_cr(tw, store, "r0")
    make_cr(tw, store, "r1", verb="remove",
            state=tw.types.RESOURCE_STATE_DETACHING)

    class DarkFabric:
        def get_resources(self):
            raise tw.provider.FabricError("fabric manager unreachable")

    report = tw.adoption.adopt_pending_ops(store, DarkFabric())
    assert sorted(report.deferred) == ["r0", "r1"]
    return [report_view(report), cr_view(tw, store, "r0"),
            cr_view(tw, store, "r1")]


def store_list_failure_is_nonfatal(tw):
    _, pool = world(tw)

    class DeadStore:
        def list(self, cls):
            raise tw.store.StoreError("apiserver down")

    report = tw.adoption.adopt_pending_ops(DeadStore(), pool)
    assert report.errors and report.adopted == []
    return report_view(report)


def no_pending_intents_never_lists_fabric(tw):
    store, _ = world(tw)
    make_cr(tw, store, "r0", verb="")

    class ExplodingFabric:
        def get_resources(self):
            raise AssertionError("listed fabric with no pending intents")

    report = tw.adoption.adopt_pending_ops(store, ExplodingFabric())
    assert report.total == 0
    return report_view(report)


def _op_done(disp, verb, name):
    assert wait_for(lambda: disp.op_state(verb, name) == "done",
                    timeout=10.0, interval=0.005)


def async_attach_handed_to_dispatcher_repoll(tw):
    store, _ = world(tw)
    pool = tw.inmem.InMemoryPool(async_steps=2)
    res = make_cr(tw, store, "r0")
    with pytest.raises(Exception):
        pool.add_resource(res)  # pre-crash submission, fabric-async now
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=0.01)
    try:
        report = tw.adoption.adopt_pending_ops(store, pool, disp)
        assert report.repolled == ["r0"]
        _op_done(disp, "add", "r0")
        out = disp.add_resource(store.get(tw.types.ComposableResource, "r0"))
        return [report_view(report), cr_view(tw, store, "r0"),
                list(out.device_ids), disp.op_state("add", "r0")]
    finally:
        disp.stop()


def ineffective_detach_repolled_and_ids_adopted(tw):
    store, pool = world(tw)
    res = make_cr(tw, store, "r0", state=tw.types.RESOURCE_STATE_DETACHING,
                  verb="remove")
    attach = pool.add_resource(res)
    disp = tw.dispatcher.FabricDispatcher(pool, batch_window=0.0,
                                          poll_interval=0.01)
    try:
        report = tw.adoption.adopt_pending_ops(store, pool, disp)
        assert report.repolled == ["r0"]
        view = cr_view(tw, store, "r0")
        assert view["device_ids"] == sorted(attach.device_ids)
        _op_done(disp, "remove", "r0")
        return [report_view(report), view, pool.attachment_record("r0"),
                pool.free_chips("tpu-v4")]
    finally:
        disp.stop()


SCENARIOS = [
    async_attach_handed_to_dispatcher_repoll,
    ineffective_detach_repolled_and_ids_adopted,
    completed_but_unrecorded_attach_is_adopted,
    never_issued_attach_cleared_when_fabric_rejects,
    never_issued_attach_probe_completes_synchronously,
    async_attach_without_dispatcher_is_deferred,
    quarantined_intent_cleared_without_fabric_probe,
    deleted_owner_with_nothing_materialized_cleared,
    effective_detach_cleared_for_reconcile_tail,
    ineffective_detach_ids_adopted_and_deferred,
    dark_fabric_defers_everything, store_list_failure_is_nonfatal,
    no_pending_intents_never_lists_fabric,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


# -- Manager wiring -----------------------------------------------------------------

@pytest.mark.parametrize("root", [JAX_ROOT, PORT_ROOT])
def test_hook_runs_after_acquire_before_controllers(root):
    """Adoption as the Manager's startup hook: no controller worker runs
    yet, and by the first reconcile the surviving intent is resolved."""
    tw = twin(root)
    with seeded_uuids():
        store, pool = world(tw)
        rec = tw.rc.ComposableResourceReconciler(
            store, pool, tw.fake.FakeNodeAgent(pool=pool),
            timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                        detach_poll=0.05, detach_fast=0.05))
        mgr = tw.manager.Manager(store=store)
        mgr.add_controller(rec)
        seen = {}

        def hook():
            seen["controller_threads"] = list(rec._threads)
            seen["report"] = tw.adoption.adopt_pending_ops(store, pool)

        mgr.add_startup_hook(hook)
        result = pool.add_resource(make_cr(tw, store, "r0"))
        mgr.start(workers_per_controller=1)
        try:
            assert seen["controller_threads"] == []
            assert seen["report"].adopted == ["r0"]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if store.get(tw.types.ComposableResource, "r0").status.state == "Online":
                    break
                time.sleep(0.02)
            got = store.get(tw.types.ComposableResource, "r0")
            assert got.status.state == "Online"
            assert got.status.device_ids == result.device_ids
            assert got.status.pending_op is None
        finally:
            mgr.stop()


@pytest.mark.parametrize("root", [JAX_ROOT, PORT_ROOT])
def test_hook_failure_is_nonfatal(root):
    tw = twin(root)
    mgr = tw.manager.Manager(store=tw.store.Store())
    mgr.add_startup_hook(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    started = threading.Event()
    mgr.add_startup_hook(started.set)
    mgr.start(workers_per_controller=1)
    try:
        assert started.is_set() and mgr.ready()
    finally:
        mgr.stop()


def test_h100_slice_member_attach_is_adopted():
    """An H100 group whose attach landed before the crash: adoption folds
    its GPUs and CDI id in without a second attach (no JAX counterpart;
    held to the pool's own record)."""
    tw = twin(PORT_ROOT)
    store, pool = world(tw, chips={H100: 16})
    pool.reserve_slice("job-slice", H100, "8x1", ["worker-0"])
    res = make_cr(tw, store, "g0", model=H100, type_="gpu", chip_count=8,
                  slice_name="job-slice", worker_id=0, topology="8x1")
    result = pool.add_resource(res)
    free_before = pool.free_chips(H100)
    report = tw.adoption.adopt_pending_ops(store, pool)
    assert report.adopted == ["g0"]
    view = cr_view(tw, store, "g0")
    assert view["device_ids"] == result.device_ids and len(result.device_ids) == 8
    assert view["cdi"] == result.cdi_device_id == "tpu.composer.dev/gpu=job-slice-worker0"
    assert view["pending"] is None
    assert pool.free_chips(H100) == free_before
