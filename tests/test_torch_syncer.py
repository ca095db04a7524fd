"""The port's UpstreamSyncer (tpu_composer_torch/controllers/syncer.py)
against the JAX package's (tests/test_syncer.py's twin).

Each scenario of tests/test_syncer.py runs on both packages
(``run_both``): a Store with two workers of 8 slots, an ``InMemoryPool``
and a syncer on an injected clock (``sync_once(now=...)``). Compared
after every pass: the detach-CRs the pass created, the devices it tracks,
the durable orphan trackers (DeviceTaintRules) with their first-seen
stamps masked by presence, every CR's spec, labels and state, and the
pool's attachments and free chips. Masked: uid, timestamps, intent
nonces, trace ids (``tests/torch_operator.MASKED``) and the first-seen
stamp. The JAX tests' ``ChaosStore`` (a later sub-slice) is stood in for
by ``FailOnce``, a proxy that fails one store verb once with the
package's own ``StoreError``. Tolerance: exact, and the back-dated stamp
within the JAX test's 35–60 s window. An H100 leak is reclaimed the
same way, with its detach-CR typed ``gpu``.
"""

from __future__ import annotations

import datetime
import time

import pytest
import torch

from tests.torch_operator import PORT_ROOT, run_both, seeded_uuids, twin

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


class FailOnce:
    """A store proxy whose next call of ``verb`` raises the package's
    StoreError; every other call goes to ``store``."""

    def __init__(self, tw, store, verb):
        self._tw, self._store, self._verb = tw, store, verb

    def __getattr__(self, name):
        attr = getattr(self._store, name)
        if name != self._verb:
            return attr

        def once(*a, **kw):
            if self._verb is not None:
                self._verb = None
                raise self._tw.store.StoreError(f"injected {name} failure")
            return attr(*a, **kw)
        return once


class World:
    def __init__(self, tw, chips=None, **syncer_kw):
        self.tw = tw
        self.store = tw.store.Store()
        for i in range(2):
            n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 8
            self.store.create(n)
        self.pool = tw.inmem.InMemoryPool(chips=chips or {"tpu-v4": 64})
        kw = dict(period=0.01, grace=100.0)
        kw.update(syncer_kw)
        self.syncer = tw.syncer.UpstreamSyncer(self.store, self.pool, **kw)

    def syncer_on(self, store, **kw):
        return self.tw.syncer.UpstreamSyncer(store, self.pool, **kw)

    def reconciler(self):
        agent = self.tw.fake.FakeNodeAgent(pool=self.pool)
        return self.tw.rc.ComposableResourceReconciler(self.store, self.pool, agent)

    def cr(self, name, node="worker-1", device_ids=(), **spec):
        t = self.tw.types
        cr = t.ComposableResource(metadata=self.tw.meta.ObjectMeta(name=name))
        cr.spec.type, cr.spec.model, cr.spec.target_node = "tpu", "tpu-v4", node
        for k, v in spec.items():
            setattr(cr.spec, k, v)
        self.store.create(cr)
        if device_ids:
            got = self.store.get(t.ComposableResource, name)
            got.status.device_ids = list(device_ids)
            self.store.update_status(got)

    def view(self, syncer=None):
        t, dra = self.tw.types, self.tw.dra
        syncer = syncer or self.syncer
        trackers = {}
        for r in self.store.list(dra.DeviceTaintRule):
            if self.tw.syncer.is_orphan_tracker(r):
                trackers[r.metadata.name] = dict(
                    device=r.spec.device_uuid, node=r.spec.node_name,
                    stamped=bool(r.metadata.annotations.get(
                        t.ANNOTATION_ORPHAN_FIRST_SEEN)))
        crs = {c.metadata.name: dict(spec=c.spec.to_dict(),
                                     labels=dict(c.metadata.labels),
                                     state=c.status.state,
                                     device_ids=list(c.status.device_ids))
               for c in self.store.list(t.ComposableResource)}
        return dict(tracked=sorted(syncer.tracked_missing), trackers=trackers,
                    crs=crs,
                    fabric=sorted((d.device_id, d.node, d.model, d.type)
                                  for d in self.pool.get_resources()),
                    free={m: self.pool.free_chips(m) for m in sorted(self.pool._chips)})


def _age_tracker(w, device, seconds):
    t, dra = w.tw.types, w.tw.dra
    rule = w.store.get(dra.DeviceTaintRule, w.tw.syncer.orphan_tracker_name(device))
    stamp = datetime.datetime.fromtimestamp(
        time.time() - seconds, datetime.timezone.utc
    ).isoformat().replace("+00:00", "Z")
    rule.metadata.annotations[t.ANNOTATION_ORPHAN_FIRST_SEEN] = stamp
    w.store.update(rule)


# -- drift tracking ---------------------------------------------------------------

def leak_tracked_but_not_acted_on_before_grace(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    created = w.syncer.sync_once(now=0.0)
    assert created == 0 and leaked in w.syncer.tracked_missing
    return [created, w.view()]


def detach_cr_created_after_grace(tw):
    t = tw.types
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    out = [w.syncer.sync_once(now=0.0), w.syncer.sync_once(now=101.0), w.view()]
    (cr,) = w.store.list(t.ComposableResource)
    assert cr.metadata.labels[t.LABEL_READY_TO_DETACH] == leaked
    assert cr.spec.force_detach and cr.spec.target_node == "worker-1"
    assert w.syncer.sync_once(now=102.0) == 0
    return out


def suspended_syncer_freezes_grace_clocks(tw):
    dark = [False]
    w = World(tw, suspend=lambda: dark[0])
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    out = [w.syncer.sync_once(now=0.0)]
    assert leaked in w.syncer.tracked_missing
    dark[0] = True
    out += [w.syncer.sync_once(now=500.0), w.view()]
    dark[0] = False
    out += [w.syncer.sync_once(now=501.0), w.syncer.sync_once(now=601.0), w.view()]
    assert out[1] == 0 and out[3:5] == [0, 1]
    return out


def locally_owned_devices_not_flagged(tw):
    w = World(tw)
    w.pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["worker-0"])
    t = tw.types
    res = t.ComposableResource(metadata=tw.meta.ObjectMeta(name="r0"))
    res.spec.type, res.spec.model, res.spec.target_node = "tpu", "tpu-v4", "worker-0"
    res.spec.chip_count, res.spec.slice_name, res.spec.topology = 4, "s1", "2x2x1"
    out = w.pool.add_resource(res)
    w.cr("r0", node="worker-0", device_ids=out.device_ids, chip_count=4,
         slice_name="s1", topology="2x2x1")
    w.syncer.sync_once(now=0.0)
    assert w.syncer.tracked_missing == {}
    assert w.syncer.sync_once(now=1000.0) == 0
    return w.view()


def vanished_leak_stops_tracking(tw):
    t = tw.types
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    cr = t.ComposableResource(metadata=tw.meta.ObjectMeta(name="manual"))
    cr.spec.type, cr.spec.model, cr.spec.target_node = "tpu", "tpu-v4", "worker-1"
    cr.status.device_ids = [leaked]
    w.pool.remove_resource(cr)
    w.syncer.sync_once(now=50.0)
    assert w.syncer.tracked_missing == {}
    return w.view()


def reappeared_local_owner_clears_tracking(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    first = w.view()
    w.cr("late-owner", device_ids=[leaked])
    w.syncer.sync_once(now=50.0)
    assert w.syncer.tracked_missing == {}
    assert not w.view()["trackers"]
    return [first, w.view()]


# -- reclaim through the resource controller -------------------------------------------

def leak_reclaimed_through_detach_path(tw):
    t = tw.types
    w = World(tw)
    rec = w.reconciler()
    w.pool.leak_attachment("worker-1", "tpu-v4")
    free_before = w.pool.free_chips("tpu-v4")
    w.syncer.sync_once(now=0.0)
    w.syncer.sync_once(now=200.0)
    (cr,) = w.store.list(t.ComposableResource)
    trace = [w.view()]
    for _ in range(8):
        if w.store.try_get(t.ComposableResource, cr.metadata.name) is None:
            break
        rec.reconcile(cr.metadata.name)
        trace.append(w.view())
    assert w.store.try_get(t.ComposableResource, cr.metadata.name) is None
    assert w.pool.free_chips("tpu-v4") == free_before + 1
    assert w.syncer.sync_once(now=300.0) == 0
    return trace


def node_gone_orphan_fully_reclaimed(tw):
    t = tw.types
    w = World(tw)
    rec = w.reconciler()
    w.pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["worker-1"])
    w.cr("r0", chip_count=4, slice_name="s1", topology="2x2x1")
    rec.reconcile("r0")
    rec.reconcile("r0")
    assert w.store.get(t.ComposableResource, "r0").status.state == "Online"
    w.store.delete(t.Node, "worker-1")
    for _ in range(5):
        if w.store.try_get(t.ComposableResource, "r0") is None:
            break
        rec.reconcile("r0")
    assert len(w.pool.get_resources()) == 4
    w.syncer.sync_once(now=0.0)
    out = [w.syncer.sync_once(now=200.0), w.view()]
    assert out[0] == 4
    for cr in w.store.list(t.ComposableResource):
        for _ in range(6):
            if w.store.try_get(t.ComposableResource, cr.metadata.name) is None:
                break
            rec.reconcile(cr.metadata.name)
    w.pool.release_slice("s1")
    assert w.pool.free_chips("tpu-v4") == 64 and w.pool.get_resources() == []
    assert w.syncer.sync_once(now=400.0) == 0
    return out + [w.view()]


# -- device type -------------------------------------------------------------------

def explicit_type_wins_over_model_name(tw):
    t = tw.types
    w = World(tw, chips={"trillium": 4})
    w.syncer = w.syncer_on(w.store, grace=10.0)
    leaked = w.pool.leak_attachment("worker-1", "trillium", type="tpu")
    w.syncer.sync_once(now=0.0)
    assert w.syncer.sync_once(now=100.0) == 1
    (cr,) = w.store.list(t.ComposableResource)
    assert cr.metadata.labels[t.LABEL_READY_TO_DETACH] == leaked
    assert (cr.spec.type, cr.spec.model) == ("tpu", "trillium")
    return w.view()


def model_sniff_is_only_the_fallback(tw):
    w = World(tw)
    dev = tw.provider.FabricDevice(device_id="x", node="worker-1", model="tpu-v4")
    assert dev.type == ""
    assert w.syncer._create_detach_cr(dev)
    (cr,) = w.store.list(tw.types.ComposableResource)
    assert cr.spec.type == "tpu"
    return w.view()


# -- durable orphan grace ------------------------------------------------------------

def first_seen_persisted_as_tracker(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    rule = w.store.get(tw.dra.DeviceTaintRule, tw.syncer.orphan_tracker_name(leaked))
    assert tw.syncer.is_orphan_tracker(rule) and rule.spec.device_uuid == leaked
    assert not tw.publisher.is_node_quarantine_marker(rule)
    assert tw.publisher.quarantined_nodes(w.store) == set()
    return w.view()


def restart_resumes_grace_clock(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    _age_tracker(w, leaked, 150.0)
    fresh = w.syncer_on(w.store, grace=100.0)
    assert fresh.sync_once(now=1000.0) == 1
    assert w.store.try_get(tw.dra.DeviceTaintRule,
                           tw.syncer.orphan_tracker_name(leaked)) is None
    return w.view(fresh)


def restart_without_aging_still_waits_out_grace(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    fresh = w.syncer_on(w.store, grace=100.0)
    assert fresh.sync_once(now=0.0) == 0 and leaked in fresh.tracked_missing
    return w.view(fresh)


def unreadable_stamp_restarts_clock_but_keeps_tracking(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    rule = w.store.get(tw.dra.DeviceTaintRule, tw.syncer.orphan_tracker_name(leaked))
    rule.metadata.annotations[tw.types.ANNOTATION_ORPHAN_FIRST_SEEN] = "not-a-time"
    w.store.update(rule)
    fresh = w.syncer_on(w.store, grace=100.0)
    out = [fresh.sync_once(now=0.0), leaked in fresh.tracked_missing,
           fresh.sync_once(now=150.0)]
    assert out == [0, True, 1]
    return out + [w.view(fresh)]


def failed_tracker_load_is_retried_next_tick(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    w.syncer.sync_once(now=0.0)
    _age_tracker(w, leaked, 150.0)
    fresh = w.syncer_on(FailOnce(tw, w.store, "list"), grace=100.0)
    out = [fresh.sync_once(now=1000.0), fresh.sync_once(now=1001.0)]
    assert out == [0, 1]
    return out + [w.view(fresh)]


def failed_tracker_persist_is_retried_backdated(tw):
    w = World(tw)
    syncer = w.syncer_on(FailOnce(tw, w.store, "create"), grace=100.0)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    name = tw.syncer.orphan_tracker_name(leaked)
    syncer.sync_once(now=0.0)
    assert w.store.try_get(tw.dra.DeviceTaintRule, name) is None
    syncer.sync_once(now=40.0)
    rule = w.store.get(tw.dra.DeviceTaintRule, name)
    age = time.time() - tw.meta.parse_iso(
        rule.metadata.annotations[tw.types.ANNOTATION_ORPHAN_FIRST_SEEN]).timestamp()
    assert 35.0 <= age <= 60.0
    syncer.sync_once(now=50.0)
    rule2 = w.store.get(tw.dra.DeviceTaintRule, name)
    assert rule2.metadata.annotations == rule.metadata.annotations
    return w.view(syncer)


SCENARIOS = [
    leak_tracked_but_not_acted_on_before_grace, detach_cr_created_after_grace,
    suspended_syncer_freezes_grace_clocks, locally_owned_devices_not_flagged,
    vanished_leak_stops_tracking, reappeared_local_owner_clears_tracking,
    leak_reclaimed_through_detach_path, node_gone_orphan_fully_reclaimed,
    explicit_type_wins_over_model_name, model_sniff_is_only_the_fallback,
    first_seen_persisted_as_tracker, restart_resumes_grace_clock,
    restart_without_aging_still_waits_out_grace,
    unreadable_stamp_restarts_clock_but_keeps_tracking,
    failed_tracker_load_is_retried_next_tick,
    failed_tracker_persist_is_retried_backdated,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_h100_leak_is_reclaimed_as_a_gpu():
    """A leaked H100 (no JAX counterpart) gets a gpu detach-CR and its
    chip goes back to the pool through the resource controller."""
    tw = twin(PORT_ROOT)
    t = tw.types
    with seeded_uuids():
        w = World(tw, chips={H100: 16})
        rec = w.reconciler()
        leaked = w.pool.leak_attachment("worker-0", H100)
        w.syncer.sync_once(now=0.0)
        assert w.syncer.sync_once(now=200.0) == 1
        (cr,) = w.store.list(t.ComposableResource)
        assert (cr.spec.type, cr.spec.model) == ("gpu", H100)
        assert cr.metadata.labels[t.LABEL_READY_TO_DETACH] == leaked
        for _ in range(8):
            if w.store.try_get(t.ComposableResource, cr.metadata.name) is None:
                break
            rec.reconcile(cr.metadata.name)
        assert w.pool.free_chips(H100) == 16
        assert w.syncer.sync_once(now=300.0) == 0
