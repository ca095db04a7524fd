"""tests/test_e2e_operator.py on the port: a threaded Manager runs the
reconcilers (2 workers each) against the in-memory fabric, driven through
the store as a user would.

- A TPU CR goes to Online and then to gone, with the same script on the
  JAX operator and the port's; what each operator published (state,
  device ids, chip indices, CDI device id, the agent's spec, the
  ResourceSlice) is compared. Masked: uid, timestamps, intent nonces.
- An H100 CR goes through the same cycle on the port with
  ``LocalNodeAgent`` over a fake NVIDIA host (minors 0 and 3): Online
  through the device scan with the spec file naming the rebased node, the
  control nodes and ``slice_env``'s torchrun env; busy while a process
  holds the node; force-detached; gone once the test removes the node
  (an in-memory fabric cannot take a card off a host).
- The request half, on both operators (request and resource reconcilers,
  the syncer, adoption as the startup hook): a tpu-v4 request of 8 to
  Running and cleaned up, concurrent requests sharing the pool, the
  syncer reclaiming a leak, a live resize, and a lost member recovered
  through the watch (the Running poll at 600 s). Threads interleave
  differently in the two runs, so what is compared carries no generated
  name: slices, row and device counts, the pool's free chips.
- An H100 request of 8 through the same cycle on the port with
  ``LocalNodeAgent`` over a fake host of 8 GPUs.

Tolerance: exact. Every wait is bounded (10 s).
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from tests.torch_operator import PORT_ROOT, nvidia_host, run_both, twin, wait_for

torch.set_num_threads(1)

FAST = dict(attach_poll=0.05, visibility_poll=0.05, detach_poll=0.05,
            detach_fast=0.05, busy_poll=0.05)


def _operator(tw, agent_factory=None, nodes=("worker-0", "worker-1"), slots=8):
    store = tw.store.Store()
    for name in nodes:
        n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=name))
        n.status.tpu_slots = slots
        store.create(n)
    pool = tw.inmem.InMemoryPool()
    agent = (agent_factory or (lambda p: tw.fake.FakeNodeAgent(pool=p)))(pool)
    mgr = tw.manager.Manager(store=store, health_addr="127.0.0.1:0")
    rec = tw.rc.ComposableResourceReconciler(
        store, pool, agent, timing=tw.rc.ResourceTiming(**FAST))
    mgr.add_controller(rec)
    mgr.start(workers_per_controller=2)
    return store, pool, agent, mgr, rec


def _state(store, tw, name):
    cr = store.try_get(tw.types.ComposableResource, name)
    return None if cr is None else cr.status.state


def tpu_cycle(tw):
    store, pool, agent, mgr, rec = _operator(tw)
    CR = tw.types.ComposableResource
    try:
        pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["worker-0"])
        store.create(CR(
            metadata=tw.meta.ObjectMeta(name="r0"),
            spec=tw.types.ComposableResourceSpec(
                type="tpu", model="tpu-v4", target_node="worker-0", chip_count=4,
                slice_name="s1", worker_id=0, topology="2x2x1")))
        assert wait_for(lambda: _state(store, tw, "r0") == "Online")
        cr = store.get(CR, "r0")
        online = dict(
            device_ids=cr.status.device_ids, chip_indices=cr.status.chip_indices,
            cdi=cr.status.cdi_device_id, finalizers=cr.metadata.finalizers,
            spec=agent.published_spec("worker-0", "s1-worker0").to_dict(),
            slice=[(d.uuid, d.slice_name) for s in store.list(tw.dra.ResourceSlice)
                   for d in s.spec.devices])
        store.delete(CR, "r0")
        assert wait_for(lambda: store.try_get(CR, "r0") is None)
        pool.release_slice("s1")
        gone = dict(published=agent.published("worker-0"), taints=agent.taints(),
                    slices=store.list(tw.dra.ResourceSlice),
                    free=pool.free_chips("tpu-v4"))
        events = sorted(e.reason for e in rec.recorder.for_object(kind="ComposableResource",
                                                                  name="r0"))
        return [online, gone, events]
    finally:
        mgr.stop()


def test_tpu_cr_online_then_gone_twin():
    jax_out, port_out = run_both(tpu_cycle)
    assert port_out == jax_out
    online, gone, events = port_out
    assert online["chip_indices"] == [0, 1, 2, 3] and len(online["device_ids"]) == 4
    assert gone == dict(published=[], taints={}, slices=[], free=64)
    assert events == ["Attached", "Detached"]


PORT = twin(PORT_ROOT)
H100 = "nvidia-h100-sxm"


def test_h100_cr_cycle_with_a_local_agent(tmp_path):
    host = nvidia_host(str(tmp_path), minors=(0, 3))
    store, pool, agent, mgr, rec = _operator(
        PORT, lambda p: PORT.nodeagent.LocalNodeAgent(**host), nodes=("gpu-host",))
    CR, t = PORT.types.ComposableResource, PORT.types
    try:
        assert agent.ensure_driver("gpu-host") == "host"
        # Worker 0 of a 2-GPU slice on this host: ordinals 0 and 1, which
        # the agent publishes as the host's minors 0 and 3.
        pool.reserve_slice("cs", H100, "2x1", ["gpu-host"])
        store.create(CR(
            metadata=PORT.meta.ObjectMeta(name="h0"),
            spec=t.ComposableResourceSpec(
                type="gpu", model=H100, target_node="gpu-host", chip_count=2,
                slice_name="cs", worker_id=0, topology="2x1")))
        assert wait_for(lambda: _state(store, PORT, "h0") == "Online"), \
            store.get(CR, "h0").status.to_dict()
        cr = store.get(CR, "h0")
        assert cr.status.chip_indices == [0, 1]
        path = os.path.join(host["cdi_dir"], "tpu.composer.dev-gpu-cs-worker0.json")
        with open(path) as f:
            doc = json.load(f)
        assert doc["kind"] == "tpu.composer.dev/gpu"
        edits = doc["devices"][0]["containerEdits"]
        assert [n["path"] for n in edits["deviceNodes"]] == [
            "/dev/nvidia0", "/dev/nvidia3", "/dev/nvidiactl", "/dev/nvidia-uvm",
            "/dev/nvidia-uvm-tools"]
        env = PORT.coordinates.slice_env(
            t.SliceStatus(name="cs", topology="2x1", num_hosts=1, chips_per_host=2,
                          worker_hostnames=["gpu-host"]), 0, H100)
        assert edits["env"] == [f"{k}={v}" for k, v in sorted(env.items())]
        assert f"tpu.composer.dev/gpu=cs-worker0" == cr.status.cdi_device_id
        (sl,) = store.list(PORT.dra.ResourceSlice)
        assert sorted(d.uuid for d in sl.spec.devices) == sorted(cr.status.device_ids)

        # A process opens the second GPU: the detach waits on it.
        fd = os.path.join(host["proc_dir"], "4242", "fd")
        os.makedirs(fd)
        with open(os.path.join(host["proc_dir"], "4242", "comm"), "w") as f:
            f.write("python3\n")
        os.symlink(os.path.join(host["dev_dir"], "nvidia3"), os.path.join(fd, "9"))
        store.delete(CR, "h0")
        assert wait_for(lambda: "in use" in store.get(CR, "h0").status.error)
        assert not agent.check_no_loads("gpu-host", cr.status.device_ids,
                                        group="cs-worker0")
        with pytest.raises(PORT.nodeagent.DeviceBusyError, match="4242"):
            agent.drain("gpu-host", cr.status.device_ids, group="cs-worker0")

        # Force: drained, released, retracted; the nodes still enumerate,
        # so the detach holds until they go.
        obj = store.get(CR, "h0")
        obj.spec.force_detach = True
        store.update(obj)
        assert wait_for(lambda: not os.path.exists(path))
        assert store.get(CR, "h0").status.state == "Detaching"
        assert pool.attached_to("gpu-host") == []
        for m in (0, 3):
            os.remove(os.path.join(host["dev_dir"], f"nvidia{m}"))
        assert wait_for(lambda: store.try_get(CR, "h0") is None)
        assert store.list(PORT.dra.ResourceSlice) == []
        assert store.list(PORT.dra.DeviceTaintRule) == []
        assert not any(agent.has_device_taint("gpu-host", d) for d in cr.status.device_ids)
        reasons = [e.reason for e in rec.recorder.for_object(kind="ComposableResource",
                                                             name="h0")]
        assert reasons[0] == "Attached" and "DeviceBusy" in reasons
        assert reasons[-1] == "Detached"
    finally:
        mgr.stop()


def test_h100_cr_without_a_driver_surfaces_the_error(tmp_path):
    host = nvidia_host(str(tmp_path), minors=(0,), driver="none")
    store, pool, agent, mgr, rec = _operator(
        PORT, lambda p: PORT.nodeagent.LocalNodeAgent(**host), nodes=("gpu-host",))
    CR = PORT.types.ComposableResource
    try:
        pool.reserve_slice("cs", H100, "1x1", ["gpu-host"])
        store.create(CR(
            metadata=PORT.meta.ObjectMeta(name="h0"),
            spec=PORT.types.ComposableResourceSpec(
                type="gpu", model=H100, target_node="gpu-host", chip_count=1,
                slice_name="cs", worker_id=0, topology="1x1")))
        assert wait_for(lambda: "no NVIDIA driver" in store.get(CR, "h0").status.error)
        assert store.get(CR, "h0").status.state == "Attaching"
    finally:
        mgr.stop()


# -- the request half (tests/test_e2e_operator.py:74-196) ---------------------------

REQ_FAST = dict(updating_poll=0.05, cleaning_poll=0.05)


def _request_operator(tw, running_poll=None, syncer=True):
    """tests/test_e2e_operator.py's operator fixture on either package: 8
    workers of 4 slots, the in-memory pool, the fake agent, a Manager
    running the request and resource reconcilers (2 workers each) and the
    syncer; adoption as its startup hook."""
    store = tw.store.Store()
    for i in range(8):
        n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        n.status.tpu_slots = 4
        store.create(n)
    pool = tw.inmem.InMemoryPool(chips={"tpu-v4": 64})
    agent = tw.fake.FakeNodeAgent(pool=pool)
    timing = dict(REQ_FAST)
    if running_poll is not None:
        timing["running_poll"] = running_poll
    req_rec = tw.req.ComposabilityRequestReconciler(
        store, pool, timing=tw.req.RequestTiming(**timing))
    mgr = tw.manager.Manager(store=store, health_addr="127.0.0.1:0",
                             decisions=req_rec.scheduler.ledger)
    mgr.add_controller(req_rec)
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, pool, agent, timing=tw.rc.ResourceTiming(**FAST),
        decision_ledger=req_rec.scheduler.ledger))
    if syncer:
        mgr.add_runnable(tw.syncer.UpstreamSyncer(store, pool, period=0.05,
                                                  grace=0.2))
    mgr.add_startup_hook(lambda: tw.adoption.adopt_pending_ops(store, pool))
    mgr.start(workers_per_controller=2)
    return store, pool, agent, mgr


def _submit(tw, store, name, size, type_="tpu", model="tpu-v4"):
    store.create(tw.types.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=tw.types.ComposabilityRequestSpec(
            resource=tw.types.ResourceDetails(type=type_, model=model, size=size))))


def _req(tw, store, name):
    return store.try_get(tw.types.ComposabilityRequest, name)


def _running(tw, store, name):
    r = _req(tw, store, name)
    return r is not None and r.status.state == "Running"


def tpu8_request_reaches_running_and_cleans_up(tw):
    store, pool, agent, mgr = _request_operator(tw)
    try:
        _submit(tw, store, "job", 8)
        assert wait_for(lambda: _running(tw, store, "job"))
        req = _req(tw, store, "job")
        out = [req.status.slice.to_dict(), len(req.status.resources),
               sorted(len(r.device_ids) for r in req.status.resources.values()),
               [bool(agent.published(h)) for h in req.status.slice.worker_hostnames]]
        assert out[0]["topology"] == "2x2x2" and out[1] == 2 and all(out[3])
        store.delete(tw.types.ComposabilityRequest, "job")
        assert wait_for(lambda: _req(tw, store, "job") is None)
        assert wait_for(lambda: not store.list(tw.types.ComposableResource))
        assert wait_for(lambda: pool.free_chips("tpu-v4") == 64)
        return out + [sorted(pool._slices)]
    finally:
        mgr.stop()


def concurrent_requests_share_the_pool(tw):
    store, pool, agent, mgr = _request_operator(tw)
    try:
        for i in range(3):
            _submit(tw, store, f"job-{i}", 4)
        assert wait_for(lambda: all(_running(tw, store, f"job-{i}")
                                    for i in range(3)))
        used = {rs.node_name for i in range(3)
                for rs in _req(tw, store, f"job-{i}").status.resources.values()}
        assert pool.free_chips("tpu-v4") == 64 - 12 and len(used) == 3
        return [pool.free_chips("tpu-v4"), len(used)]
    finally:
        mgr.stop()


def syncer_reclaims_leak_while_operator_runs(tw):
    store, pool, agent, mgr = _request_operator(tw)
    try:
        before = pool.free_chips("tpu-v4")
        pool.leak_attachment("worker-5", "tpu-v4")
        assert wait_for(lambda: pool.free_chips("tpu-v4") == before)
        assert wait_for(lambda: not store.list(tw.types.ComposableResource))
        return pool.free_chips("tpu-v4")
    finally:
        mgr.stop()


def live_resize_grows_slice(tw):
    store, pool, agent, mgr = _request_operator(tw)
    try:
        _submit(tw, store, "job", 4)
        assert wait_for(lambda: _running(tw, store, "job"))
        first = _req(tw, store, "job").status.slice.worker_hostnames[0]
        req = _req(tw, store, "job")
        req.spec.resource.size = 16
        store.update(req)
        assert wait_for(lambda: _running(tw, store, "job")
                        and _req(tw, store, "job").status.slice.num_hosts == 4)
        sl = _req(tw, store, "job").status.slice
        assert sl.worker_hostnames[0] == first
        assert pool.free_chips("tpu-v4") == 64 - 16
        return [sl.topology, sl.num_hosts, pool.free_chips("tpu-v4")]
    finally:
        mgr.stop()


def member_loss_resolves_via_watch_not_poll(tw):
    """With the Running safety poll at 600 s only the child's DELETED
    watch event can wake the request: recovery inside the wait bound is
    event-driven."""
    store, pool, agent, mgr = _request_operator(tw, running_poll=600.0,
                                                syncer=False)
    t = tw.types
    try:
        _submit(tw, store, "job", 8)
        assert wait_for(lambda: _running(tw, store, "job"))
        victim = store.list(t.ComposableResource,
                            label_selector={t.LABEL_MANAGED_BY: "job"})[0]
        store.delete(t.ComposableResource, victim.metadata.name)
        assert wait_for(lambda: _running(tw, store, "job") and sum(
            len(rs.device_ids)
            for rs in _req(tw, store, "job").status.resources.values()) == 8)
        return _req(tw, store, "job").status.slice.topology
    finally:
        mgr.stop()


@pytest.mark.parametrize("scenario", [
    tpu8_request_reaches_running_and_cleans_up, concurrent_requests_share_the_pool,
    syncer_reclaims_leak_while_operator_runs, live_resize_grows_slice,
    member_loss_resolves_via_watch_not_poll], ids=lambda f: f.__name__)
def test_request_operator_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_h100_request_cycle_with_a_local_agent(tmp_path):
    """An H100 request of 8 on the port's threaded operator, over a fake
    host of 8 GPUs (minors 0-7): solved to ``8x1``, placed by the
    scheduler's native scan, reserved in the pool, one child of 8 GPUs
    Online through the device scan, its spec file carrying slice_env of
    the request's slice, the placement explained on the health port;
    deleted, the request waits in Cleaning until the test removes the
    nodes (the in-memory fabric cannot take cards off a host), then goes
    with its reservation."""
    import urllib.request

    host = nvidia_host(str(tmp_path), minors=tuple(range(8)))
    store = PORT.store.Store()
    node = PORT.types.Node(metadata=PORT.meta.ObjectMeta(name="gpu-host"))
    node.status.tpu_slots = 8
    store.create(node)
    pool = PORT.inmem.InMemoryPool(chips={H100: 16})
    agent = PORT.nodeagent.LocalNodeAgent(**host)
    req_rec = PORT.req.ComposabilityRequestReconciler(
        store, pool, timing=PORT.req.RequestTiming(**REQ_FAST))
    led = req_rec.scheduler.ledger
    mgr = PORT.manager.Manager(store=store, health_addr="127.0.0.1:0",
                               decisions=led)
    mgr.add_controller(req_rec)
    mgr.add_controller(PORT.rc.ComposableResourceReconciler(
        store, pool, agent, timing=PORT.rc.ResourceTiming(**FAST),
        decision_ledger=led))
    mgr.add_startup_hook(lambda: PORT.adoption.adopt_pending_ops(store, pool))
    mgr.start(workers_per_controller=2)
    t = PORT.types
    try:
        _submit(PORT, store, "job", 8, type_="gpu", model=H100)
        assert wait_for(lambda: _running(PORT, store, "job")), \
            _req(PORT, store, "job").status.to_dict()
        req = _req(PORT, store, "job")
        assert req.status.slice.to_dict() == dict(
            name="job-slice", topology="8x1", num_hosts=1, chips_per_host=8,
            worker_hostnames=["gpu-host"])
        assert req_rec.scheduler.engine.last_scan_kind == "native"
        assert pool.has_slice("job-slice")
        (child,) = store.list(t.ComposableResource,
                              label_selector={t.LABEL_MANAGED_BY: "job"})
        assert (child.spec.type, child.spec.chip_count, child.status.state) == (
            "gpu", 8, "Online")
        assert child.status.chip_indices == list(range(8))
        path = os.path.join(host["cdi_dir"], "tpu.composer.dev-gpu-job-slice-worker0.json")
        with open(path) as f:
            edits = json.load(f)["devices"][0]["containerEdits"]
        env = PORT.coordinates.slice_env(req.status.slice, 0, H100)
        assert edits["env"] == [f"{k}={v}" for k, v in sorted(env.items())]
        assert env["WORLD_SIZE"] == "8" and env["LOCAL_WORLD_SIZE"] == "8"
        assert [n["path"] for n in edits["deviceNodes"]][:8] == [
            f"/dev/nvidia{m}" for m in range(8)]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mgr.health_port}/debug/scheduler/explain/job",
                timeout=10) as resp:
            doc = json.load(resp)
        assert doc["engine"] == "native"
        assert doc["latest"]["outcome"] == "placed"
        assert doc["latest"]["chosen"] == ["gpu-host"]
        assert len(doc["latest"]["nonces"]) == 1  # the attach intent joined

        store.delete(t.ComposabilityRequest, "job")
        assert wait_for(lambda: not os.path.exists(path))
        assert _req(PORT, store, "job").status.state == "Cleaning"
        for m in range(8):
            os.remove(os.path.join(host["dev_dir"], f"nvidia{m}"))
        assert wait_for(lambda: _req(PORT, store, "job") is None)
        assert not store.list(t.ComposableResource)
        assert wait_for(lambda: not pool.has_slice("job-slice"))
        assert pool.free_chips(H100) == 16
    finally:
        mgr.stop()
