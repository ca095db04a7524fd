"""The resource half of tests/test_e2e_operator.py on the port: a threaded
Manager runs the ComposableResource reconciler (2 workers) against the
in-memory fabric, driven through the store as a user would.

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

Every wait is bounded (10 s).
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
