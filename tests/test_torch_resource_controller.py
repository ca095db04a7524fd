"""The port's ComposableResource reconciler
(tpu_composer_torch/controllers/resource_controller.py) against the JAX
package's (tests/test_resource_controller.py's twin).

The same CR is stepped one reconcile at a time through both reconcilers,
each over its own Store, ``InMemoryPool`` and ``FakeNodeAgent``. After
every step the two worlds are compared: the step's outcome (requeue or the
error raised), the CR's state, error, device ids, chip indices, CDI device
id and finalizers, the CDI specs the agent holds, the agent's taints, the
DeviceTaintRules and the ResourceSlice in the store, free chips, and the
recorder's events. Masked: uid, timestamps and intent nonces.

The H100 (``nvidia-h100-sxm``) has no JAX counterpart: its steps are held
to the port's own ``generate_cdi_spec(..., model="nvidia-h100-sxm")`` with
the env ``slice_env`` gives, through attach, busy, force-detach and
delete.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_operator import PORT_ROOT, mask, run_both, twin

torch.set_num_threads(1)


class World:
    """Store with nodes + the mock fabric + the fake agent + a reconciler
    that is not started: scenarios step ``reconcile`` directly."""

    def __init__(self, tw, async_steps=0, nodes=4, fabric=None):
        self.tw = tw
        self.store = tw.store.Store()
        for i in range(nodes):
            n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 8
            self.store.create(n)
        self.pool = tw.inmem.InMemoryPool(async_steps=async_steps)
        self.agent = tw.fake.FakeNodeAgent(pool=self.pool)
        self.rec = tw.rc.ComposableResourceReconciler(
            self.store, fabric or self.pool, self.agent,
            timing=tw.rc.ResourceTiming())
        self.trace = []

    # -- objects --------------------------------------------------------
    def tpu_cr(self, name="r0", node="worker-0", slice_name="s1", worker_id=0,
               topology="2x2x1", reserve=True, force=False):
        if reserve:
            self.pool.reserve_slice(slice_name, "tpu-v4", topology, [node])
        t = self.tw.types
        return self.store.create(t.ComposableResource(
            metadata=self.tw.meta.ObjectMeta(name=name),
            spec=t.ComposableResourceSpec(
                type="tpu", model="tpu-v4", target_node=node, chip_count=4,
                slice_name=slice_name, worker_id=worker_id, topology=topology,
                force_detach=force)))

    def gpu_cr(self, name="g0", node="worker-0"):
        t = self.tw.types
        return self.store.create(t.ComposableResource(
            metadata=self.tw.meta.ObjectMeta(name=name),
            spec=t.ComposableResourceSpec(type="gpu", model="gpu-a100",
                                          target_node=node)))

    def get(self, name):
        return self.store.try_get(self.tw.types.ComposableResource, name)

    def delete(self, name):
        self.store.delete(self.tw.types.ComposableResource, name)

    # -- stepping and observing ----------------------------------------
    def step(self, name, n=1):
        for _ in range(n):
            try:
                r = self.rec.reconcile(name)
                out = ("requeue", r.requeue_after)
            except Exception as e:
                out = ("raised", type(e).__name__, str(e))
            self.trace.append((name, out, self.snap(name)))
        return out

    def snap(self, name):
        cr = self.get(name)
        node = cr.spec.target_node if cr is not None else "worker-0"
        dra = self.tw.dra
        slices = {s.metadata.name: [(d.uuid, d.slice_name, d.cdi_device_id, d.model)
                                    for d in s.spec.devices]
                  for s in self.store.list(dra.ResourceSlice)}
        return dict(
            cr=None if cr is None else dict(
                state=cr.status.state, error=cr.status.error,
                device_ids=cr.status.device_ids,
                chip_indices=cr.status.chip_indices,
                cdi=cr.status.cdi_device_id, finalizers=cr.metadata.finalizers,
                deleting=cr.being_deleted, attempts=cr.status.attach_attempts,
                quarantined=cr.status.quarantined,
                pending=None if cr.status.pending_op is None else cr.status.pending_op.verb,
                failure=None if cr.status.failure is None else cr.status.failure.to_dict(),
                rv=cr.metadata.resource_version),
            published={p: self.agent.published_spec(node, p).to_dict()
                       for p in self.agent.published(node)},
            agent_taints=self.agent.taints(),
            taint_rules=sorted((r.metadata.name, r.spec.reason)
                               for r in self.store.list(dra.DeviceTaintRule)),
            slices=slices,
            free=self.pool.free_chips("tpu-v4"),
            events=[(e.type, e.reason, e.message)
                    for e in self.rec.recorder.for_object(
                        kind="ComposableResource", name=name)],
        )


# -- scenarios (each returns the world's trace) -----------------------------

def attach_path(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0", 3)  # "" -> Attaching -> Online -> health poll
    return w.trace


def colocated_groups(tw):
    w = World(tw)
    w.tpu_cr("a", slice_name="sa")
    w.tpu_cr("b", slice_name="sb")
    for name in ("a", "b"):
        w.step(name, 2)
    w.delete("a")
    w.step("a", 3)  # Online -> Detaching -> Deleting -> purged
    w.tpu_cr("c", slice_name="sc")
    w.step("c", 2)  # takes a's freed indices
    return w.trace


def async_fabric(tw):
    w = World(tw, async_steps=2)
    w.tpu_cr()
    w.step("r0", 4)
    return w.trace


def visibility_delay(tw):
    w = World(tw)
    w.tpu_cr()
    w.agent.set_visibility_delay("worker-0", 2)
    w.step("r0", 4)
    return w.trace


def missing_driver(tw):
    w = World(tw)
    w.tpu_cr()
    w.agent.set_no_driver("worker-0")
    w.step("r0", 2)
    w.agent.set_no_driver("worker-0", missing=False)
    w.step("r0", 1)
    return w.trace


def fabric_failure(tw):
    w = World(tw)
    w.tpu_cr()
    w.pool.inject_add_failure("r0")
    w.step("r0", 3)
    return w.trace


def gpu_compat(tw):
    w = World(tw)
    w.gpu_cr()
    w.step("g0", 2)
    w.delete("g0")
    w.step("g0", 3)
    return w.trace


def damped_degrade_and_recovery(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0", 2)
    chip = w.get("r0").status.device_ids[0]
    w.pool.set_health(chip, tw.provider.DeviceHealth("Critical", "ICI link down"))
    w.step("r0", w.rec.timing.health_failure_threshold + 1)
    w.pool.set_health(chip, tw.provider.DeviceHealth())
    w.step("r0", w.rec.timing.health_recovery_threshold + 1)
    return w.trace


def transient_flips(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0", 2)
    chip = w.get("r0").status.device_ids[0]
    for detail in ("blip", "another blip"):
        w.pool.set_health(chip, tw.provider.DeviceHealth("Critical", detail))
        w.step("r0")
        w.pool.set_health(chip, tw.provider.DeviceHealth())
        w.step("r0")
    return w.trace


def busy_then_idle_detach(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0", 2)
    w.delete("r0")
    w.step("r0")
    w.agent.add_load("worker-0", w.pool.attached_to("worker-0")[0])
    w.step("r0", 2)
    w.agent.clear_loads("worker-0")
    w.step("r0", 2)
    return w.trace


def force_detach(tw):
    w = World(tw)
    w.tpu_cr(force=True)
    w.step("r0", 2)
    w.agent.add_load("worker-0", w.pool.attached_to("worker-0")[0])
    w.delete("r0")
    w.step("r0", 3)
    return w.trace


def delete_while_attaching(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0")
    w.delete("r0")
    w.step("r0", 2)
    return w.trace


def taints_while_fabric_detaches(tw):
    w = World(tw, async_steps=2)
    w.tpu_cr()
    w.step("r0", 4)
    w.delete("r0")
    w.step("r0", 5)
    return w.trace


def node_gone(tw):
    w = World(tw)
    w.tpu_cr()
    w.step("r0", 2)
    w.store.delete(tw.types.Node, "worker-0")
    w.step("r0", 2)
    return w.trace


def ready_to_detach_adoption(tw):
    w = World(tw)
    leaked = w.pool.leak_attachment("worker-1", "tpu-v4")
    t = tw.types
    w.store.create(t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name="detach-cr",
                                    labels={t.LABEL_READY_TO_DETACH: leaked}),
        spec=t.ComposableResourceSpec(type="tpu", model="tpu-v4",
                                      target_node="worker-1")))
    w.step("detach-cr", 4)
    w.trace.append(("absent", w.rec.reconcile("ghost").requeue_after))
    return w.trace


def _flaky(tw, failures):
    """A pool whose attach fails transiently ``failures`` times."""
    class Flaky(tw.inmem.InMemoryPool):
        left = failures

        def add_resource(self, resource):
            if Flaky.left > 0:
                Flaky.left -= 1
                raise tw.provider.TransientFabricError("connection reset")
            return super().add_resource(resource)

    return Flaky()


def attach_budget_quarantine(tw):
    w = World(tw)
    w.pool = _flaky(tw, 10)
    w.agent = tw.fake.FakeNodeAgent(pool=w.pool)
    w.rec = tw.rc.ComposableResourceReconciler(
        w.store, w.pool, w.agent, timing=tw.rc.ResourceTiming(attach_budget=3))
    w.tpu_cr()
    w.step("r0", 5)
    return w.trace


def attach_budget_withheld_on_the_last_node(tw):
    w = World(tw, nodes=1)
    w.pool = _flaky(tw, 4)
    w.agent = tw.fake.FakeNodeAgent(pool=w.pool)
    w.rec = tw.rc.ComposableResourceReconciler(
        w.store, w.pool, w.agent, timing=tw.rc.ResourceTiming(attach_budget=2))
    w.tpu_cr()
    w.step("r0", 6)
    return w.trace


def deletion_races(tw):
    w = World(tw)
    w.gpu_cr()
    w.step("g0")
    w.delete("g0")
    w.step("g0")
    stale = w.get("g0")
    w.step("g0")
    out = [w.trace, w.rec._handle_deleting(stale).requeue_after]
    w2 = World(tw)
    w2.tpu_cr()
    w2.step("r0", 2)
    w2.delete("r0")
    w2.step("r0")
    stale = w2.get("r0")
    w2.store.delete(tw.types.ComposableResource, "r0")
    obj = w2.get("r0")
    obj.metadata.finalizers = []
    w2.store.update(obj)
    out += [w2.rec._handle_detaching(stale).requeue_after,
            w2.pool.attached_to("worker-0"), w2.trace]
    return out


SCENARIOS = [attach_path, colocated_groups, async_fabric, visibility_delay,
             missing_driver, fabric_failure, gpu_compat,
             damped_degrade_and_recovery, transient_flips,
             busy_then_idle_detach, force_detach, delete_while_attaching,
             taints_while_fabric_detaches, node_gone, ready_to_detach_adoption,
             attach_budget_quarantine, attach_budget_withheld_on_the_last_node,
             deletion_races]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_reconciler_twin(scenario):
    jax_trace, port_trace = run_both(scenario)
    assert port_trace == jax_trace
    assert port_trace


def test_twin_reaches_the_states_it_claims():
    """The twin traces are not vacuous: the attach path ends Online with
    a published TPU spec, the detach path purges."""
    _, trace = run_both(attach_path)
    final = trace[-1][2]
    assert final["cr"]["state"] == "Online"
    edits = final["published"]["s1-worker0"]["devices"][0]["containerEdits"]
    assert [n["path"] for n in edits["deviceNodes"]] == [
        "/dev/accel0", "/dev/accel1", "/dev/accel2", "/dev/accel3"]
    _, trace = run_both(colocated_groups)
    assert [s["cr"] for n, _, s in trace if n == "a"][-1] is None
    assert [s["cr"]["chip_indices"] for n, _, s in trace if n == "c"][-1] == [0, 1, 2, 3]


# -- the H100: the port's own reference ------------------------------------

PORT = twin(PORT_ROOT)
H100 = "nvidia-h100-sxm"


def _h100_world(topology="2x1", force=False, chips=2):
    w = World(PORT)
    w.pool.reserve_slice("cs", H100, topology, ["worker-0"])
    t = PORT.types
    w.store.create(t.ComposableResource(
        metadata=PORT.meta.ObjectMeta(name="h0"),
        spec=t.ComposableResourceSpec(
            type="gpu", model=H100, target_node="worker-0", chip_count=chips,
            slice_name="cs", worker_id=0, topology=topology,
            force_detach=force)))
    return w


def _expected_spec(chips, topology, indices):
    status = PORT.types.SliceStatus(name="cs", topology=topology, num_hosts=1,
                                    chips_per_host=chips,
                                    worker_hostnames=["worker-0"])
    return PORT.cdi.generate_cdi_spec(
        slice_name="cs", worker_id=0, chip_indices=indices,
        env=PORT.coordinates.slice_env(status, 0, H100), model=H100)


@pytest.mark.parametrize("chips,topology", [(1, "1x1"), (2, "2x1"), (8, "8x1")])
def test_h100_attach_publishes_the_ports_spec(chips, topology):
    w = _h100_world(topology, chips=chips)
    w.step("h0", 2)
    cr = w.get("h0")
    assert cr.status.state == "Online"
    assert cr.status.chip_indices == list(range(chips))
    assert cr.status.cdi_device_id == f"tpu.composer.dev/gpu=cs-worker0"
    spec = w.agent.published_spec("worker-0", "cs-worker0")
    expected = _expected_spec(chips, topology, list(range(chips)))
    assert spec == expected
    assert spec.qualified_name == cr.status.cdi_device_id
    assert spec.device_nodes[chips:] == list(PORT.cdi.NVIDIA_CONTROL_NODES)
    assert spec.env["WORLD_SIZE"] == str(chips)
    assert spec.env["COMPOSER_ACCELERATOR_MODEL"] == H100
    # The ResourceSlice lists the group's GPUs under its CDI device.
    (sl,) = w.store.list(PORT.dra.ResourceSlice)
    assert [(d.uuid, d.slice_name, d.cdi_device_id) for d in sl.spec.devices] == [
        (u, "cs-worker0", cr.status.cdi_device_id) for u in cr.status.device_ids]


def test_h100_owner_request_supplies_the_coordinates():
    w = _h100_world()
    t = PORT.types
    req = t.ComposabilityRequest(
        metadata=PORT.meta.ObjectMeta(name="job"),
        spec=t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(type="gpu", model=H100, size=4)))
    req.status.slice = t.SliceStatus(name="cs", topology="2x2", num_hosts=2,
                                     chips_per_host=2,
                                     worker_hostnames=["worker-0", "worker-1"])
    w.store.create(req)
    obj = w.get("h0")
    obj.metadata.labels[t.LABEL_MANAGED_BY] = "job"
    w.store.update(obj)
    w.step("h0", 2)
    spec = w.agent.published_spec("worker-0", "cs-worker0")
    assert spec.env == PORT.coordinates.slice_env(req.status.slice, 0, H100)
    assert spec.env["WORLD_SIZE"] == "4" and spec.env["PET_NNODES"] == "2"


def test_h100_colocated_groups_get_disjoint_ordinals():
    w = World(PORT)
    t = PORT.types
    for name in ("a", "b"):
        w.pool.reserve_slice(f"s{name}", H100, "4x1", ["worker-0"])
        w.store.create(t.ComposableResource(
            metadata=PORT.meta.ObjectMeta(name=name),
            spec=t.ComposableResourceSpec(
                type="gpu", model=H100, target_node="worker-0", chip_count=4,
                slice_name=f"s{name}", worker_id=0, topology="4x1")))
        w.step(name, 2)
    nodes = {n: w.agent.published_spec("worker-0", f"s{n}-worker0").device_nodes[:4]
             for n in ("a", "b")}
    assert nodes == {"a": [f"/dev/nvidia{i}" for i in range(4)],
                     "b": [f"/dev/nvidia{i}" for i in range(4, 8)]}


def test_h100_busy_then_force_detach_then_gone():
    w = _h100_world()
    w.step("h0", 2)
    devices = list(w.get("h0").status.device_ids)
    w.agent.add_load("worker-0", devices[0])
    w.delete("h0")
    w.step("h0")  # Online -> Detaching
    assert w.get("h0").status.state == "Detaching"
    w.step("h0")  # the busy guard holds it
    cr = w.get("h0")
    assert cr.status.state == "Detaching" and "in use" in cr.status.error
    assert w.agent.published("worker-0") == ["cs-worker0"]
    # The load check comes first: nothing is tainted or drained yet.
    assert w.agent.taints() == {} and w.agent.drain_calls == []
    cr.spec.force_detach = True
    w.store.update(cr)
    w.step("h0")  # force: drain, fabric remove, retract, untaint
    cr = w.get("h0")
    assert cr.status.state == "Deleting" and cr.status.device_ids == []
    assert w.agent.published("worker-0") == []
    assert w.agent.taints() == {} and w.store.list(PORT.dra.DeviceTaintRule) == []
    assert w.store.list(PORT.dra.ResourceSlice) == []
    assert w.agent.drain_calls[-1] == ("worker-0", tuple(devices), True)
    w.step("h0")
    assert w.get("h0") is None
    w.pool.release_slice("cs")
    assert w.pool.free_chips(H100) == 16


def test_h100_trace_masks_only_identities():
    """The masked fields of a trace are exactly the identities and clocks."""
    w = _h100_world()
    w.step("h0", 1)
    d = mask(w.get("h0").to_dict())
    assert d["metadata"]["uid"] is True and d["metadata"]["creationTimestamp"] is True
    assert d["status"]["pending_op"]["nonce"] is True
    assert d["status"]["pending_op"]["verb"] == "add"
