"""The port's kubelet device plugin and device publication against the
JAX package's (tests/test_publication.py's twin): ``TPUDevicePlugin``
speaking the kubelet device-plugin gRPC protocol over real unix sockets
to a fake kubelet (Registration, then ListAndWatch and Allocate dialled
back), the DRA ``DevicePublisher`` (claim, quarantine, retract), and a
live operator whose attach publishes and whose detach retracts.

Each scenario runs once per package (``run_both``); the plugin's
messages are the same protobuf classes in both (the port's
``deviceplugin_pb2`` adds a byte-identical descriptor to the default
pool), so their answers compare whole. The H100 cases have no JAX
counterpart: ``Allocate`` of a GPU answers its device node, NVIDIA's
control nodes, the GPU spec's CDI name and ``CUDA_VISIBLE_DEVICES``
numbering the allocated GPUs as the container sees them (``0..n-1``,
with ``CUDA_DEVICE_ORDER=PCI_BUS_ID``), through ``lister_from_agent``
over a real agent's claim on a fake NVIDIA host. Tolerance: exact.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time

import grpc
import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, nvidia_host, run_both, twin

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"
PB = twin(PORT_ROOT).pb


@pytest.fixture
def sock_dir(tmp_path_factory):
    """A short directory for the unix sockets: a socket's path must stay
    under 108 bytes, which a test's own tmp_path may pass."""
    return tmp_path_factory.mktemp("dp")


def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def test_both_packages_share_one_descriptor():
    jax_pb, port_pb = twin(JAX_ROOT).pb, PB
    assert port_pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert port_pb.AllocateRequest is jax_pb.AllocateRequest
    with open(os.path.join(os.path.dirname(port_pb.__file__),
                           "deviceplugin.proto")) as f:
        port_proto = f.read()
    with open(os.path.join(os.path.dirname(jax_pb.__file__),
                           "deviceplugin.proto")) as f:
        jax_proto = f.read()
    strip = [line for line in port_proto.splitlines()
             if not line.startswith("//")]
    assert strip == [line for line in jax_proto.splitlines()
                     if not line.startswith("//")]


class FakeKubelet:
    """The kubelet side of the device-plugin contract: serves
    Registration, dials back to registered plugins, consumes ListAndWatch,
    can Allocate."""

    def __init__(self, plugin_dir, api_version):
        self.plugin_dir = plugin_dir
        self.api = api_version
        self.registered = {}
        self.devices = {}
        self._server = None
        self._lock = threading.Lock()

    def _register(self, request, context):
        with self._lock:
            self.registered[request.resource_name] = request.endpoint
        threading.Thread(target=self._consume, daemon=True, args=(
            request.resource_name, request.endpoint)).start()
        return PB.Empty()

    def _consume(self, resource, endpoint):
        channel = grpc.insecure_channel(
            f"unix:{os.path.join(self.plugin_dir, endpoint)}")
        stream = channel.unary_stream(
            f"/{self.api}.DevicePlugin/ListAndWatch",
            request_serializer=PB.Empty.SerializeToString,
            response_deserializer=PB.ListAndWatchResponse.FromString)
        try:
            for resp in stream(PB.Empty()):
                with self._lock:
                    self.devices[resource] = [(d.ID, d.health)
                                              for d in resp.devices]
        except grpc.RpcError:
            pass

    def allocate(self, resource, device_ids):
        sock = os.path.join(self.plugin_dir, self.registered[resource])
        with grpc.insecure_channel(f"unix:{sock}") as channel:
            allocate = channel.unary_unary(
                f"/{self.api}.DevicePlugin/Allocate",
                request_serializer=PB.AllocateRequest.SerializeToString,
                response_deserializer=PB.AllocateResponse.FromString)
            return allocate(PB.AllocateRequest(container_requests=[
                PB.ContainerAllocateRequest(devices_ids=list(device_ids))]),
                timeout=5.0)

    def start(self):
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4))
        handlers = {"Register": grpc.unary_unary_rpc_method_handler(
            self._register,
            request_deserializer=PB.RegisterRequest.FromString,
            response_serializer=PB.Empty.SerializeToString)}
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                f"{self.api}.Registration", handlers),))
        os.makedirs(self.plugin_dir, exist_ok=True)
        self._server.add_insecure_port(
            f"unix:{os.path.join(self.plugin_dir, 'kubelet.sock')}")
        self._server.start()

    def stop(self):
        if self._server:
            self._server.stop(grace=0.5)


def _plugin_world(tw, plugin_dir, list_devices, **kw):
    kubelet = FakeKubelet(plugin_dir, tw.plugin.API_VERSION)
    kubelet.start()
    plugin = tw.plugin.TPUDevicePlugin(list_devices, plugin_dir,
                                       node_name="worker-0", **kw)
    plugin.start()
    plugin.register_with_kubelet()
    return kubelet, plugin


def _response(resp):
    (c,) = resp.container_responses
    return {"envs": dict(c.envs),
            "devices": [(d.container_path, d.host_path, d.permissions)
                        for d in c.devices],
            "cdi": [d.name for d in c.cdi_devices],
            "mounts": len(c.mounts)}


def test_pod_claims_composed_chip(sock_dir):
    def scenario(tw):
        devices = {}
        kubelet, plugin = _plugin_world(
            tw, str(sock_dir / tw.root[-1]),
            lambda: [d for g in sorted(devices) for d in devices[g]])
        resource = tw.plugin.RESOURCE_NAME
        try:
            out = [wait_for(lambda: resource in kubelet.registered, 5),
                   wait_for(lambda: kubelet.devices.get(resource) == [], 5)]
            devices["slice-a-worker0"] = [
                ("slice-a-worker0/0", True, "/dev/accel0",
                 "tpu.composer.dev/chip=slice-a-worker0"),
                ("slice-a-worker0/1", True, "/dev/accel1",
                 "tpu.composer.dev/chip=slice-a-worker0")]
            plugin.notify()
            out.append(wait_for(
                lambda: len(kubelet.devices.get(resource, [])) == 2, 5))
            out.append(sorted(kubelet.devices[resource]))
            out.append(_response(kubelet.allocate(
                resource, ["slice-a-worker0/0"])))
            devices.clear()
            plugin.notify()
            out.append(wait_for(
                lambda: kubelet.devices.get(resource) == [], 5))
            return out
        finally:
            plugin.stop()
            kubelet.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out[:3] == [True, True, True] and port_out[-1] is True
    assert port_out[4] == {
        "envs": {"TPU_VISIBLE_CHIPS": "slice-a-worker0/0"},
        "devices": [["/dev/accel0", "/dev/accel0", "rw"]],
        "cdi": ["tpu.composer.dev/chip=slice-a-worker0"], "mounts": 0}


def test_allocate_unknown_device_fails(sock_dir):
    def scenario(tw):
        kubelet, plugin = _plugin_world(tw, str(sock_dir / tw.root[-1]),
                                        lambda: [])
        try:
            assert wait_for(
                lambda: tw.plugin.RESOURCE_NAME in kubelet.registered, 5)
            try:
                kubelet.allocate(tw.plugin.RESOURCE_NAME, ["ghost/0"])
            except grpc.RpcError as e:
                return [e.code().name, e.details()]
            return ["allocated"]
        finally:
            plugin.stop()
            kubelet.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out == ["NOT_FOUND", "device ghost/0 not available on this node"]


@pytest.mark.parametrize("gpus,take,want", [
    ([1], [0], ["nvidia3"]),
    ([0, 1], [0, 1], ["nvidia0", "nvidia3"]),
    ([0, 1], [1], ["nvidia3"]),
    ([0, 1], [0], ["nvidia0"]),
], ids=["one", "two", "second_alone", "first_alone"])
def test_h100_allocate_answers_node_cdi_and_cuda_visible_devices(tmp_path,
                                                                 sock_dir,
                                                                 gpus, take,
                                                                 want):
    """An H100 group composed of ``gpus`` (the host's ordinals) on a fake
    host with GPUs of minors 0 and 3: the kubelet's Allocate of the
    group's devices ``take`` gets each ``/dev/nvidia<minor>``, the
    control nodes once, the group's CDI name once and
    ``CUDA_VISIBLE_DEVICES`` numbering them ``0..n-1`` as the container,
    which holds only their nodes, sees them, whatever their place on the
    host."""
    tw = twin(PORT_ROOT)
    kw = nvidia_host(str(tmp_path / "host"), minors=(0, 3))
    agent = tw.nodeagent.LocalNodeAgent(**kw)
    spec = tw.cdi.generate_cdi_spec("g-slice", 0, gpus, model=H100)
    agent.refresh_device_stack("worker-0", spec=spec)
    listed = tw.plugin.lister_from_agent(agent)()
    kubelet, plugin = _plugin_world(
        tw, str(sock_dir), tw.plugin.lister_from_agent(agent))
    try:
        resource = tw.plugin.RESOURCE_NAME
        assert wait_for(lambda: len(kubelet.devices.get(resource, []))
                        == len(gpus), 5)
        assert kubelet.devices[resource] == [(d[0], "Healthy")
                                             for d in listed]
        got = _response(kubelet.allocate(resource,
                                         [listed[i][0] for i in take]))
    finally:
        plugin.stop()
        kubelet.stop()
    want_nodes = ([os.path.join(kw["dev_dir"], n) for n in want]
                  + list(tw.cdi.NVIDIA_CONTROL_NODES))
    assert got == {
        "envs": {"CUDA_VISIBLE_DEVICES": ",".join(map(str, range(len(take)))),
                 "CUDA_DEVICE_ORDER": "PCI_BUS_ID"},
        "devices": [(p, p, "rw") for p in want_nodes],
        "cdi": [spec.qualified_name], "mounts": 0}


def test_publish_claim_quarantine_retract():
    def scenario(tw):
        store = tw.store.Store()
        pub = tw.publisher.DevicePublisher(store)
        pub.publish_group("worker-0", "grp-a", ["uuid-1", "uuid-2"], "tpu-v4")
        pub.publish_group("worker-0", "grp-b", ["uuid-3"], "tpu-v4")
        out = [sorted(d.uuid for d in pub.claimable("worker-0")),
               pub.devices_visible("worker-0", ["uuid-1", "uuid-2"])]
        pub.create_taints("worker-0", ["uuid-1", "uuid-2"], "detaching")
        out.append(sorted(d.uuid for d in pub.claimable("worker-0")))
        pub.retract_group("worker-0", "grp-a")
        pub.delete_taints(["uuid-1", "uuid-2"])
        out += [pub.devices_invisible("worker-0", ["uuid-1", "uuid-2"]),
                sorted(d.uuid for d in pub.claimable("worker-0"))]
        pub.retract_group("worker-0", "grp-b")
        out.append(store.try_get(tw.dra.ResourceSlice,
                                 tw.publisher.slice_object_name("worker-0")))
        return out

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out == [["uuid-1", "uuid-2", "uuid-3"], True, ["uuid-3"],
                        True, ["uuid-3"], None]


def test_attach_publishes_detach_retracts():
    def scenario(tw):
        t = tw.types
        store = tw.store.Store()
        for i in range(2):
            n = t.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 4
            store.create(n)
        pool = tw.inmem.InMemoryPool()
        mgr = tw.manager.Manager(store=store)
        mgr.add_controller(tw.req.ComposabilityRequestReconciler(
            store, pool, timing=tw.req.RequestTiming(
                updating_poll=0.05, cleaning_poll=0.05)))
        mgr.add_controller(tw.rc.ComposableResourceReconciler(
            store, pool, tw.fake.FakeNodeAgent(pool=pool),
            timing=tw.rc.ResourceTiming(
                attach_poll=0.05, visibility_poll=0.05, detach_poll=0.05,
                detach_fast=0.05, busy_poll=0.05)))
        mgr.start(workers_per_controller=2)
        try:
            pub = tw.publisher.DevicePublisher(store)
            store.create(t.ComposabilityRequest(
                metadata=tw.meta.ObjectMeta(name="r1"),
                spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
                    type="tpu", model="tpu-v4", size=8))))
            running = wait_for(lambda: store.get(
                t.ComposabilityRequest, "r1").status.state == "Running")
            slices = store.list(tw.dra.ResourceSlice)
            published = sum(len(s.spec.devices) for s in slices)
            claimable = all(
                {d.uuid for d in pub.claimable(s.spec.node_name)}
                == {d.uuid for d in s.spec.devices} for s in slices)
            store.delete(t.ComposabilityRequest, "r1")
            gone = wait_for(lambda: store.try_get(
                t.ComposabilityRequest, "r1") is None, 15)
            return [running, published, claimable, gone,
                    store.list(tw.dra.ResourceSlice),
                    store.list(tw.dra.DeviceTaintRule)]
        finally:
            mgr.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out == [True, 8, True, True, [], []]
