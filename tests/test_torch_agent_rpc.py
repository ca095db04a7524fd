"""The port's node-agent RPC seam (``agent/serve.py``'s ``AgentServer``,
``agent/remote.py``'s ``RemoteNodeAgent``) against the JAX package's
(tests/test_agent_rpc.py's twin): every NodeAgent method round-trips
over HTTP with its errors mapped (busy to ``DeviceBusyError``, the rest
and an unreachable or unregistered agent to ``AgentError``), the
resource controller attaches and detaches through the remote client, and
the ``/dev`` watch long-polls end to end into a watcher's nudge.

Each scenario runs once per package (``run_both``), client and server of
one package; the cross-package cases put one package's client in front
of the other's server, whose outcomes must equal the same-package ones.
The H100 cases (no JAX counterpart): a GPU group's CDI spec crosses the
wire whole (class and mounts) and lands on a fake NVIDIA host rebased
onto its minor, and a busy GPU names its holder's pid. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest
import torch

from tests.torch_operator import (
    JAX_ROOT,
    PORT_ROOT,
    nvidia_host,
    outcome,
    run_both,
    twin,
)

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


def _rpc(client_tw, server_tw, scenario):
    local = server_tw.fake.FakeNodeAgent()
    server = server_tw.serve.AgentServer(local)
    server.start()
    try:
        remote = client_tw.remote.RemoteNodeAgent(lambda node: server.address)
        return scenario(client_tw, local, remote)
    finally:
        server.stop()


def _sc_ensure_driver(tw, local, remote):
    out = [outcome(remote.ensure_driver, "n0")]
    local.set_no_driver("n0")
    out.append(outcome(remote.ensure_driver, "n0"))
    return out


def _sc_visibility_and_loads(tw, local, remote):
    local.set_visible("n0", ["c0", "c1"])
    out = [remote.check_visible("n0", ["c0", "c1"]),
           remote.check_visible("n0", ["c0", "ghost"])]
    local.add_load("n0", "c0")
    return out + [remote.check_no_loads("n0", ["c0"]),
                  remote.check_no_loads("n0", ["c1"])]


def _sc_drain_busy(tw, local, remote):
    local.set_visible("n0", ["c0"])
    local.add_load("n0", "c0")
    return [outcome(remote.drain, "n0", ["c0"]),
            outcome(remote.drain, "n0", ["c0"], force=True)]


def _sc_refresh_publishes_spec(tw, local, remote):
    spec = tw.cdi.generate_cdi_spec("s1", 0, [0, 1],
                                    env={"TPU_WORKER_ID": "0"})
    remote.refresh_device_stack("n0", spec=spec)
    got = local.published_spec("n0", "s1-worker0")
    out = [local.published("n0"), got.device_nodes, got.env,
           got.libtpu_host_path]
    remote.refresh_device_stack("n0", remove_name="s1-worker0")
    return out + [local.published("n0")]


def _sc_taints(tw, local, remote):
    remote.create_device_taint("n0", ["c0"], "detaching")
    out = [remote.has_device_taint("n0", "c0"),
           remote.has_device_taint("n0", "c1")]
    remote.delete_device_taint("n0", ["c0"])
    return out + [remote.has_device_taint("n0", "c0")]


def _sc_watch_answers_false(tw, local, remote):
    t0 = time.monotonic()
    out = [remote.wait_device_event("n0", timeout=0.1),
           remote.wait_device_event("n0", timeout=-5.0)]
    return out + [time.monotonic() - t0 < 3.0]


SCENARIOS = {
    "ensure_driver": (_sc_ensure_driver, [
        "host", ["raised", "AgentError", "n0 agent: no TPU runtime on n0"]]),
    "visibility_and_loads": (_sc_visibility_and_loads,
                             [True, False, False, True]),
    "drain_busy_maps_to_device_busy_error": (_sc_drain_busy, None),
    "refresh_device_stack_publishes_spec": (_sc_refresh_publishes_spec, None),
    "taints": (_sc_taints, [True, False, False]),
    "watch_answers_false_and_clamps": (_sc_watch_answers_false,
                                       [False, False, True]),
}
PAIRS = {"same": None, "port_client_jax_server": (PORT_ROOT, JAX_ROOT),
         "jax_client_port_server": (JAX_ROOT, PORT_ROOT)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_round_trip_matches_jax(case, pair):
    scenario, want = SCENARIOS[case]
    same = run_both(lambda tw: _rpc(tw, tw, scenario))
    assert same[0] == same[1]
    if PAIRS[pair] is not None:
        client, server = PAIRS[pair]
        crossed = run_both(lambda tw: _rpc(twin(client), twin(server),
                                           scenario))
        assert crossed[0] == crossed[1] == same[1]
    if want is not None:
        got = same[1]
        if case == "ensure_driver":
            assert got[0] == want[0] and got[1][:2] == want[1][:2]
        else:
            assert got == want
    if case == "drain_busy_maps_to_device_busy_error":
        assert same[1][0][:2] == ["raised", "DeviceBusyError"]
        assert same[1][1] is None


@pytest.mark.parametrize("case", ["unreachable", "unresolvable"])
def test_transport_failures_are_agent_errors(case):
    def scenario(tw):
        if case == "unreachable":
            remote = tw.remote.RemoteNodeAgent(lambda node: "127.0.0.1:9",
                                               timeout=0.5)
            return outcome(remote.check_visible, "n0", ["c0"])

        def resolver(node):
            raise tw.nodeagent.AgentError(
                f"node {node}: no agent endpoint registered")

        return outcome(tw.remote.RemoteNodeAgent(resolver).ensure_driver,
                       "nowhere")

    jax_out, port_out = run_both(scenario)
    assert jax_out[:2] == port_out[:2] == ["raised", "AgentError"]
    assert jax_out == port_out or case == "unreachable"  # errno text


def test_from_store_resolves_the_node_endpoint_then_the_template():
    def scenario(tw):
        store = tw.store.Store()
        node = tw.types.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
        node.spec.agent_endpoint = "10.0.0.5:9444"
        store.create(node)
        remote = tw.remote.RemoteNodeAgent.from_store(
            store, endpoint_template="{node}.agents:9444")
        bare = tw.remote.RemoteNodeAgent.from_store(store)
        return [remote._resolve("worker-0"), remote._resolve("worker-1"),
                outcome(bare._resolve, "worker-1")]

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out[:2] == ["10.0.0.5:9444", "worker-1.agents:9444"]
    assert port_out[2][1] == "AgentError"


def test_attach_detach_through_remote_agent():
    def scenario(tw):
        t = tw.types
        store = tw.store.Store()
        pool = tw.inmem.InMemoryPool()
        local = tw.fake.FakeNodeAgent(pool=pool)
        server = tw.serve.AgentServer(local)
        server.start()
        try:
            node = t.Node(metadata=tw.meta.ObjectMeta(name="worker-0"))
            node.spec.agent_endpoint = server.address
            node.status.tpu_slots = 8
            store.create(node)
            remote = tw.remote.RemoteNodeAgent.from_store(store)
            rec = tw.rc.ComposableResourceReconciler(
                store, pool, remote, timing=tw.rc.ResourceTiming())
            pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["worker-0"])
            store.create(t.ComposableResource(
                metadata=tw.meta.ObjectMeta(name="r0"),
                spec=t.ComposableResourceSpec(
                    type="tpu", model="tpu-v4", target_node="worker-0",
                    chip_count=4, slice_name="s1", worker_id=0,
                    topology="2x2x1")))
            rec.reconcile("r0")
            rec.reconcile("r0")
            states = [store.get(t.ComposableResource, "r0").status.state,
                      local.published("worker-0")]
            store.delete(t.ComposableResource, "r0")
            rec.reconcile("r0")
            rec.reconcile("r0")
            cr = store.try_get(t.ComposableResource, "r0")
            return states + [cr.status.state if cr else None,
                             pool.attached_to("worker-0"),
                             local.published("worker-0")]
        finally:
            server.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out[:2] == ["Online", ["s1-worker0"]]
    assert port_out[2] in (None, "Deleting") and port_out[3:] == [[], []]


@pytest.mark.parametrize("root", [JAX_ROOT, PORT_ROOT])
def test_local_agent_event_round_trips_into_a_nudge(tmp_path, root):
    tw = twin(root)
    dev = tmp_path / "dev"
    dev.mkdir()
    local = tw.nodeagent.LocalNodeAgent(
        dev_dir=str(dev), proc_dir=str(tmp_path / "proc"),
        cdi_dir=str(tmp_path / "cdi"), state_dir=str(tmp_path / "state"))
    server = tw.serve.AgentServer(local)
    server.start()
    try:
        remote = tw.remote.RemoteNodeAgent(lambda node: server.address)
        t = threading.Timer(0.15, lambda: (dev / "accel0").write_text(""))
        t.start()
        assert remote.wait_device_event("n0", timeout=3.0) is True
        t.join()

        class _Q:
            def __init__(self):
                self.added = []

            def add(self, k):
                self.added.append(k)

        class _C:
            def __init__(self):
                self.store = tw.store.Store()
                self.queue = _Q()

        ctrl = _C()
        ctrl.store.create(tw.types.ComposableResource(
            metadata=tw.meta.ObjectMeta(name="r0"),
            spec=tw.types.ComposableResourceSpec(
                type="tpu", model="tpu-v4", target_node="n0")))
        w = tw.watcher.DeviceEventWatcher(remote, ctrl, node_name="n0",
                                          wait_timeout=2.0)
        stop = threading.Event()
        wt = threading.Thread(target=w, args=(stop,))
        wt.start()
        time.sleep(0.2)
        (dev / "accel1").write_text("")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not ctrl.queue.added:
            time.sleep(0.05)
        stop.set()
        wt.join(timeout=10)
        assert ctrl.queue.added == ["r0"]
    finally:
        server.stop()


def test_tpu_spec_wire_body_is_the_jax_packages():
    jax_out, port_out = run_both(lambda tw: tw.serve.spec_to_wire(
        tw.cdi.generate_cdi_spec("s1", 0, [0, 1], env={"A": "1"})))
    assert jax_out == port_out
    assert sorted(port_out) == ["device_nodes", "env", "libtpu_host_path",
                                "name"]


def test_h100_spec_crosses_the_wire_and_lands_rebased(tmp_path):
    """A GPU group's spec sent by ``RemoteNodeAgent`` to a port agent over
    a fake NVIDIA host (minors 0 and 3): the CDI file names ``nvidia3``
    for ordinal 1, with the control nodes, the driver libraries and the
    env; the group enumerates; a holder of the GPU makes the remote drain
    raise ``DeviceBusyError`` naming its pid; the spec's removal retracts
    the file."""
    tw = twin(PORT_ROOT)
    kw = nvidia_host(str(tmp_path), minors=(0, 3), held={4242: [3]})
    local = tw.nodeagent.LocalNodeAgent(**kw)
    server = tw.serve.AgentServer(local)
    server.start()
    try:
        remote = tw.remote.RemoteNodeAgent(lambda node: server.address)
        spec = tw.cdi.generate_cdi_spec("h", 0, [1], env={"WORLD_SIZE": "1"},
                                        model=H100)
        wire = tw.serve.spec_to_wire(spec)
        assert tw.serve.spec_from_wire(json.loads(json.dumps(wire))) == spec
        remote.refresh_device_stack("localhost", spec=spec)
        with open(tw.cdi.spec_path(kw["cdi_dir"], spec)) as f:
            doc = json.load(f)
        edits = doc["devices"][0]["containerEdits"]
        assert [n["path"] for n in edits["deviceNodes"]] == [
            "/dev/nvidia3", *tw.cdi.NVIDIA_CONTROL_NODES]
        assert [m["hostPath"] for m in edits["mounts"]] == list(
            tw.cdi.NVIDIA_DRIVER_LIBS)
        assert edits["env"] == ["WORLD_SIZE=1"]
        assert doc["kind"] == "tpu.composer.dev/gpu"
        assert remote.check_visible("localhost", ["g0"], group="h-worker0")
        with pytest.raises(tw.nodeagent.DeviceBusyError, match="4242"):
            remote.drain("localhost", ["g0"], group="h-worker0")
        os.remove(os.path.join(kw["proc_dir"], "4242", "fd", "10"))
        remote.drain("localhost", ["g0"], group="h-worker0")
        remote.refresh_device_stack("localhost", remove_name="h-worker0")
        assert not os.path.exists(tw.cdi.spec_path(kw["cdi_dir"], spec))
    finally:
        server.stop()
