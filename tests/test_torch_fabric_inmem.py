"""The port's in-memory fabric pool (tpu_composer_torch/fabric/inmem.py)
against the JAX package's (tests/test_fabric_inmem.py's twin) for the TPU
rows and the loose gpu-compat path, plus the H100 row: its slice path,
and a ``cdi_device_id`` equal to the port's ``CdiSpec.qualified_name``.

Each scenario records attach results, error classes and messages, free
chip counts, the fabric listing and the pool's event stream; the two
packages' records must be equal. Masked: intent nonces.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_operator import PORT_ROOT, run_both, twin

torch.set_num_threads(1)


def _tpu(tw, name="r0", node="worker-0", slice_name="s1", worker_id=0, chips=4,
         topology="2x2x2"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(
            type="tpu", model="tpu-v4", target_node=node, chip_count=chips,
            slice_name=slice_name, worker_id=worker_id, topology=topology))


def _gpu(tw, name="g0", node="worker-0", model="gpu-a100"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="gpu", model=model, target_node=node))


def _h100(tw, name="h0", node="host-0", slice_name="hs", worker_id=0,
          chips=8, topology="8x2"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(
            type="gpu", model="nvidia-h100-sxm", target_node=node,
            chip_count=chips, slice_name=slice_name, worker_id=worker_id,
            topology=topology))


def _do(trace, fn, *args):
    try:
        out = fn(*args)
    except Exception as e:
        trace.append(("raised", type(e).__name__, str(e)))
        return None
    if hasattr(out, "device_ids"):
        trace.append(("attach", list(out.device_ids), out.cdi_device_id))
    elif hasattr(out, "healthy"):
        trace.append(("health", out.state, out.detail, out.healthy))
    else:
        trace.append(("ok", out))
    return out


def _listing(pool):
    return sorted((d.device_id, d.node, d.model, d.slice_name, d.type,
                   d.resource_name, d.health.state) for d in pool.get_resources())


def _events(pool):
    events, _ = pool.poll_events(0, timeout=0)
    return [e.to_wire() for e in events]


def slice_transactions(tw):
    pool, t = tw.inmem.InMemoryPool(), []
    _do(t, pool.reserve_slice, "s1", "tpu-v4", "2x2x2", ["worker-0", "worker-1"])
    t.append(("free", pool.free_chips("tpu-v4")))
    _do(t, pool.add_resource, _tpu(tw, "r0", "worker-0", worker_id=0))
    _do(t, pool.add_resource, _tpu(tw, "r1", "worker-1", worker_id=1))
    _do(t, pool.add_resource, _tpu(tw, "r2", "worker-1", worker_id=2))
    _do(t, pool.add_resource, _tpu(tw, "r3", "worker-1", worker_id=1, chips=2))
    _do(t, pool.add_resource, _tpu(tw, "r4", slice_name="ghost"))
    _do(t, pool.reserve_slice, "s1", "tpu-v4", "2x2x2", ["w9", "w8"])  # idempotent
    _do(t, pool.reserve_slice, "s2", "tpu-v4", "2x2x2", ["w0"])  # host count
    t.append(("listing", _listing(pool)))
    t.append(("attached", pool.attached_to("worker-1"), pool.has_slice("s1")))
    t.append(("record", pool.attachment_record("r0")))
    res = _tpu(tw, "r0", "worker-0", worker_id=0)
    res.status.device_ids = pool.add_resource(res).device_ids
    _do(t, pool.remove_resource, res)
    _do(t, pool.release_slice, "s1")
    t.append(("free", pool.free_chips("tpu-v4")))
    t.append(("events", _events(pool)))
    return t


def all_or_nothing(tw):
    pool, t = tw.inmem.InMemoryPool(chips={"tpu-v4": 7}), []
    _do(t, pool.reserve_slice, "s1", "tpu-v4", "2x2x2", ["w0", "w1"])
    t.append(("free", pool.free_chips("tpu-v4")))
    _do(t, pool.reserve_slice, "s1", "tpu-v4", "2x2x", ["w0"])  # malformed
    return t


def resize_and_repair(tw):
    pool, t = tw.inmem.InMemoryPool(), []
    pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["w0"])
    _do(t, pool.resize_slice, "s1", "tpu-v4", "2x2x2", ["w0", "w1"])
    t.append(("free", pool.free_chips("tpu-v4")))
    _do(t, pool.add_resource, _tpu(tw, "r1", "w1", worker_id=1))
    _do(t, pool.resize_slice, "s1", "tpu-v4", "2x2x1", ["w0"])  # w1 attached
    _do(t, pool.repair_slice_member, "s1", 0, "w7")
    _do(t, pool.repair_slice_member, "s1", 5, "w7")
    _do(t, pool.add_resource, _tpu(tw, "r0", "w7", worker_id=0))
    t.append(("free", pool.free_chips("tpu-v4")))
    return t


def async_attach(tw):
    pool, t = tw.inmem.InMemoryPool(async_steps=2), []
    pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["w0"])
    res = _tpu(tw, "r0", "w0", topology="2x2x1")
    for _ in range(4):
        _do(t, pool.add_resource, res)
    g = _gpu(tw)
    for _ in range(3):
        _do(t, pool.add_resource, g)
    for _ in range(4):
        _do(t, pool.remove_resource, g)
    t.append(("free", pool.free_chips("gpu-a100")))
    _do(t, pool.remove_resource, _gpu(tw, "never-attached"))
    t.append(("events", _events(pool)))
    return t


def gpu_compat(tw):
    pool, t = tw.inmem.InMemoryPool(), []
    _do(t, pool.add_resource, _gpu(tw))
    t.append(("free", pool.free_chips("gpu-a100")))
    _do(t, pool.remove_resource, _gpu(tw))
    t.append(("free", pool.free_chips("gpu-a100")))
    empty = tw.inmem.InMemoryPool(chips={"gpu-a100": 0})
    _do(t, empty.add_resource, _gpu(tw))
    _do(t, pool.add_resource, _gpu(tw, model="gpu-h999"))
    return t


def health_and_drift(tw):
    pool, t = tw.inmem.InMemoryPool(), []
    pool.reserve_slice("s1", "tpu-v4", "2x2x1", ["w0"])
    res = _tpu(tw, "r0", "w0")
    out = pool.add_resource(res)
    _do(t, pool.check_resource, res)
    pool.set_health(out.device_ids[2], tw.provider.DeviceHealth("Critical", "ICI link down"))
    _do(t, pool.check_resource, res)
    _do(t, pool.check_resource, _gpu(tw))
    leaked = pool.leak_attachment("worker-3", "tpu-v4")
    t.append(("listing", _listing(pool)))
    before = pool.free_chips("tpu-v4")
    detach = _tpu(tw, "detach-cr", "worker-3", slice_name="")
    detach.status.device_ids = [leaked]
    _do(t, pool.remove_resource, detach)
    t.append(("free", pool.free_chips("tpu-v4") - before))
    pool.kill_device(out.device_ids[0])
    pool.remove_resource(res)
    pool.release_slice("s1")
    t.append(("dead", pool.dead_chips("tpu-v4"), pool.free_chips("tpu-v4")))
    pool.revive_device(out.device_ids[0])
    t.append(("revived", pool.dead_chips("tpu-v4"), pool.free_chips("tpu-v4")))
    t.append(("events", _events(pool)))
    return t


def fault_injection(tw):
    pool, t = tw.inmem.InMemoryPool(), []
    pool.inject_add_failure("g0", times=1)
    _do(t, pool.add_resource, _gpu(tw))
    _do(t, pool.add_resource, _gpu(tw))
    pool.inject_remove_failure("g0", times=1)
    _do(t, pool.remove_resource, _gpu(tw))
    _do(t, pool.remove_resource, _gpu(tw))
    out = pool.add_resources([_gpu(tw, "a"), _gpu(tw, "b", model="nope")])
    t.append(("group", [type(o).__name__ for o in out]))
    return t


def adapter(tw):
    t = []
    tw.adapter.reset_shared_mock()
    a, b = tw.adapter.new_fabric_provider("MOCK"), tw.adapter.new_fabric_provider("mock")
    t.append(("shared", a is b, type(a).__name__))
    tw.adapter.reset_shared_mock()
    _do(t, tw.adapter.new_fabric_provider, "NVSWITCH")
    traced = tw.adapter.TracedFabricProvider(tw.inmem.InMemoryPool())
    _do(t, traced.add_resource, _gpu(tw))
    t.append(("traced", traced.free_chips("gpu-a100")))
    return t


SCENARIOS = [slice_transactions, all_or_nothing, resize_and_repair,
             async_attach, gpu_compat, health_and_drift, fault_injection,
             adapter]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_inmem_twin(scenario):
    jax_trace, port_trace = run_both(scenario)
    assert port_trace == jax_trace
    assert port_trace


PORT = twin(PORT_ROOT)


def test_h100_slice_members_carve_whole_hosts():
    pool = PORT.inmem.InMemoryPool()
    assert pool.free_chips("nvidia-h100-sxm") == 16
    pool.reserve_slice("hs", "nvidia-h100-sxm", "8x2", ["host-0", "host-1"])
    a = pool.add_resource(_h100(PORT, "h0", "host-0", worker_id=0))
    b = pool.add_resource(_h100(PORT, "h1", "host-1", worker_id=1))
    assert len(a.device_ids) == len(b.device_ids) == 8
    assert not set(a.device_ids) & set(b.device_ids)
    assert pool.free_chips("nvidia-h100-sxm") == 0
    # The slice path, not the loose one: a chip count the reservation does
    # not hold is refused, and an unreserved slice is refused.
    with pytest.raises(PORT.provider.FabricError, match="reservation has 8"):
        pool.add_resource(_h100(PORT, "h2", "host-1", worker_id=1, chips=4))
    with pytest.raises(PORT.provider.FabricError, match="not reserved"):
        pool.add_resource(_h100(PORT, "h3", slice_name="ghost"))
    devs = [d for d in pool.get_resources() if d.resource_name == "h0"]
    assert {(d.type, d.slice_name, d.node) for d in devs} == {("gpu", "hs", "host-0")}


@pytest.mark.parametrize("topology,hosts,worker", [("1x1", 1, 0), ("4x1", 1, 0),
                                                   ("8x2", 2, 1)])
def test_h100_cdi_device_id_is_the_specs_qualified_name(topology, hosts, worker):
    shape = PORT.slices.solve_slice("nvidia-h100-sxm",
                                    PORT.inmem._chips_in(topology), topology)
    pool = PORT.inmem.InMemoryPool()
    nodes = [f"host-{i}" for i in range(hosts)]
    pool.reserve_slice("cs", "nvidia-h100-sxm", topology, nodes)
    out = pool.add_resource(_h100(PORT, "m", nodes[worker], slice_name="cs",
                                  worker_id=worker, chips=shape.chips_per_host,
                                  topology=topology))
    spec = PORT.cdi.generate_cdi_spec(
        slice_name="cs", worker_id=worker,
        chip_indices=list(range(shape.chips_per_host)), model="nvidia-h100-sxm")
    assert out.cdi_device_id == spec.qualified_name == \
        f"tpu.composer.dev/gpu=cs-worker{worker}"


def test_h100_loose_group_and_events():
    pool = PORT.inmem.InMemoryPool()
    r = _h100(PORT, "loose", slice_name="", chips=2)
    out = pool.add_resource(r)
    assert len(out.device_ids) == 2
    assert out.cdi_device_id == f"tpu.composer.dev/device={out.device_ids[0]}"
    r.status.device_ids = list(out.device_ids)
    pool.remove_resource(r)
    assert pool.free_chips("nvidia-h100-sxm") == 16
    kinds = [(e["type"], e.get("verb", e.get("detail"))) for e in _events(pool)]
    assert kinds == [("op_completed", "add"), ("inventory", "attached"),
                     ("op_completed", "remove"), ("inventory", "detached")]


def test_remote_backends_are_not_ported(monkeypatch):
    """The remote backends are ported now (their twins are in
    tests/test_torch_fabric_remote.py); without ``FABRIC_ENDPOINT`` each
    one is refused as in the JAX package, never served by the mock
    pool."""
    monkeypatch.delenv("FABRIC_ENDPOINT", raising=False)
    for kind in ("REST_CM", "REST_FM", "LAYOUT", "REDFISH"):
        with pytest.raises(PORT.adapter.AdapterError,
                           match=f"{kind} requires FABRIC_ENDPOINT"):
            PORT.adapter.new_fabric_provider(kind)
