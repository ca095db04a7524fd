"""The port's remote fabric backends (tpu_composer_torch/fabric/{rest,
layout,redfish,poolapi,adapter}.py) against the JAX package's
(tests/test_fabric_remote.py's twin), plus the H100 over every wire.

TPU and loose-gpu rows: each scenario runs once per package against one
``tests/fake_fabric.FakeFabricServer`` (the wire is JSON, so the port's
clients talk to the same server as the reference's), reset to a fresh
pool and fresh server state between the two runs. A scenario records
every call's outcome (device ids, CDI ids, health, listings, error
classes and messages), the pool's free chips and the server's request
log; the two packages' records must be equal. Masked: intent nonces.
Tolerance: exact.

H100 rows (port only; the JAX pool takes the slice path only for
``type == "tpu"``): a request for ``nvidia-h100-sxm`` GPUs goes through
the port's scheduler and reconcilers composing over each of REST_CM,
REST_FM, LAYOUT and REDFISH (``new_fabric_provider``, behind the breaker,
with the token path on the wire) against ``tests/torch_fake_fabric``,
and its children's ``device_ids``, ``chip_indices``, ``cdi_device_id``,
states and published specs must equal those of the same request composed
on the port's ``InMemoryPool`` called directly.
"""

from __future__ import annotations

import time

import pytest
import torch

from tests.fake_fabric import FakeFabricServer
from tests.torch_fake_fabric import FakeFabricServer as PortFabricServer
from tests.torch_operator import (
    PORT_ROOT,
    RequestWorld,
    fabric_summary,
    reset_server,
    run_both,
    run_both_served,
    seeded_uuids,
    twin,
    wait_for,
)
from tpu_composer.fabric.inmem import InMemoryPool

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"
PORT = twin(PORT_ROOT)


@pytest.fixture(scope="module")
def server():
    srv = FakeFabricServer()
    yield srv
    srv.close()


def res(tw, name="res-0", node="worker-0", model="tpu-v4", count=1,
        slice_name="", worker_id=0, device_ids=None, type_="tpu"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(
            type=type_, model=model, target_node=node, chip_count=count,
            slice_name=slice_name, worker_id=worker_id),
        status=t.ComposableResourceStatus(device_ids=device_ids or []))


def do(trace, fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        trace.append(("raised", type(e).__name__, str(e)))
        return None
    trace.append(fabric_summary(out))
    return out


def rest(tw, srv, **kw):
    return tw.rest.RestPoolClient(srv.url, token_cache=None, **kw)


def layout(tw, srv, attempts=6):
    return tw.layout.LayoutApplyClient(srv.url, token_cache=None,
                                       poll_interval=0.01,
                                       poll_attempts=attempts)


def redfish(tw, srv):
    return tw.redfish.RedfishClient(srv.url, token_cache=None)


# -- RestPoolClient ---------------------------------------------------------------

def rest_attach_detach_roundtrip(tw, srv):
    c, t, r = rest(tw, srv), [], res(tw)
    out = do(t, c.add_resource, r)
    t.append(srv.pool.attached_to("worker-0"))
    do(t, c.add_resource, r)
    r.status.device_ids = out.device_ids
    do(t, c.remove_resource, r)
    t.append(srv.pool.attached_to("worker-0"))
    do(t, c.remove_resource, r)
    return t


def rest_async_attach_raises_wait_sentinel(tw, srv):
    c, t, r = rest(tw, srv), [], res(tw)
    for _ in range(3):
        do(t, c.add_resource, r)
    return t


def rest_synchronous_mode_completes_inline(tw, srv):
    t = []
    do(t, rest(tw, srv, synchronous=True).add_resource, res(tw))
    return t + [srv.request_log]


def rest_group_verbs_per_member_outcomes(tw, srv):
    c, t = rest(tw, srv), []
    srv.pool.inject_add_failure("b1", times=1)
    rs = [res(tw, name=f"b{i}") for i in range(3)]
    outs = do(t, c.add_resources, rs)
    t.append(list(srv.request_log))
    for r, out in zip(rs, outs):
        if not isinstance(out, Exception):
            r.status.device_ids = out.device_ids
    do(t, c.remove_resources, [rs[0], rs[2]])
    t.append(srv.pool.attached_to("worker-0"))
    return t


def rest_group_async_members_wait(tw, srv):
    c, t = rest(tw, srv), []
    for _ in range(3):
        do(t, c.add_resources, [res(tw, name="a0")])
    return t


def rest_batch_route_faults(tw, srv):
    c, t = rest(tw, srv), []
    srv.fail_next("POST", "/v1/attachments:batch", code=404)
    do(t, c.add_resources, [res(tw, name="x0")])
    srv.fail_next("POST", "/v1/attachments:batch", code=503)
    do(t, c.add_resources, [res(tw, name="x0")])
    return t


def rest_pool_exhausted_is_terminal(tw, srv):
    t = []
    do(t, rest(tw, srv).add_resource, res(tw, model="tpu-v5e", count=64))
    return t


def rest_health_and_get_resources(tw, srv):
    c, t, r = rest(tw, srv), [], res(tw)
    out = do(t, c.add_resource, r)
    do(t, c.check_resource, r)
    srv.pool.set_health(out.device_ids[0],
                        tw.provider.DeviceHealth("Critical", "ECC"))
    do(t, c.check_resource, r)
    do(t, c.get_resources)
    do(t, c.check_resource, res(tw, name="ghost"))
    srv.pool.set_health(out.device_ids[0],
                        tw.provider.DeviceHealth("Degraded", "odd"))
    do(t, c.check_resource, r)
    return t


def rest_slice_reserve_attach_release(tw, srv):
    c, t = rest(tw, srv), []
    nodes = ["worker-0", "worker-1"]
    do(t, c.reserve_slice, "s0", "tpu-v4", "2x2x2", nodes)
    for w, node in enumerate(nodes):
        do(t, c.add_resource, res(tw, name=f"s0-w{w}", node=node, count=4,
                                  slice_name="s0", worker_id=w))
    do(t, c.reserve_slice, "s0", "tpu-v4", "2x2x2", nodes)
    do(t, c.resize_slice, "s0", "tpu-v4", "2x2x1", ["worker-0"])
    do(t, c.release_slice, "s0")
    return t + [srv.pool.free_chips("tpu-v4")]


def release_unknown_slice_is_idempotent(tw, srv):
    t = []
    for client in (rest(tw, srv), layout(tw, srv), redfish(tw, srv)):
        do(t, client.release_slice, "never-existed")
    return t + [srv.request_log]


def rest_detach_orphan_by_device_id(tw, srv):
    leaked = srv.pool.leak_attachment("worker-3", "tpu-v4")
    free = srv.pool.free_chips("tpu-v4")
    t = []
    do(t, rest(tw, srv).remove_resource,
       res(tw, name="detach-cr", device_ids=[leaked]))
    return t + [srv.pool.free_chips("tpu-v4") - free]


def rest_api_error_and_tenant_prefix(tw, srv):
    t = []
    srv.fail_next("PUT", "/v1/attachments", 500)
    do(t, rest(tw, srv).add_resource, res(tw))
    do(t, rest(tw, srv, tenant_id="t0", cluster_id="c0").add_resource,
       res(tw, name="tenant-0"))
    return t + [srv.request_log]


def rest_bearer_auth_and_401_retry(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    c, t = tw.rest.RestPoolClient(srv.url, token_cache=cache), []
    do(t, c.add_resource, res(tw, name="auth-0"))
    srv.revoke_tokens()
    do(t, c.add_resource, res(tw, name="auth-1"))
    do(t, rest(tw, srv).add_resource, res(tw, name="anon"))
    return t + [srv.token_requests]


def rest_event_stream(tw, srv):
    c, t = rest(tw, srv), []
    _, cursor = c.poll_events(-1, timeout=0.0)
    r = res(tw, name="ev")
    r.status.pending_op = tw.types.PendingOp(verb="add", nonce="n-ev")
    do(t, c.add_resource, r)
    events, cursor = c.poll_events(cursor, timeout=0.0)
    t.append([e.to_wire() for e in events])
    srv.fail_next("GET", "/v1/events", code=404)
    do(t, c.poll_events, cursor, 0.0)
    return t


# -- LayoutApplyClient ------------------------------------------------------------

def layout_connect_completes_within_budget(tw, srv):
    srv.apply_steps = 3
    c, t = layout(tw, srv), []
    do(t, c.add_resource, res(tw))
    n = len(srv.request_log)
    do(t, c.add_resource, res(tw))
    return t + [srv.request_log[n:], srv.pool.attached_to("worker-0")]


def layout_poll_budget_and_busy_fabric(tw, srv):
    srv.apply_steps = 100
    c, t = layout(tw, srv, attempts=2), []
    do(t, c.add_resource, res(tw, name="a"))
    do(t, c.add_resource, res(tw, name="b"))  # 409 APPLY_IN_PROGRESS
    return t


def layout_failed_apply_is_terminal(tw, srv):
    t = []
    do(t, layout(tw, srv).add_resource, res(tw, model="no-such-model"))
    return t


def layout_disconnect_and_health(tw, srv):
    c, t, r = layout(tw, srv), [], res(tw)
    out = do(t, c.add_resource, r)
    do(t, c.check_resource, r)
    do(t, c.get_resources)
    r.status.device_ids = out.device_ids
    do(t, c.remove_resource, r)
    do(t, c.remove_resource, res(tw, name="ghost"))
    return t + [srv.pool.attached_to("worker-0"), srv.request_log]


# -- RedfishClient ----------------------------------------------------------------

def redfish_compose_decompose(tw, srv):
    c, t, r = redfish(tw, srv), [], res(tw, count=2)
    out = do(t, c.add_resource, r)
    do(t, c.add_resource, r)
    do(t, c.check_resource, r)
    do(t, c.get_resources)
    srv.pool.set_health(out.device_ids[1],
                        tw.provider.DeviceHealth("Warning", "thermal"))
    do(t, c.check_resource, r)
    r.status.device_ids = out.device_ids
    do(t, c.remove_resource, r)
    do(t, c.get_resources)
    do(t, c.check_resource, r)
    return t


def redfish_colocated_groups_and_batch(tw, srv):
    c, t = redfish(tw, srv), []
    a, b = res(tw, name="blk-a", count=2), res(tw, name="blk-b", count=2)
    do(t, c.add_resource, a)
    do(t, c.add_resource, b)
    do(t, c.add_resource, a)
    srv.pool.inject_add_failure("m1", times=1)
    ms = [res(tw, name=f"m{i}") for i in range(3)]
    outs = do(t, c.add_resources, ms)
    for r, out in zip(ms, outs):
        if not isinstance(out, Exception):
            r.status.device_ids = out.device_ids
    do(t, c.remove_resources, ms)
    return t


def redfish_exhaustion_and_zones(tw, srv):
    c, t = redfish(tw, srv), []
    do(t, c.add_resource, res(tw, model="gpu-a100", count=99))
    do(t, c.reserve_slice, "z0", "tpu-v4", "1x2x2", ["worker-0"])
    do(t, c.add_resource, res(tw, name="z0-w0", count=4, slice_name="z0"))
    do(t, c.release_slice, "z0")
    return t + [srv.pool.free_chips("tpu-v4")]


# -- adapter factory ----------------------------------------------------------------

def adapter_factory(tw, srv, monkeypatch):
    monkeypatch.setenv("FABRIC_ENDPOINT", srv.url)
    monkeypatch.delenv("FABRIC_AUTH_URL", raising=False)
    monkeypatch.delenv("TPU_COMPOSER_BREAKER", raising=False)
    t = []
    for kind in ("REST_CM", "REST_FM", "LAYOUT", "REDFISH"):
        p = tw.adapter.new_fabric_provider(kind)
        inner = p._inner
        t.append((type(p).__name__, type(inner).__name__,
                  getattr(inner, "synchronous", None), p.endpoint))
        do(t, p.add_resource, res(tw, name=f"factory-{kind.lower()}"))
    monkeypatch.setenv("TPU_COMPOSER_BREAKER", "0")
    t.append(type(tw.adapter.new_fabric_provider("REST_CM")).__name__)
    monkeypatch.setenv("TPU_COMPOSER_BREAKER", "1")
    monkeypatch.setenv("TPU_COMPOSER_BREAKER_THRESHOLD", "x")
    do(t, tw.adapter.new_fabric_provider, "REST_CM")
    monkeypatch.delenv("TPU_COMPOSER_BREAKER_THRESHOLD")
    monkeypatch.delenv("FABRIC_ENDPOINT")
    do(t, tw.adapter.new_fabric_provider, "REST_CM")
    do(t, tw.adapter.new_fabric_provider, "NOPE")
    return t


SERVED = {
    # name: (scenario, pool keyword arguments, server knobs)
    "rest_attach_detach_roundtrip": (rest_attach_detach_roundtrip, {}, {}),
    "rest_async_attach_raises_wait_sentinel": (
        rest_async_attach_raises_wait_sentinel, {"async_steps": 2}, {}),
    "rest_synchronous_mode_completes_inline": (
        rest_synchronous_mode_completes_inline, {"async_steps": 3}, {}),
    "rest_group_verbs_per_member_outcomes": (
        rest_group_verbs_per_member_outcomes, {}, {}),
    "rest_group_async_members_wait": (
        rest_group_async_members_wait, {"async_steps": 2}, {}),
    "rest_batch_route_faults": (rest_batch_route_faults, {}, {}),
    "rest_pool_exhausted_is_terminal": (rest_pool_exhausted_is_terminal, {}, {}),
    "rest_health_and_get_resources": (rest_health_and_get_resources, {}, {}),
    "rest_slice_reserve_attach_release": (
        rest_slice_reserve_attach_release, {}, {}),
    "release_unknown_slice_is_idempotent": (
        release_unknown_slice_is_idempotent, {}, {}),
    "rest_detach_orphan_by_device_id": (rest_detach_orphan_by_device_id, {}, {}),
    "rest_api_error_and_tenant_prefix": (
        rest_api_error_and_tenant_prefix, {}, {}),
    "rest_bearer_auth_and_401_retry": (
        rest_bearer_auth_and_401_retry, {}, {"require_auth": True}),
    "rest_event_stream": (rest_event_stream, {}, {}),
    "layout_connect_completes_within_budget": (
        layout_connect_completes_within_budget, {}, {}),
    "layout_poll_budget_and_busy_fabric": (
        layout_poll_budget_and_busy_fabric, {}, {}),
    "layout_failed_apply_is_terminal": (layout_failed_apply_is_terminal, {}, {}),
    "layout_disconnect_and_health": (layout_disconnect_and_health, {}, {}),
    "redfish_compose_decompose": (redfish_compose_decompose, {}, {}),
    "redfish_colocated_groups_and_batch": (
        redfish_colocated_groups_and_batch, {}, {}),
    "redfish_exhaustion_and_zones": (redfish_exhaustion_and_zones, {}, {}),
}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_backend_matches_jax(name, server):
    scenario, pool_kw, knobs = SERVED[name]
    jax, port = run_both_served(scenario, server,
                                lambda: InMemoryPool(**pool_kw), knobs=knobs)
    assert jax == port


def test_adapter_factory_matches_jax(server, monkeypatch):
    jax, port = run_both_served(adapter_factory, server, InMemoryPool,
                                monkeypatch)
    assert jax == port
    assert [row[:3] for row in jax[0:8:2]] == [
        ["BreakerFabricProvider", "RestPoolClient", False],
        ["BreakerFabricProvider", "RestPoolClient", True],
        ["BreakerFabricProvider", "LayoutApplyClient", None],
        ["BreakerFabricProvider", "RedfishClient", None]]
    assert jax[8] == "RestPoolClient"
    assert [row[1] for row in jax[9:]] == ["AdapterError"] * 3


# -- resize_slice's 404 fallback (poolapi) ---------------------------------------------

class _ScriptedHttp:
    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def request(self, method, path, body=None):
        self.calls.append((method, path))
        step = self.script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step


def resize_disambiguation(tw):
    err = tw.httpx.HttpStatusError
    scripts = [
        [err(404, "no PATCH route"), err(409, "slice exists")],
        [err(404, "unknown"), err(503, "pool manager restarting")],
        [err(404, "unknown"), tw.provider.FabricError("connection reset")],
        [err(404, "unknown"), (201, {})],
        [err(405, "no PATCH")],
        [(200, {})],
    ]
    t = []
    for script in scripts:
        c = tw.poolapi.PoolApiMixin()
        c._http = _ScriptedHttp(script)
        do(t, c.resize_slice, "s", "tpu-v4", "2x2", ["worker-0"])
        t.append(c._http.calls)
    return t


def test_resize_disambiguation_matches_jax():
    jax, port = run_both(resize_disambiguation)
    assert jax == port
    assert [row and row[1] for row in jax[0:12:2]] == [
        "UnsupportedResize", "FabricError", "FabricError", None,
        "UnsupportedResize", None]


# -- the whole request side over HTTP ---------------------------------------------------

def operator_over_rest(tw, srv):
    cache = tw.token.TokenCache(srv.token_url, "composer", "secret")
    client = tw.rest.RestPoolClient(srv.url, token_cache=cache)
    t = tw.types
    store = tw.store.Store()
    for i in range(4):
        n = t.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
        n.status.tpu_slots = 4
        store.create(n)
    mgr = tw.manager.Manager(store=store)
    mgr.add_controller(tw.req.ComposabilityRequestReconciler(
        store, client,
        timing=tw.req.RequestTiming(updating_poll=0.05, cleaning_poll=0.05)))
    mgr.add_controller(tw.rc.ComposableResourceReconciler(
        store, client, tw.fake.FakeNodeAgent(pool=srv.pool),
        timing=tw.rc.ResourceTiming(attach_poll=0.05, visibility_poll=0.05,
                                    detach_poll=0.05, detach_fast=0.05,
                                    busy_poll=0.05)))
    mgr.add_runnable(tw.syncer.UpstreamSyncer(store, client, period=0.1,
                                              grace=0.5))
    mgr.start(workers_per_controller=2)
    try:
        store.create(t.ComposabilityRequest(
            metadata=tw.meta.ObjectMeta(name="req-http"),
            spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
                type="tpu", model="tpu-v4", size=4))))
        running = wait_for(lambda: store.get(
            t.ComposabilityRequest, "req-http").status.state == "Running",
            timeout=20.0)
        live = store.get(t.ComposabilityRequest, "req-http")
        out = [running, live.status.slice.topology,
               sorted(len(r.device_ids) for r in live.status.resources.values()),
               srv.pool.free_chips("tpu-v4")]
        store.delete(t.ComposabilityRequest, "req-http")
        out.append(wait_for(lambda: store.try_get(
            t.ComposabilityRequest, "req-http") is None, timeout=20.0))
        out.append(wait_for(lambda: srv.pool.free_chips("tpu-v4") == 64,
                            timeout=20.0))
        out.append(srv.token_requests)
        return out
    finally:
        mgr.stop()


def test_operator_over_rest_matches_jax(server):
    jax, port = run_both_served(operator_over_rest, server, InMemoryPool,
                                knobs={"require_auth": True})
    assert jax == port
    assert jax == [True, "1x2x2", [4], 60, True, True, 1]


# -- the H100 over every wire (port only) --------------------------------------------

BACKENDS = ("REST_CM", "REST_FM", "LAYOUT", "REDFISH")
H100_CHIPS = {H100: 32, "gpu-a100": 8}


@pytest.fixture(scope="module")
def port_server():
    srv = PortFabricServer()
    yield srv
    srv.close()


def _h100_world(pool, fabric=None):
    return RequestWorld(PORT, n_nodes=3, slots=8, pool=pool, fabric=fabric)


def _h100_record(w, name):
    """The request's view, each child's CDI id and published spec."""
    kids = sorted(w.children(name), key=lambda c: c.spec.worker_id)
    specs = []
    for c in kids:
        spec = w.agent.published_spec(c.spec.target_node,
                                      f"{c.spec.slice_name}-worker{c.spec.worker_id}")
        specs.append(None if spec is None else (spec.qualified_name,
                                                spec.to_dict()))
    return dict(view=w.view(),
                cdi=[(c.metadata.name, c.status.cdi_device_id) for c in kids],
                specs=specs)


def _compose_h100(w, size):
    w.request("job", size=size, model=H100)
    w.run_to_ready("job")
    return _h100_record(w, "job")


@pytest.mark.parametrize("size", [1, 8, 16])
@pytest.mark.parametrize("kind", BACKENDS)
def test_h100_over_the_wire_equals_the_pool(kind, size, port_server,
                                            monkeypatch):
    with seeded_uuids():
        direct = _compose_h100(
            _h100_world(PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS))), size)
    pool = PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS))
    reset_server(port_server, pool, require_auth=True)
    monkeypatch.setenv("FABRIC_ENDPOINT", port_server.url)
    monkeypatch.setenv("FABRIC_AUTH_URL", port_server.token_url)
    monkeypatch.setenv("FABRIC_USERNAME", "composer")
    monkeypatch.setenv("FABRIC_PASSWORD", "secret")
    monkeypatch.delenv("TPU_COMPOSER_BREAKER", raising=False)
    fabric = PORT.adapter.new_fabric_provider(kind)
    assert isinstance(fabric, PORT.breaker.BreakerFabricProvider)
    with seeded_uuids():
        wired = _compose_h100(_h100_world(pool, fabric), size)
    assert wired == direct
    kids = direct["view"]["children"]
    assert len(kids) == max(1, size // 8)
    for name, cdi in direct["cdi"]:
        kid = kids[name]
        assert cdi == (f"tpu.composer.dev/gpu={kid['spec']['slice_name']}"
                       f"-worker{kid['spec']['worker_id']}")
        assert len(kid["device_ids"]) == min(size, 8)
    assert [s[0] for s in direct["specs"]] == [c for _, c in direct["cdi"]]
    assert port_server.token_requests == 1  # the token path was on the wire
    assert any(line.startswith(("PUT /v1/attachments", "POST /v1/layout-apply",
                                "PATCH /redfish/v1/Systems"))
               for line in port_server.request_log)


@pytest.mark.parametrize("kind", BACKENDS)
def test_h100_group_attach_over_the_wire(kind, port_server, monkeypatch):
    """One slice member of 8 H100s attached by the client alone: the
    device ids and CDI id equal the pool's direct answer."""
    def member(tw):
        return res(tw, name="hs-w0", node="host-0", model=H100, count=8,
                   slice_name="hs", type_="gpu")

    direct_pool = PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS))
    direct_pool.reserve_slice("hs", H100, "8x1", ["host-0"])
    want = direct_pool.add_resource(member(PORT))
    reset_server(port_server, PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS)))
    monkeypatch.setenv("FABRIC_ENDPOINT", port_server.url)
    monkeypatch.delenv("FABRIC_AUTH_URL", raising=False)
    client = PORT.adapter.new_fabric_provider(kind)
    client.reserve_slice("hs", H100, "8x1", ["host-0"])
    deadline = time.monotonic() + 5
    while True:
        try:
            got = client.add_resource(member(PORT))
            break
        except PORT.provider.WaitingDeviceAttaching:
            assert time.monotonic() < deadline
    assert (got.device_ids, got.cdi_device_id) == (
        want.device_ids, want.cdi_device_id)
    assert want.cdi_device_id == "tpu.composer.dev/gpu=hs-worker0"
