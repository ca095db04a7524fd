"""The provider conformance contract on the port's backends
(tests/test_fabric_conformance.py's twin): the same lifecycle across the
in-memory pool (sync and fabric-async), every remote client (REST CM and
FM, layout-apply, Redfish) and the chaos provider wrapped round them.

Each (backend, contract case) pair runs once per package; remote rows
talk to one ``tests/fake_fabric.FakeFabricServer`` reset to a fresh pool
between the two runs. A case records every call's outcome (device ids,
CDI ids, health, listings with owners, error classes and messages), the
pool's free chips and the event stream; the two packages' records must
be equal. Only the pairs whose capability the backend has (or, for the
probe cases, lacks) are generated. Tolerance: exact.

The H100 rows (port only) run the lifecycle for a loose group of
``nvidia-h100-sxm`` GPUs over each remote client against
``tests/torch_fake_fabric`` and hold it to the port's pool called
directly.
"""

from __future__ import annotations

import time

import pytest
import torch

from tests.fake_fabric import FakeFabricServer
from tests.torch_fake_fabric import FakeFabricServer as PortFabricServer
from tests.torch_operator import (
    PORT_ROOT,
    fabric_summary,
    reset_server,
    run_both,
    run_both_served,
    twin,
)
from tpu_composer.fabric.inmem import InMemoryPool

torch.set_num_threads(1)

CHIPS = {"gpu-a100": 8, "tpu-v4": 16}
PORT = twin(PORT_ROOT)


def _inmem(tw, srv, **kw):
    pool = tw.inmem.InMemoryPool(chips=dict(CHIPS), **kw)
    return pool, pool


def _remote(cls):
    def make(tw, srv):
        return getattr(tw, cls[0]).__dict__[cls[1]](
            endpoint=srv.url, token_cache=None, **cls[2]), srv.pool
    return make


def _chaos(make):
    def wrapped(tw, srv):
        provider, pool = make(tw, srv)
        return tw.chaos.ChaosFabricProvider(provider), pool
    return wrapped


_REST = _remote(("rest", "RestPoolClient", {}))
_REST_FM = _remote(("rest", "RestPoolClient", {"synchronous": True}))
_REDFISH = _remote(("redfish", "RedfishClient", {}))
_LAYOUT = _remote(("layout", "LayoutApplyClient", {"poll_interval": 0.01}))

#: name -> (factory(tw, srv) -> (provider, pool), remote?, capabilities)
BACKENDS = {
    "inmem": (_inmem, False, {"batch", "events", "repair", "owner_listing"}),
    "inmem-async": (lambda tw, srv: _inmem(tw, srv, async_steps=2), False,
                    {"batch", "events", "repair", "owner_listing", "async"}),
    "inmem-chaos": (_chaos(_inmem), False,
                    {"batch", "events", "repair", "owner_listing"}),
    "rest": (_REST, True, {"batch", "events", "owner_listing"}),
    "rest-fm": (_REST_FM, True, {"batch", "events", "owner_listing"}),
    "rest-chaos": (_chaos(_REST), True, {"batch", "events", "owner_listing"}),
    "layout": (_LAYOUT, True, {"owner_listing"}),
    "redfish": (_REDFISH, True, {"batch", "owner_listing"}),
    "redfish-chaos": (_chaos(_REDFISH), True, {"batch", "owner_listing"}),
}


def make_resource(tw, name, node="node-0", model="gpu-a100", nonce="",
                  device_ids=None, count=1):
    t = tw.types
    status = t.ComposableResourceStatus(device_ids=list(device_ids or []))
    if nonce:
        status.pending_op = t.PendingOp(verb="add", nonce=nonce)
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="gpu", model=model,
                                      target_node=node, chip_count=count),
        status=status)


def drive(tw, fn, deadline_s=10.0):
    """Run one fabric op to a terminal outcome, absorbing wait sentinels;
    returns (outcome, sentinels absorbed)."""
    waits = (tw.provider.WaitingDeviceAttaching,
             tw.provider.WaitingDeviceDetaching)
    deadline, n = time.monotonic() + deadline_s, 0
    while True:
        try:
            return fn(), n
        except waits:
            n += 1
            assert time.monotonic() < deadline
            time.sleep(0.002)
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            return e, n


def drive_batch(tw, batch_fn, resources, deadline_s=10.0):
    waits = (tw.provider.WaitingDeviceAttaching,
             tw.provider.WaitingDeviceDetaching)
    terminal = {}
    deadline = time.monotonic() + deadline_s
    while len(terminal) < len(resources):
        pending = [r for r in resources if r.metadata.name not in terminal]
        for r, out in zip(pending, batch_fn(pending)):
            if not isinstance(out, waits):
                terminal[r.metadata.name] = out
        assert time.monotonic() < deadline
    return [terminal[r.metadata.name] for r in resources]


def listed(p, ids):
    return sorted(fabric_summary([d for d in p.get_resources() if d.device_id in ids]))


# -- the contract ---------------------------------------------------------------------

def attach_detach_roundtrip(tw, p, pool):
    free0 = pool.free_chips("gpu-a100")
    r = make_resource(tw, "conf-rt", nonce="n-rt")
    result, waits = drive(tw, lambda: p.add_resource(r))
    again, _ = drive(tw, lambda: p.add_resource(r))
    t = [fabric_summary(result), waits, fabric_summary(again),
         free0 - pool.free_chips("gpu-a100"), listed(p, set(result.device_ids))]
    r.status.device_ids = list(result.device_ids)
    t.append(fabric_summary(drive(tw, lambda: p.remove_resource(r))[0]))
    t += [pool.free_chips("gpu-a100") - free0,
          listed(p, set(result.device_ids))]
    return t


def detach_unknown_is_idempotent_noop(tw, p, pool):
    return [fabric_summary(drive(tw, lambda: p.remove_resource(
        make_resource(tw, "conf-ghost")))[0])]


def detach_then_reattach(tw, p, pool):
    r = make_resource(tw, "conf-cycle")
    first, _ = drive(tw, lambda: p.add_resource(r))
    r.status.device_ids = list(first.device_ids)
    drive(tw, lambda: p.remove_resource(r))
    r2 = make_resource(tw, "conf-cycle")
    second, _ = drive(tw, lambda: p.add_resource(r2))
    return [fabric_summary(first), fabric_summary(second), fabric_summary(p.check_resource(r2))]


def async_wait_sentinel_progress(tw, p, pool):
    r = make_resource(tw, "conf-async")
    try:
        p.add_resource(r)
        first = "completed"
    except tw.provider.WaitingDeviceAttaching as e:
        first = ("waiting", str(e))
    result, waits = drive(tw, lambda: p.add_resource(r))
    return [first, fabric_summary(result), waits]


def batch_outcomes_stay_aligned_and_isolated(tw, p, pool):
    rs = [make_resource(tw, f"conf-b{i}", nonce=f"n-b{i}") for i in range(3)]
    pool.inject_add_failure("conf-b1", times=1)
    outcomes = drive_batch(tw, p.add_resources, rs)
    for r, out in zip(rs, outcomes):
        if not isinstance(out, Exception):
            r.status.device_ids = list(out.device_ids)
    removed = drive_batch(tw, p.remove_resources, rs)
    return [fabric_summary(outcomes), removed, pool.free_chips("gpu-a100")]


def unsupported_batch_is_a_probe_not_a_crash(tw, p, pool):
    rs = [make_resource(tw, f"conf-ub{i}") for i in range(2)]
    try:
        p.add_resources(rs)
        probe = "no probe"
    except tw.provider.UnsupportedBatch as e:
        probe = ("UnsupportedBatch", str(e))
    return [probe] + [fabric_summary(drive(tw, lambda r=r: p.add_resource(r))[0])
                      for r in rs]


def health_state_mapping(tw, p, pool):
    r = make_resource(tw, "conf-health")
    result, _ = drive(tw, lambda: p.add_resource(r))
    r.status.device_ids = list(result.device_ids)
    t = [fabric_summary(p.check_resource(r))]
    for state in ("Warning", "Critical", "Funky"):
        pool.set_health(result.device_ids[0],
                        tw.provider.DeviceHealth(state, state.lower()))
        t.append(fabric_summary(p.check_resource(r)))
    t.append(fabric_summary(p.check_resource(make_resource(tw, "conf-nowhere"))))
    return t


def owner_attribution(tw, p, pool):
    r = make_resource(tw, "conf-owner")
    result, _ = drive(tw, lambda: p.add_resource(r))
    return [listed(p, set(result.device_ids))]


def unsupported_repair_is_a_probe(tw, p, pool):
    try:
        p.repair_slice_member("conf-slice", 0, "node-0")
        return ["repaired"]
    except tw.provider.UnsupportedRepair as e:
        return [("UnsupportedRepair", str(e))]


def repair_recarves_one_worker(tw, p, pool):
    p.reserve_slice("conf-rs", "tpu-v4", "2x2x2", ["node-0", "node-1"])
    before = dict(pool._slices["conf-rs"].groups)
    p.repair_slice_member("conf-rs", 1, "node-2")
    after = dict(pool._slices["conf-rs"].groups)
    p.release_slice("conf-rs")
    return [before, after, after[0] == before[0], after[1] != before[1]]


def event_poll_completion_parity(tw, p, pool):
    _, cursor = p.poll_events(-1, timeout=0.0)
    r = make_resource(tw, "conf-ev", nonce="n-ev-add")
    result, _ = drive(tw, lambda: p.add_resource(r))
    r.status.device_ids = list(result.device_ids)
    r.status.pending_op = tw.types.PendingOp(verb="remove", nonce="n-ev-rm")
    drive(tw, lambda: p.remove_resource(r))
    seen, deadline = [], time.monotonic() + 5
    while time.monotonic() < deadline:
        events, cursor = p.poll_events(cursor, timeout=0.2)
        seen.extend(events)
        if any(e.type == "op_completed" and e.verb == "remove" for e in seen):
            break
    return [fabric_summary(result), [e.to_wire() for e in seen]]


def events_tail_start_skips_backlog(tw, p, pool):
    drive(tw, lambda: p.add_resource(make_resource(tw, "conf-backlog")))
    events, cursor = p.poll_events(-1, timeout=0.0)
    return [events, cursor]


def unsupported_events_is_a_probe(tw, p, pool):
    try:
        p.poll_events(-1, timeout=0.0)
        return ["streamed"]
    except tw.provider.UnsupportedEvents as e:
        return [("UnsupportedEvents", str(e))]


#: case -> (capability, True: the backend must have it / False: lack it)
CASES = {
    attach_detach_roundtrip: None,
    detach_unknown_is_idempotent_noop: None,
    detach_then_reattach: None,
    health_state_mapping: None,
    async_wait_sentinel_progress: ("async", True),
    batch_outcomes_stay_aligned_and_isolated: ("batch", True),
    unsupported_batch_is_a_probe_not_a_crash: ("batch", False),
    owner_attribution: ("owner_listing", True),
    unsupported_repair_is_a_probe: ("repair", False),
    repair_recarves_one_worker: ("repair", True),
    event_poll_completion_parity: ("events", True),
    events_tail_start_skips_backlog: ("events", True),
    unsupported_events_is_a_probe: ("events", False),
}

PAIRS = [(b, c.__name__) for b, (_, _, caps) in sorted(BACKENDS.items())
         for c, need in CASES.items()
         if need is None or (need[0] in caps) == need[1]]
_BY_NAME = {c.__name__: c for c in CASES}


@pytest.fixture(scope="module")
def server():
    srv = FakeFabricServer()
    yield srv
    srv.close()


@pytest.mark.parametrize("backend,case", PAIRS)
def test_contract_matches_jax(backend, case, server):
    make, remote, _ = BACKENDS[backend]

    def scenario(tw, srv=None):
        provider, pool = make(tw, srv)
        return _BY_NAME[case](tw, provider, pool)

    if remote:
        jax, port = run_both_served(
            scenario, server, lambda: InMemoryPool(chips=dict(CHIPS)))
    else:
        jax, port = run_both(scenario)
    assert jax == port


def test_every_backend_and_case_is_covered():
    assert {b for b, _ in PAIRS} == set(BACKENDS)
    assert {c for _, c in PAIRS} == set(_BY_NAME)


# -- the H100 over every wire (port only) --------------------------------------------

H100 = "nvidia-h100-sxm"
H100_CHIPS = {H100: 16, "gpu-a100": 8}


def h100_lifecycle(p, pool):
    r = make_resource(PORT, "h-grp", node="host-0", model=H100, count=4,
                      nonce="n-h")
    result, _ = drive(PORT, lambda: p.add_resource(r))
    again, _ = drive(PORT, lambda: p.add_resource(r))
    r.status.device_ids = list(result.device_ids)
    t = [fabric_summary(result), fabric_summary(again), fabric_summary(p.check_resource(r)),
         pool.free_chips(H100)]
    t.append(fabric_summary(drive(PORT, lambda: p.remove_resource(r))[0]))
    return t + [pool.free_chips(H100), pool.get_resources()]


@pytest.mark.parametrize("backend", ["rest", "rest-fm", "rest-chaos", "layout",
                                     "redfish", "redfish-chaos"])
def test_h100_lifecycle_over_the_wire_equals_the_pool(backend):
    pool = PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS))
    direct = h100_lifecycle(pool, pool)
    srv = PortFabricServer()
    try:
        reset_server(srv, PORT.inmem.InMemoryPool(chips=dict(H100_CHIPS)))
        provider, served = BACKENDS[backend][0](PORT, srv)
        assert h100_lifecycle(provider, served) == direct
    finally:
        srv.close()
    assert direct[0][0] == "attach" and len(direct[0][1]) == 4
    assert direct[0][2] == f"tpu.composer.dev/device={direct[0][1][0]}"
