"""The port's ComposabilityRequest reconciler
(tpu_composer_torch/controllers/request_controller.py) against the JAX
package's (tests/test_request_controller.py's twin).

The same request is stepped through both packages' request and resource
reconcilers, each over its own Store (8 workers of 4 chip slots),
``InMemoryPool`` and ``FakeNodeAgent`` (``tests/torch_operator.RequestWorld``).
After every step the worlds are compared: each request's state, error,
``status.slice`` and rows, each child's spec (chip count, slice name,
worker id, topology, node), state, device ids and chip indices, the
pool's slice reservations and its free chips; and each step's outcome
(the error raised, if any). ``uuid.uuid4`` is seeded the same on both
sides, so generated child names (``<type>-<uuid>``) match; masked: uid,
timestamps, intent nonces, trace ids. Tolerance: exact.

The NVIDIA H100 (``type="gpu"``, ``model="nvidia-h100-sxm"``) has no JAX
counterpart. Its requests are held to the port's own ``solve_slice`` and
``slice_env``: one child per host holding that host's GPUs, never ``size``
one-GPU children; sizes 1, 4 and 8 on one host and 16 as ``8x2``;
``target_node`` pinning and the multi-host refusal; a grow 4 → 8 that
dissolves the slice and a grow 8 → 16 that keeps worker 0; every child's
published CDI spec env equal to ``slice_env(req.status.slice, worker_id,
model)``.
"""

from __future__ import annotations

import logging
import re

import pytest
import torch

from tests.torch_operator import (
    PORT_ROOT,
    RequestWorld,
    outcome,
    run_both,
    seeded_uuids,
    twin,
)

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"
CHIPS = {"tpu-v4": 64, "gpu-a100": 8}


def world(tw, **kw):
    return RequestWorld(tw, n_nodes=8, slots=4, chips=dict(CHIPS), **kw)


def stepped(w, name="req-1", max_steps=60):
    """Pump one step at a time until ``name`` is Running; the view after
    every step."""
    trace = []
    for _ in range(max_steps):
        w.pump(1)
        trace.append(w.view())
        if w.get(name).status.state == "Running":
            return trace
    raise AssertionError(f"{name} never reached Running")


def req_step(w, name="req-1"):
    return [outcome(w.req_rec.reconcile, name), w.view()]


# -- TPU slices -----------------------------------------------------------------

def single_host_slice_to_running(tw):
    w = world(tw)
    w.request("req-1", size=4)
    trace = req_step(w) + req_step(w)
    req = w.get("req-1")
    assert req.status.state == "Updating"
    assert req.status.slice.topology == "1x2x2"
    trace += stepped(w)
    (rs,) = w.get("req-1").status.resources.values()
    assert rs.state == "Online" and len(rs.device_ids) == 4
    return trace


def multi_host_pod_slice(tw):
    w = world(tw)
    w.request("req-1", size=32)
    trace = stepped(w)
    kids = w.children("req-1")
    assert len(kids) == 8 and all(c.spec.chip_count == 4 for c in kids)
    assert sorted(c.spec.worker_id for c in kids) == list(range(8))
    assert w.pool.free_chips("tpu-v4") == 32
    return trace


def all_or_nothing_when_pool_too_small(tw):
    w = world(tw)
    small = tw.inmem.InMemoryPool(chips={"tpu-v4": 6})
    w.req_rec = tw.req.ComposabilityRequestReconciler(w.store, small)
    w.request("req-1", size=8)
    out = outcome(w.req_rec.reconcile, "req-1")
    assert out[0] == "raised"
    req = w.get("req-1")
    assert req.status.state == "" and "free" in req.status.error
    assert small.free_chips("tpu-v4") == 6 and not w.children("req-1")
    return [out, w.view()]


def not_enough_hosts_is_allocation_error(tw):
    w = world(tw)
    w.request("req-1", size=64)
    out = req_step(w)
    assert out[0][1] == "AllocationError" and "hosts" in w.get("req-1").status.error
    return out


def invalid_chip_count_surfaces_topology_error(tw):
    w = world(tw)
    w.request("req-1", size=6)
    out = req_step(w)
    assert "cannot form a slice" in w.get("req-1").status.error
    return out


def target_node_single_host(tw):
    w = world(tw)
    w.request("req-1", size=4, target_node="worker-3")
    trace = stepped(w)
    (child,) = w.children("req-1")
    assert child.spec.target_node == "worker-3"
    return trace


def target_node_rejects_multi_host_topology(tw):
    w = world(tw)
    w.request("req-1", size=8, target_node="worker-0")
    out = req_step(w)
    assert out[0][1] == "AllocationError"
    return out


def _policy_places_multi_host(tw, policy):
    w = world(tw)
    w.request("req-1", size=8, allocation_policy=policy)
    trace = stepped(w)
    assert len({c.spec.target_node for c in w.children("req-1")}) == 2
    return trace


def samenode_policy_places_multi_host_slice(tw):
    return _policy_places_multi_host(tw, "samenode")


def topology_policy_spreads_multi_host(tw):
    return _policy_places_multi_host(tw, "topology")


def capacity_filter_respects_other_spec(tw):
    w = world(tw)
    w.request("req-1", size=4, other_spec=tw.types.OtherSpec(milli_cpu=99999))
    out = req_step(w)
    assert out[0][1] == "AllocationError"
    return out


def occupancy_excludes_full_nodes(tw):
    w = world(tw)
    for i in range(7):
        w.request(f"filler-{i}", size=4, target_node=f"worker-{i}")
        w.run_to_ready(f"filler-{i}")
    w.request("req-1", size=4)
    trace = stepped(w)
    (child,) = w.children("req-1")
    assert child.spec.target_node == "worker-7"
    return trace


# -- scalar compat (gpu-a100) ------------------------------------------------------

def gpu_request_to_running(tw):
    w = world(tw)
    w.request("req-1", size=2, model="gpu-a100",
              allocation_policy="differentnode")
    trace = stepped(w)
    kids = w.children("req-1")
    assert len(kids) == 2 and len({c.spec.target_node for c in kids}) == 2
    assert w.pool.free_chips("gpu-a100") == 6
    return trace


def samenode_packs_one_node(tw):
    w = world(tw)
    w.request("req-1", size=2, model="gpu-a100")
    trace = stepped(w)
    assert len({c.spec.target_node for c in w.children("req-1")}) == 1
    return trace


def shrink_uses_deletion_priorities(tw):
    t = tw.types
    w = world(tw)
    w.request("req-1", size=3, model="gpu-a100",
              allocation_policy="differentnode")
    w.run_to_ready("req-1")
    kids = w.children("req-1")
    marked, used = kids[0], kids[1]
    marked.metadata.annotations[t.ANNOTATION_DELETE_DEVICE] = "true"
    w.store.update(marked)
    used.metadata.annotations[t.ANNOTATION_LAST_USED_TIME] = "2026-07-29T00:00:00Z"
    w.store.update(used)
    w.resize("req-1", 2)
    trace = req_step(w) + req_step(w)
    doomed = w.store.try_get(t.ComposableResource, marked.metadata.name)
    assert doomed is None or doomed.being_deleted
    assert not w.store.get(t.ComposableResource, used.metadata.name).being_deleted
    return trace


def scalar_grow_keeps_existing_children(tw):
    w = world(tw)
    w.request("req-1", size=1, model="gpu-a100")
    w.run_to_ready("req-1")
    (orig,) = w.children("req-1")
    w.resize("req-1", 2)
    trace = stepped(w)
    kids = w.children("req-1")
    assert len(kids) == 2 and orig.metadata.name in {c.metadata.name for c in kids}
    return trace


# -- lifecycle -------------------------------------------------------------------

def delete_cleans_children_and_releases_chips(tw):
    w = world(tw)
    w.request("req-1", size=8)
    w.run_to_ready("req-1")
    assert w.pool.free_chips("tpu-v4") == 56
    w.delete("req-1")
    trace = []
    for _ in range(30):
        if w.get("req-1") is None:
            break
        trace += req_step(w)
        for c in w.store.list(tw.types.ComposableResource):
            trace.append(outcome(w.res_rec.reconcile, c.metadata.name))
    assert w.get("req-1") is None and not w.store.list(tw.types.ComposableResource)
    assert w.pool.free_chips("tpu-v4") == 64
    return trace + [w.view()]


def spec_drift_in_running_reallocates(tw):
    w = world(tw)
    w.request("req-1", size=4)
    w.run_to_ready("req-1")
    w.resize("req-1", 8)
    trace = req_step(w)
    assert w.get("req-1").status.state == "NodeAllocating"
    trace += stepped(w)
    req = w.get("req-1")
    assert req.status.slice.num_hosts == 2
    assert sum(len(r.device_ids) for r in req.status.resources.values()) == 8
    return trace


def member_loss_triggers_reallocation(tw):
    t = tw.types
    w = world(tw)
    w.request("req-1", size=8)
    w.run_to_ready("req-1")
    victim = w.children("req-1")[0]
    w.store.delete(t.ComposableResource, victim.metadata.name)
    for _ in range(10):
        if w.store.try_get(t.ComposableResource, victim.metadata.name) is None:
            break
        w.res_rec.reconcile(victim.metadata.name)
    trace = req_step(w)
    assert w.get("req-1").status.state == "NodeAllocating"
    return trace + stepped(w)


def request_gc_when_target_node_deleted(tw):
    w = world(tw)
    w.request("req-1", size=4, target_node="worker-2")
    w.run_to_ready("req-1")
    w.store.delete(tw.types.Node, "worker-2")
    trace = req_step(w)
    req = w.get("req-1")
    assert req.being_deleted and req.status.state == "Cleaning"
    return trace


def size_zero_runs_with_no_children(tw):
    w = world(tw)
    w.request("req-1", size=0)
    trace = stepped(w)
    assert w.children("req-1") == []
    return trace


def lost_scalar_child_is_replaced(tw):
    t = tw.types
    w = world(tw)
    w.request("req-1", size=2, model="gpu-a100",
              allocation_policy="differentnode")
    w.run_to_ready("req-1")
    victim = w.children("req-1")[0]
    w.store.delete(t.ComposableResource, victim.metadata.name)
    for _ in range(10):
        if w.store.try_get(t.ComposableResource, victim.metadata.name) is None:
            break
        w.res_rec.reconcile(victim.metadata.name)
    trace = stepped(w)
    kids = w.children("req-1")
    assert len(kids) == 2 and all(c.status.state == "Online" for c in kids)
    return trace


def scalar_target_node_overcommit_rejected(tw):
    w = world(tw)
    w.request("req-1", size=5, model="gpu-a100", target_node="worker-0")
    out = req_step(w)
    assert out[0][1] == "AllocationError"
    assert "free device ports" in w.get("req-1").status.error
    return out


# -- live resize -------------------------------------------------------------------

def grow_keeps_existing_children(tw):
    w = world(tw)
    w.request("req-1", size=4)
    w.run_to_ready("req-1")
    (orig,) = w.children("req-1")
    w.resize("req-1", 8)
    trace = stepped(w)
    survivor, added = sorted(w.children("req-1"), key=lambda c: c.spec.worker_id)
    assert survivor.metadata.uid == orig.metadata.uid
    assert list(survivor.status.device_ids) == list(orig.status.device_ids)
    assert (survivor.spec.worker_id, survivor.spec.topology) == (0, "2x2x2")
    assert added.spec.worker_id == 1
    sl = w.get("req-1").status.slice
    assert sl.worker_hostnames[0] == orig.spec.target_node
    return trace


def shrink_keeps_surviving_prefix(tw):
    w = world(tw)
    w.request("req-1", size=8)
    w.run_to_ready("req-1")
    keeper = sorted(w.children("req-1"), key=lambda c: c.spec.worker_id)[0]
    free_before = w.pool.free_chips("tpu-v4")
    w.resize("req-1", 4)
    trace = stepped(w)
    (kid,) = w.children("req-1")
    assert kid.metadata.uid == keeper.metadata.uid
    assert kid.spec.topology == "1x2x2"
    assert w.pool.free_chips("tpu-v4") == free_before + 4
    return trace


def chips_per_host_change_dissolves(tw):
    w = world(tw)
    w.request("req-1", size=2)
    w.run_to_ready("req-1")
    orig_uid = w.children("req-1")[0].metadata.uid
    w.resize("req-1", 8)
    trace = stepped(w)
    kids = w.children("req-1")
    assert len(kids) == 2 and all(c.metadata.uid != orig_uid for c in kids)
    return trace


def grow_of_node_pinned_request_is_rejected(tw):
    w = world(tw)
    w.request("req-1", size=4, target_node="worker-0")
    w.run_to_ready("req-1")
    w.resize("req-1", 8)
    trace = req_step(w) + req_step(w)
    assert trace[2][1] == "AllocationError"
    assert "single-host" in w.get("req-1").status.error
    return trace


# -- deletion races ------------------------------------------------------------------

def finalizer_put_races_concurrent_purge(tw):
    t = tw.types
    w = world(tw)
    w.request("req-1", size=4)
    w.run_to_ready("req-1")
    w.delete("req-1")
    for _ in range(30):
        req = w.get("req-1")
        if req is None or req.status.state == "Deleting":
            break
        w.req_rec.reconcile("req-1")
        for c in w.store.list(t.ComposableResource):
            w.res_rec.reconcile(c.metadata.name)
    stale = w.get("req-1")
    w.req_rec.reconcile("req-1")
    assert w.get("req-1") is None
    r = w.req_rec._handle_deleting(stale)
    assert r.requeue_after == 0
    return w.view()


def target_node_gc_races_finalizerless_purge(tw):
    w = world(tw)
    w.request("req-1", size=4, target_node="worker-2")
    req = w.get("req-1")
    req.status.state = "Running"
    w.store.update_status(req)
    w.store.delete(tw.types.Node, "worker-2")
    trace = req_step(w)
    assert w.get("req-1") is None
    return trace


def delete_children_tolerates_gone_child(tw):
    t = tw.types
    w = world(tw)
    w.request("req-1", size=8)
    w.run_to_ready("req-1")
    victims = w.children("req-1")
    w.store.delete(t.ComposableResource, victims[0].metadata.name)
    gone = w.store.try_get(t.ComposableResource, victims[0].metadata.name)
    if gone is not None:
        gone.metadata.finalizers = []
        w.store.update(gone)
    w.req_rec._delete_children(w.get("req-1"), victims)
    for v in victims[1:]:
        assert w.store.get(t.ComposableResource, v.metadata.name).being_deleted
    return w.view()


_UNKNOWN_MODEL = re.compile(
    r"unknown (?:TPU|accelerator) model ('[^']*'); known: \[[^\]]*\]")


def _model_table_neutral(obj):
    """``obj`` with the topology table's unknown-model message reduced to
    the model it names: the port's table (and so its wording and its list
    of known models) also holds the H100."""
    if isinstance(obj, str):
        return _UNKNOWN_MODEL.sub(r"unknown model \1", obj)
    if isinstance(obj, dict):
        return {k: _model_table_neutral(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_model_table_neutral(v) for v in obj]
    return obj


def _six_reconciles(w, name="req-1"):
    """Six passes of the request reconciler, each followed by one pass
    over its children; every pass's outcome and the world after it."""
    trace = []
    for _ in range(6):
        trace.append(outcome(w.req_rec.reconcile, name))
        for c in w.children(name):
            trace.append(outcome(w.res_rec.reconcile, c.metadata.name))
        trace.append(w.view())
    return _model_table_neutral(trace)


def tpu_type_with_a_model_not_in_the_table(tw):
    """``type="tpu"`` picks the slice path, whatever the model: a model
    the topology table lacks is a TopologyError on every pass, and no
    child is made."""
    w = world(tw)
    w.request("req-1", size=4, model="tpu-v9", type_="tpu")
    return _six_reconciles(w)


def gpu_type_with_a_tpu_model(tw):
    """``type="gpu"`` with a TPU model takes the loose path: ``size``
    one-chip children, no slice reservation."""
    w = world(tw)
    w.request("req-1", size=4, model="tpu-v4", type_="gpu")
    return _six_reconciles(w)


SCENARIOS = [
    single_host_slice_to_running, multi_host_pod_slice,
    all_or_nothing_when_pool_too_small, not_enough_hosts_is_allocation_error,
    invalid_chip_count_surfaces_topology_error, target_node_single_host,
    target_node_rejects_multi_host_topology,
    samenode_policy_places_multi_host_slice, topology_policy_spreads_multi_host,
    capacity_filter_respects_other_spec, occupancy_excludes_full_nodes,
    gpu_request_to_running, samenode_packs_one_node,
    shrink_uses_deletion_priorities, scalar_grow_keeps_existing_children,
    delete_cleans_children_and_releases_chips,
    spec_drift_in_running_reallocates, member_loss_triggers_reallocation,
    request_gc_when_target_node_deleted, size_zero_runs_with_no_children,
    lost_scalar_child_is_replaced, scalar_target_node_overcommit_rejected,
    grow_keeps_existing_children, shrink_keeps_surviving_prefix,
    chips_per_host_change_dissolves, grow_of_node_pinned_request_is_rejected,
    finalizer_put_races_concurrent_purge,
    target_node_gc_races_finalizerless_purge,
    delete_children_tolerates_gone_child,
    tpu_type_with_a_model_not_in_the_table, gpu_type_with_a_tpu_model,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


def test_request_type_picks_the_path_as_jax_does():
    """Anchors on the JAX records of the two type-versus-model requests:
    ``type="tpu"`` with an unknown model raises on every pass and makes
    no child; ``type="gpu"`` with a TPU model makes four one-chip
    children and reserves no slice."""
    jax, _ = run_both(tpu_type_with_a_model_not_in_the_table)
    assert [step[:2] for step in jax[0::2]] == [["raised", "TopologyError"]] * 6
    assert jax[-1]["children"] == {} and jax[-1]["pool"] == {}
    jax, _ = run_both(gpu_type_with_a_tpu_model)
    kids = jax[-1]["children"]
    assert len(kids) == 4 and jax[-1]["pool"] == {}
    assert [len(k["device_ids"]) for k in kids.values()] == [1, 1, 1, 1]
    assert {k["spec"]["type"] for k in kids.values()} == {"gpu"}


def test_retopologize_conflict_is_logged_and_retried(caplog):
    """A failed topology rewrite is logged, and the server copy keeps its
    topology, in both packages."""
    out = []
    for root in ("tpu_composer", PORT_ROOT):
        tw = twin(root)
        with seeded_uuids():
            w = world(tw)
            w.request("req-1", size=4)
            w.run_to_ready("req-1")
            child = w.children("req-1")[0]
            stale = child.deepcopy()
            w.store.update(child)
            stale.spec.topology = ""
            caplog.clear()
            with caplog.at_level(logging.INFO):
                w.req_rec._retopologize([stale], child.spec.topology)
            out.append((any("retopologize" in r.getMessage()
                            for r in caplog.records),
                        w.store.get(tw.types.ComposableResource,
                                    child.metadata.name).spec.topology))
    assert out[0] == out[1] == (True, "1x2x2")


# -- the H100 (port only) -----------------------------------------------------------

PORT = twin(PORT_ROOT)


def h100_world(n_nodes=3, chips=32):
    return RequestWorld(PORT, n_nodes=n_nodes, slots=8,
                        chips={H100: chips, "gpu-a100": 8})


def assert_h100_slice(w, name, size, target=None):
    """The request is Running on the port's solve_slice shape, one child
    per host holding chips_per_host GPUs, the pool's reservation matches,
    and every child's published spec env is slice_env's."""
    shape = PORT.slices.solve_slice(H100, size)
    req = w.get(name)
    assert req.status.state == "Running"
    sl = req.status.slice
    assert (sl.name, sl.topology, sl.num_hosts, sl.chips_per_host) == (
        f"{name}-slice", shape.topology, shape.num_hosts, shape.chips_per_host)
    assert len(set(sl.worker_hostnames)) == shape.num_hosts
    if target:
        assert sl.worker_hostnames == [target]
    kids = sorted(w.children(name), key=lambda c: c.spec.worker_id)
    assert len(kids) == shape.num_hosts
    res = w.pool._slices[sl.name]
    assert (res.model, res.topology, list(res.nodes)) == (
        H100, shape.topology, list(sl.worker_hostnames))
    for wid, c in enumerate(kids):
        assert (c.spec.type, c.spec.model, c.spec.worker_id) == ("gpu", H100, wid)
        assert c.spec.chip_count == shape.chips_per_host
        assert (c.spec.slice_name, c.spec.topology) == (sl.name, sl.topology)
        assert c.spec.target_node == sl.worker_hostnames[wid]
        assert c.status.state == "Online"
        assert len(c.status.device_ids) == shape.chips_per_host
        assert sorted(c.status.chip_indices) == list(range(shape.chips_per_host))
        spec = w.agent.published_spec(c.spec.target_node, f"{sl.name}-worker{wid}")
        assert spec is not None
        assert spec.env == PORT.coordinates.slice_env(sl, wid, H100)
        assert spec.env["WORLD_SIZE"] == str(size)
        assert spec.env["GROUP_RANK"] == str(wid)
        assert spec.env["LOCAL_WORLD_SIZE"] == str(shape.chips_per_host)
    return kids


@pytest.mark.parametrize("size,topology", [(1, "1x1"), (4, "4x1"), (8, "8x1"),
                                           (16, "8x2")])
def test_h100_request_is_one_child_per_host(size, topology):
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=size, model=H100)
        w.run_to_ready("job")
        kids = assert_h100_slice(w, "job", size)
        assert kids[0].spec.topology == topology
        assert w.pool.free_chips(H100) == 32 - size
        used = w.req_rec.scheduler.engine.used_slots_map("")
        assert sum(used.values()) == size and max(used.values()) <= 8


def test_h100_target_node_pins_the_host():
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=4, model=H100, target_node="worker-2")
        w.run_to_ready("job")
        assert_h100_slice(w, "job", 4, target="worker-2")


def test_h100_target_node_refuses_multi_host():
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=16, model=H100, target_node="worker-0")
        with pytest.raises(PORT.placement.AllocationError, match="single-host"):
            w.req_rec.reconcile("job")
        assert not w.children("job") and not w.pool._slices


def test_h100_grow_4_to_8_dissolves_the_slice():
    """chips_per_host 4 -> 8 reshapes the host's group: every member is
    replaced, as a TPU chips-per-host change does."""
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=4, model=H100)
        w.run_to_ready("job")
        (orig,) = w.children("job")
        w.resize("job", 8)
        w.run_to_ready("job")
        (kid,) = assert_h100_slice(w, "job", 8)
        assert kid.metadata.uid != orig.metadata.uid
        assert w.store.try_get(PORT.types.ComposableResource,
                               orig.metadata.name) is None


def test_h100_grow_8_to_16_keeps_worker_0():
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=8, model=H100)
        w.run_to_ready("job")
        (orig,) = w.children("job")
        w.resize("job", 16)
        w.run_to_ready("job")
        kids = assert_h100_slice(w, "job", 16)
        assert kids[0].metadata.uid == orig.metadata.uid
        assert list(kids[0].status.device_ids) == list(orig.status.device_ids)
        assert kids[0].spec.target_node == orig.spec.target_node
        assert kids[0].spec.topology == "8x2"
        # Worker 0's spec was republished with the grown world.
        spec = w.agent.published_spec(orig.spec.target_node, "job-slice-worker0")
        assert spec.env["WORLD_SIZE"] == "16"


def test_h100_shrink_16_to_8_keeps_the_prefix():
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=16, model=H100)
        w.run_to_ready("job")
        keeper = sorted(w.children("job"), key=lambda c: c.spec.worker_id)[0]
        w.resize("job", 8)
        w.run_to_ready("job")
        (kid,) = assert_h100_slice(w, "job", 8)
        assert kid.metadata.uid == keeper.metadata.uid
        w.pump(5)
        assert w.pool.free_chips(H100) == 32 - 8


def test_h100_never_overcommits_a_host():
    """Two 4-GPU requests share a host of 8; a third 8-GPU request goes to
    an empty host; a fourth finds none and stays unplaced."""
    with seeded_uuids():
        w = h100_world(n_nodes=2)
        for name, size in (("a", 4), ("b", 4), ("c", 8)):
            w.request(name, size=size, model=H100)
            w.run_to_ready(name)
        hosts = {n: w.get(n).status.slice.worker_hostnames for n in "abc"}
        assert hosts["a"] == hosts["b"] != hosts["c"]
        w.request("d", size=1, model=H100)
        with pytest.raises(PORT.placement.AllocationError):
            w.req_rec.reconcile("d")
        used = w.req_rec.scheduler.engine.used_slots_map("")
        assert used == {"worker-0": 8, "worker-1": 8}


def test_h100_delete_releases_the_slice():
    with seeded_uuids():
        w = h100_world()
        w.request("job", size=16, model=H100)
        w.run_to_ready("job")
        w.delete("job")
        w.settle("job")
        assert w.pool.free_chips(H100) == 32 and not w.pool._slices
        for n in ("worker-0", "worker-1", "worker-2"):
            assert w.agent.published(n) == []
