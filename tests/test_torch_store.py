"""The port's object store (tpu_composer_torch/runtime/store.py) against
the JAX package's (tests/test_store.py's twin).

Each scenario scripts the same operations against both stores and records
what a client observes: returned objects (as dicts), resource versions and
generations, the error class of a refused call, and the watch stream
(event type, kind, name, resource version). The two records must be
equal. Masked (``tests/torch_operator.MASKED``): uid and the timestamps.
"""

from __future__ import annotations

import queue

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)


def _req(tw, name="req-1", size=4):
    t = tw.types
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(type="tpu", model="tpu-v4", size=size)))


def _res(tw, name="tpu-1", node="worker-0", model="tpu-v4", type_="tpu"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type=type_, model=model, target_node=node))


def _call(trace, fn, *args):
    """Record fn's result (an object's dict, a list of names, a value) or
    the class name of the StoreError / ValueError it raised."""
    try:
        out = fn(*args)
    except Exception as e:
        trace.append(("raised", type(e).__name__))
        return None
    if hasattr(out, "to_dict"):
        trace.append(("obj", out.to_dict()))
    elif isinstance(out, list):
        trace.append(("list", [o.metadata.name for o in out]))
    else:
        trace.append(("value", out))
    return out


def _drain(q):
    out = []
    while True:
        try:
            ev = q.get(timeout=0.05)
        except queue.Empty:
            return out
        out.append((ev.type, ev.obj.KIND, ev.obj.metadata.name,
                    ev.obj.metadata.resource_version,
                    ev.obj.metadata.deletion_timestamp is not None))


def crud(tw):
    s, t = tw.store.Store(), []
    CR = tw.types.ComposabilityRequest
    _call(t, s.create, _req(tw))
    _call(t, s.create, _req(tw))  # duplicate
    _call(t, s.get, CR, "nope")
    t.append(("try_get", s.try_get(CR, "nope")))
    a = s.get(CR, "req-1")
    a.spec.resource.size = 123
    _call(t, s.get, CR, "req-1")  # isolated copy
    return t


def list_by_label(tw):
    s, t = tw.store.Store(), []
    r1, r2 = _res(tw, "a"), _res(tw, "b")
    r1.metadata.labels["app.kubernetes.io/managed-by"] = "req-1"
    r2.metadata.labels["app.kubernetes.io/managed-by"] = "req-2"
    s.create(r1)
    s.create(r2)
    CRs = tw.types.ComposableResource
    _call(t, s.list, CRs)
    _call(t, lambda: s.list(
        CRs, label_selector={"app.kubernetes.io/managed-by": "req-1"}))
    t.append(("keys", sorted(s.keys())))
    t.append(("len", len(s)))
    return t


def generation_and_conflicts(tw):
    s, t = tw.store.Store(), []
    CR = tw.types.ComposabilityRequest
    s.create(_req(tw))
    obj = s.get(CR, "req-1")
    obj.metadata.labels["x"] = "y"
    obj = _call(t, s.update, obj)  # metadata-only: generation stays
    obj.spec.resource.size = 8
    _call(t, s.update, obj)
    a, b = s.get(CR, "req-1"), s.get(CR, "req-1")
    a.spec.resource.size = 16
    _call(t, s.update, a)
    b.spec.resource.size = 32
    _call(t, s.update, b)  # stale resource version
    return t


def status_subresource(tw):
    s, t = tw.store.Store(), []
    CR = tw.types.ComposabilityRequest
    s.create(_req(tw))
    obj = s.get(CR, "req-1")
    obj.status.state = "Running"
    _call(t, s.update, obj)  # status ignored by update
    obj = s.get(CR, "req-1")
    obj.status.state = "NodeAllocating"
    obj.spec.resource.size = 99
    _call(t, s.update_status, obj)  # spec ignored by update_status
    _call(t, s.update_status, obj)  # stale now
    gone = _req(tw, "ghost")
    _call(t, s.update_status, gone)
    return t


def finalizer_deletion(tw):
    s, t = tw.store.Store(), []
    CR = tw.types.ComposabilityRequest
    s.create(_req(tw, "plain"))
    _call(t, s.delete, CR, "plain")
    t.append(("gone", s.try_get(CR, "plain") is None))
    obj = _req(tw)
    obj.add_finalizer("tpu.composer.dev/finalizer")
    obj.add_finalizer("f2")
    s.create(obj)
    _call(t, s.delete, CR, "req-1")
    got = _call(t, s.get, CR, "req-1")
    t.append(("terminating", got.being_deleted))
    _call(t, s.delete, CR, "req-1")  # second delete: no-op
    got.remove_finalizer("f2")
    _call(t, s.update, got)
    got = s.get(CR, "req-1")
    got.remove_finalizer("tpu.composer.dev/finalizer")
    _call(t, s.update, got)  # last finalizer: purged
    t.append(("purged", s.try_get(CR, "req-1") is None))
    _call(t, s.delete, CR, "req-1")  # not found
    t.append(("tolerant", tw.store.delete_tolerant(s, CR, "req-1")))
    return t


def watch_stream(tw):
    s, t = tw.store.Store(), []
    CR, CRs = tw.types.ComposabilityRequest, tw.types.ComposableResource
    q_all, q_req = s.watch(), s.watch("ComposabilityRequest")
    s.create(_req(tw))
    s.create(_res(tw))
    obj = s.get(CR, "req-1")
    obj.spec.resource.size = 8
    s.update(obj)
    obj = s.get(CR, "req-1")
    obj.status.state = "Running"
    s.update_status(obj)
    r = s.get(CRs, "tpu-1")
    r.add_finalizer("f")
    s.update(r)
    s.delete(CRs, "tpu-1")
    s.delete(CR, "req-1")
    t.append(("all", _drain(q_all)))
    t.append(("req", _drain(q_req)))
    s.stop_watch(q_req)
    s.create(_req(tw, "after"))
    t.append(("stopped", _drain(q_req)))
    return t


def admission(tw):
    s, t = tw.store.Store(), []

    def deny(op, new, old):
        if op == "CREATE" and new.spec.resource.size > 8:
            raise ValueError("too big")

    def default_model(op, new, old):
        if not new.spec.resource.model:
            new.spec.resource.model = "tpu-v4"

    s.register_admission("ComposabilityRequest", deny)
    s.register_admission("*", default_model)
    _call(t, s.create, _req(tw, size=8))
    _call(t, s.create, _req(tw, "big", size=16))
    r = _req(tw, "defaulted")
    r.spec.resource.model = ""
    _call(t, s.create, r)
    return t


def persistence(tw, tmp):
    state = str(tmp / tw.root)
    t = []
    CR = tw.types.ComposabilityRequest
    s1 = tw.store.Store(persist_dir=state)
    obj = _req(tw)
    obj.add_finalizer("f")
    s1.create(obj)
    got = s1.get(CR, "req-1")
    got.status.state = "NodeAllocating"
    s1.update_status(got)
    s1.create(_res(tw))
    s1.create(_req(tw, "doomed"))
    s1.delete(CR, "doomed")
    s2 = tw.store.Store(persist_dir=state)
    _call(t, s2.get, CR, "req-1")
    _call(t, s2.list, tw.types.ComposableResource)
    t.append(("doomed", s2.try_get(CR, "doomed") is None))
    _call(t, s2.create, _req(tw, "req-2"))
    return t


SCENARIOS = [crud, list_by_label, generation_and_conflicts,
             status_subresource, finalizer_deletion, watch_stream, admission]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_store_twin(scenario):
    jax_trace, port_trace = run_both(scenario)
    assert port_trace == jax_trace
    assert port_trace  # the scenario observed something


def test_store_persistence_twin(tmp_path):
    jax_trace, port_trace = run_both(persistence, tmp_path)
    assert port_trace == jax_trace
    # The restarted store resumed the status and the resource version.
    req = port_trace[0][1]
    assert req["status"]["state"] == "NodeAllocating"
    assert port_trace[-1][1]["metadata"]["resourceVersion"] > \
        req["metadata"]["resourceVersion"]


def test_port_store_is_its_own():
    """The two packages' stores share nothing: an object created in one
    is not seen by the other, and each package's own kinds decode."""
    from tpu_composer.runtime.store import Store as JaxStore
    from tpu_composer_torch.api.types import Node
    from tpu_composer_torch.api.meta import ObjectMeta
    from tpu_composer_torch.runtime.store import Store

    port, jax = Store(), JaxStore()
    port.create(Node(metadata=ObjectMeta(name="h")))
    assert len(port) == 1 and len(jax) == 0
    assert isinstance(port.get(Node, "h"), Node)
