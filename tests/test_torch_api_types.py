"""The port's API types (tpu_composer_torch/api/) against the JAX
package's (tests/test_api_types.py's twin).

Every kind round-trips across the packages through ``to_dict`` /
``from_dict`` (the port reads what JAX writes and JAX reads what the port
writes), validation errors are the same, and the H100 (``type="gpu"``,
``model="nvidia-h100-sxm"``) is admitted and keeps its slice membership
in the port's serialization. Masked: nothing; the objects are built with
fixed uids and timestamps.
"""

from __future__ import annotations

import copy

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, ROOTS, twin

torch.set_num_threads(1)

JAX = twin(JAX_ROOT)
PORT = twin(PORT_ROOT)
TS = "2026-01-02T03:04:05.000006Z"


def _meta(tw, name, **kw):
    m = tw.meta.ObjectMeta(name=name, uid=f"uid-{name}", resource_version=7,
                           generation=2, creation_timestamp=TS, **kw)
    m.labels["app.kubernetes.io/managed-by"] = "req-1"
    m.annotations["tpu.composer.dev/replaces"] = "old"
    m.finalizers.append("tpu.composer.dev/finalizer")
    m.owner_references.append(tw.meta.OwnerReference(
        kind="ComposabilityRequest", name="req-1", uid="uid-req-1"))
    return m


def _request(tw):
    t = tw.types
    r = t.ComposabilityRequest(
        metadata=_meta(tw, "req-1", deletion_timestamp=TS),
        spec=t.ComposabilityRequestSpec(
            resource=t.ResourceDetails(
                type="tpu", model="tpu-v4", size=8, allocation_policy="topology",
                topology="2x2x2", other_spec=t.OtherSpec(milli_cpu=500, memory=3)),
            priority=5, preemption_policy=t.PREEMPT_NEVER,
            repair_policy=t.REPAIR_DETACH_ONLY, max_concurrent_repairs=2,
            repair_grace_seconds=1.5),
    )
    r.status.state = t.REQUEST_STATE_RUNNING
    r.status.error = "e"
    r.status.first_ready_time = TS
    r.status.resources["res-0"] = t.ResourceStatus(
        state="Online", node_name="worker-0", device_ids=["a", "b"],
        cdi_device_id="c", worker_id=0, error="x", quarantined=True,
        pending_verb="add")
    r.status.scalar_resource = copy.deepcopy(r.spec.resource)
    r.status.slice = t.SliceStatus(name="s", topology="2x2x2", num_hosts=2,
                                   chips_per_host=4,
                                   worker_hostnames=["worker-0", "worker-1"])
    r.status.migration["res-0"] = t.MigrationRecord(
        member="res-0", replacement="res-9", from_node="worker-0",
        to_node="worker-2", trigger="defrag", phase="cutover", nonce="n",
        started_at=TS)
    return r


def _resource(tw, model="tpu-v4", type_="tpu"):
    t = tw.types
    r = t.ComposableResource(
        metadata=_meta(tw, "res-0"),
        spec=t.ComposableResourceSpec(
            type=type_, model=model, target_node="worker-0", force_detach=True,
            chip_count=4, slice_name="s", worker_id=1, topology="2x2x1"),
    )
    r.status.state = t.RESOURCE_STATE_DEGRADED
    r.status.error = "err"
    r.status.device_ids = ["chip-0", "chip-1"]
    r.status.cdi_device_id = "tpu.composer.dev/slice=s/worker=1"
    r.status.chip_indices = [4, 5]
    r.status.attach_attempts = 2
    r.status.quarantined = True
    r.status.pending_op = t.PendingOp(verb="remove", nonce="abc", node="worker-0",
                                      started_at=TS)
    r.status.failure = t.FailureRecord(reason="health-probe", detail="d",
                                       source="syncer", observed_at=TS,
                                       probe_failures=3)
    return r


def _node(tw):
    t = tw.types
    n = t.Node(metadata=_meta(tw, "worker-0"),
               spec=t.NodeSpec(agent_endpoint="10.0.0.1:9090", unschedulable=True))
    n.status = t.NodeStatus(milli_cpu=8000, memory=64, ephemeral_storage=5,
                            allowed_pod_number=110, tpu_slots=8, ready=False)
    return n


def _slice(tw):
    d = tw.dra
    return d.ResourceSlice(
        metadata=_meta(tw, "worker-0-tpu.composer.dev"),
        spec=d.ResourceSliceSpec(node_name="worker-0", pool="worker-0", devices=[
            d.SliceDevice(name="g-0", uuid="chip-0", model="tpu-v4",
                          slice_name="g", cdi_device_id="c", dev_path="/dev/accel0")]),
    )


def _taint(tw):
    d = tw.dra
    return d.DeviceTaintRule(
        metadata=_meta(tw, d.taint_rule_name("chip-0")),
        spec=d.DeviceTaintRuleSpec(device_uuid="chip-0", node_name="worker-0",
                                   reason="detaching"),
    )


def _maintenance(tw):
    m = tw.maintenance
    nm = m.NodeMaintenance(
        metadata=_meta(tw, "drain-worker-0"),
        spec=m.NodeMaintenanceSpec(node_name="worker-0", deadline_seconds=30.0,
                                   reason="firmware"),
    )
    nm.status = m.NodeMaintenanceStatus(
        state=m.MAINTENANCE_STATE_DRAINING, started_at=TS, evacuated=1,
        remaining=2, message="m")
    return nm


KINDS = {
    "ComposabilityRequest": (_request, "types"),
    "NodeMaintenance": (_maintenance, "maintenance"),
    "ComposableResource": (_resource, "types"),
    "Node": (_node, "types"),
    "ResourceSlice": (_slice, "dra"),
    "DeviceTaintRule": (_taint, "dra"),
}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_kind_round_trips_across_packages(kind, direction):
    build, mod = KINDS[kind]
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    obj = build(src)
    d = obj.to_dict()
    back = getattr(getattr(dst, mod), kind).from_dict(copy.deepcopy(d))
    assert back.to_dict() == d
    # The other package builds the same object to the same dict.
    assert build(dst).to_dict() == d
    # And the scheme decodes it by kind.
    assert dst.scheme.default_scheme().decode(d).to_dict() == d


def test_scheme_registers_the_ported_kinds():
    jax_kinds = set(JAX.scheme.default_scheme().kinds())
    port_kinds = set(PORT.scheme.default_scheme().kinds())
    assert port_kinds == set(KINDS)
    assert jax_kinds - port_kinds == {"Lease", "FleetTelemetry"}
    s = PORT.scheme.default_scheme()
    with pytest.raises(PORT.scheme.SchemeError):
        s.decode({"kind": "Lease"})
    raw = s.encode_json(_request(PORT))
    assert JAX.scheme.default_scheme().decode_json(raw).to_dict() == \
        s.decode_json(raw).to_dict()


def _request_with(tw, **overrides):
    t = tw.types
    details = dict(type="tpu", model="tpu-v4", size=4)
    details.update(overrides.pop("resource", {}))
    if "other_spec" in details:
        details["other_spec"] = t.OtherSpec(**details["other_spec"])
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="req-1"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(**details),
                                        **overrides))


def _resource_with(tw, **spec):
    t = tw.types
    fields = dict(type="tpu", model="tpu-v4", target_node="worker-0")
    fields.update(spec)
    return t.ComposableResource(metadata=tw.meta.ObjectMeta(name="r"),
                                spec=t.ComposableResourceSpec(**fields))


VALIDATION_CASES = [
    ("request", dict()),
    ("request", dict(resource=dict(type="fpga"))),
    ("request", dict(resource=dict(model=""))),
    ("request", dict(resource=dict(size=-1))),
    ("request", dict(resource=dict(allocation_policy="anywhere"))),
    ("request", dict(resource=dict(other_spec=dict(milli_cpu=-5)))),
    ("request", dict(resource=dict(type="gpu", model="A100 40G", size=1))),
    ("request", dict(resource=dict(type="gpu", model="nvidia-h100-sxm", size=8))),
    ("request", dict(priority=2_000_000_000)),
    ("request", dict(preemption_policy="Sometimes")),
    ("request", dict(repair_policy="Pray")),
    ("request", dict(max_concurrent_repairs=0)),
    ("request", dict(repair_grace_seconds=-1.0)),
    ("resource", dict()),
    ("resource", dict(target_node="")),
    ("resource", dict(model="")),
    ("resource", dict(type="asic")),
    ("resource", dict(chip_count=0)),
    ("resource", dict(type="gpu", model="nvidia-h100-sxm", chip_count=8)),
]


def _validate(tw, which, kw):
    obj = (_request_with if which == "request" else _resource_with)(tw, **kw)
    try:
        obj.validate()
    except tw.types.ValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("which,kw", VALIDATION_CASES,
                         ids=[f"{w}-{i}" for i, (w, _) in enumerate(VALIDATION_CASES)])
def test_validation_errors_are_the_same(which, kw):
    assert _validate(PORT, which, kw) == _validate(JAX, which, kw)


def test_h100_is_admitted_and_keeps_its_slice_membership():
    assert "gpu" in PORT.types.DEVICE_TYPES
    r = _resource_with(PORT, type="gpu", model="nvidia-h100-sxm", chip_count=8,
                       slice_name="s", worker_id=1, topology="8x2")
    r.validate()
    d = r.to_dict()
    # The port serializes an H100 group's membership as a TPU group's ...
    assert {k: d["spec"][k] for k in ("chip_count", "slice_name", "worker_id",
                                      "topology")} == dict(
        chip_count=8, slice_name="s", worker_id=1, topology="8x2")
    back = PORT.types.ComposableResource.from_dict(d)
    assert back.spec == r.spec
    # ... and the JAX package reads it (its own writer drops the fields for
    # every gpu model, as it does for the loose gpu-a100 compat path).
    j = JAX.types.ComposableResource.from_dict(d)
    assert (j.spec.chip_count, j.spec.slice_name, j.spec.worker_id,
            j.spec.topology) == (8, "s", 1, "8x2")
    # A loose gpu model serializes exactly as in JAX.
    loose = _resource_with(PORT, type="gpu", model="gpu-a100", slice_name="s")
    assert loose.to_dict() == _resource_with(
        JAX, type="gpu", model="gpu-a100", slice_name="s").to_dict()
    assert "slice_name" not in loose.to_dict()["spec"]


@pytest.mark.parametrize("root", ROOTS)
def test_meta_helpers(root):
    tw = twin(root)
    req = _request_with(tw)
    assert req.add_finalizer("f1") and not req.add_finalizer("f1")
    assert req.has_finalizer("f1")
    assert req.remove_finalizer("f1") and not req.remove_finalizer("f1")
    req.metadata.uid = "uid-1"
    child = _resource_with(tw)
    child.set_owner(req)
    child.set_owner(req)
    assert child.owned_by(req) and len(child.metadata.owner_references) == 1
    cp = req.deepcopy()
    cp.spec.resource.size = 99
    assert req.spec.resource.size == 4
    ts = tw.meta.now_iso()
    assert ts.endswith("Z") and tw.meta.parse_iso(ts).tzinfo is not None
    assert len(tw.meta.new_uid()) == 36
    assert req.to_dict()["apiVersion"] == "tpu.composer.dev/v1alpha1"


def test_slice_status_keeps_its_fields():
    """SliceStatus, which the coordinate env and the probe read, keeps
    its fields and serialization."""
    s = PORT.types.SliceStatus(name="s", topology="1x1", num_hosts=1,
                               chips_per_host=1, worker_hostnames=["h"])
    j = JAX.types.SliceStatus(name="s", topology="1x1", num_hosts=1,
                              chips_per_host=1, worker_hostnames=["h"])
    assert s.to_dict() == j.to_dict()
    assert PORT.types.SliceStatus.from_dict({}).to_dict() == {}
    from tpu_composer_torch.api import SliceStatus
    assert SliceStatus is PORT.types.SliceStatus
