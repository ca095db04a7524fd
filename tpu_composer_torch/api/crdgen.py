"""CRD manifest generation — keeps deploy/crds in sync with api/types.py
(port of ``tpu_composer/api/crdgen.py``).

Reference analog: the controller-gen-produced OpenAPI schemas under
config/crd/bases (generated from kubebuilder markers in
api/v1alpha1/*_types.go). Our schemas are built programmatically from the
same constants the Python types validate against, so the YAML can never
drift from the code: ``python -m tpu_composer_torch.api.crdgen deploy/crds``
regenerates (the ``make manifests`` analog, Makefile:162). The two
operators serve one API group from the same types, so this module's
``manifests()`` equals the JAX package's and both keep the one
``deploy/crds``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

from tpu_composer_torch.api.types import (
    ALLOCATION_POLICIES,
    DEVICE_TYPES,
    PREEMPTION_POLICIES,
    PRIORITY_MAX,
    PRIORITY_MIN,
    REPAIR_POLICIES,
)

from tpu_composer_torch import GROUP, VERSION  # single source of truth for the API group


def _str(desc: str = "", enum: List[str] = None, min_length: int = 0) -> Dict:
    s: Dict = {"type": "string"}
    if desc:
        s["description"] = desc
    if enum:
        s["enum"] = list(enum)
    if min_length:
        s["minLength"] = min_length
    return s


def _int(desc: str = "", minimum: int = None, maximum: int = None) -> Dict:
    s: Dict = {"type": "integer"}
    if desc:
        s["description"] = desc
    if minimum is not None:
        s["minimum"] = minimum
    if maximum is not None:
        s["maximum"] = maximum
    return s


def _bool(desc: str = "") -> Dict:
    s: Dict = {"type": "boolean"}
    if desc:
        s["description"] = desc
    return s


def _obj(props: Dict, required: List[str] = None, desc: str = "") -> Dict:
    s: Dict = {"type": "object", "properties": props}
    if required:
        s["required"] = list(required)
    if desc:
        s["description"] = desc
    return s


def _array(items: Dict, desc: str = "") -> Dict:
    s: Dict = {"type": "array", "items": items}
    if desc:
        s["description"] = desc
    return s


_OTHER_SPEC = _obj(
    {
        "milli_cpu": _int(minimum=0),
        "memory": _int(minimum=0),
        "ephemeral_storage": _int(minimum=0),
        "allowed_pod_number": _int(minimum=0),
    },
    desc="Node capacity the allocation must leave available "
    "(reference: composabilityrequest_types.go:55-64).",
)

_RESOURCE_DETAILS = _obj(
    {
        "type": _str("Device type", enum=list(DEVICE_TYPES)),
        "model": _str("Device model, e.g. tpu-v4", min_length=1),
        "size": _int("Chip count; must solve to a valid slice topology", minimum=1),
        "force_detach": _bool("Skip load checks on detach"),
        "allocation_policy": _str(enum=list(ALLOCATION_POLICIES)),
        "target_node": _str("Pin the allocation to one node (samenode only)"),
        "topology": _str("Explicit slice shape, e.g. 2x2x2 (else solved from size)"),
        "other_spec": _OTHER_SPEC,
    },
    required=["type", "model", "size"],
)

_RESOURCE_STATUS = _obj(
    {
        "state": _str(),
        "node_name": _str(),
        "device_ids": _array(_str()),
        "cdi_device_id": _str(),
        "worker_id": _int(),
        "error": _str(),
        "quarantined": _bool("Attach budget exhausted on this member"),
        "pending_verb": _str(
            "Verb of the member's in-flight fabric op (add/remove; empty"
            " when settled)"
        ),
    }
)

_FAILURE_RECORD = _obj(
    {
        "reason": _str("health-probe | device-vanished"),
        "detail": _str("Last health detail / missing device ids"),
        "source": _str("Which detector fired: health-probe | syncer"),
        "observed_at": _str("Wall-clock ISO of the Degraded transition"),
        "probe_failures": _int(
            "Consecutive failed observations that crossed the damping"
            " threshold", minimum=0,
        ),
    },
    desc="Why this member left Online for Degraded (self-healing data"
    " plane); written with the Degraded transition, cleared on recovery.",
)

_PENDING_OP = _obj(
    {
        "verb": _str(enum=["add", "remove"]),
        "nonce": _str("Unique per issued intent; survives crash/retry"),
        "node": _str(),
        "started_at": _str(),
    },
    desc="Durable fabric-mutation intent written before the attach/detach"
    " is issued and cleared when its outcome is recorded; the cold-start"
    " adoption pass reconstructs in-flight work from this after a crash.",
)

_MIGRATION_RECORD = _obj(
    {
        "member": _str("Migrating (source) member"),
        "replacement": _str("Target-side child riding the normal attach"),
        "from_node": _str(),
        "to_node": _str(),
        "trigger": _str("maintenance | evacuation | defrag"),
        "phase": _str("attaching | cutover"),
        "nonce": _str("Migration trace identity"),
        "started_at": _str(),
    },
    desc="One in-flight live migration of a slice member"
    " (make-before-break: replacement attaches, coordinates cut over,"
    " source detaches after the drain grace).",
)

_SLICE_STATUS = _obj(
    {
        "name": _str(),
        "topology": _str(),
        "num_hosts": _int(),
        "chips_per_host": _int(),
        "nodes": _array(_str(), "Hosts in worker order"),
    },
    desc="Authoritative record of the composed slice; the mutating webhook "
    "derives TPU_* coordinates from this (admission/coordinates.py).",
)

COMPOSABILITY_REQUEST_SCHEMA = _obj(
    {
        "apiVersion": _str(),
        "kind": _str(),
        "metadata": {"type": "object"},
        "spec": _obj(
            {
                "resource": _RESOURCE_DETAILS,
                "priority": _int(
                    "Scheduling priority: higher places first and may preempt"
                    " strictly-lower-priority requests (scheduler/).",
                    minimum=PRIORITY_MIN,
                    maximum=PRIORITY_MAX,
                ),
                "preemptionPolicy": _str(
                    "PreemptLowerPriority (default) or Never: Never neither"
                    " preempts nor may be preempted/defrag-migrated.",
                    enum=list(PREEMPTION_POLICIES),
                ),
                "repairPolicy": _str(
                    "Post-Ready member failure handling: Replace (default,"
                    " make-before-break replacement), DetachOnly (detach"
                    " the failed member, normal recovery re-solves), None"
                    " (no automatic action).",
                    enum=list(REPAIR_POLICIES),
                ),
                "maxConcurrentRepairs": _int(
                    "Surge budget: members of this request under active"
                    " repair at once (default 1).",
                    minimum=1,
                ),
                "repairGraceSeconds": {
                    "type": "number",
                    "minimum": 0,
                    "description": "Seconds a failed member stays attached"
                    " after its replacement is Online before the"
                    " force-detach (workload migration window).",
                },
            },
            required=["resource"],
        ),
        "status": _obj(
            {
                "state": _str(),
                "error": _str(),
                "resources": {
                    "type": "object",
                    "additionalProperties": _RESOURCE_STATUS,
                },
                "slice": _SLICE_STATUS,
                "scalar_resource": _RESOURCE_DETAILS,
                "migration": {
                    "type": "object",
                    "additionalProperties": _MIGRATION_RECORD,
                },
                "first_ready_time": _str(),
            }
        ),
    }
)

COMPOSABLE_RESOURCE_SCHEMA = _obj(
    {
        "apiVersion": _str(),
        "kind": _str(),
        "metadata": {"type": "object"},
        "spec": _obj(
            {
                "type": _str(enum=list(DEVICE_TYPES)),
                "model": _str(min_length=1),
                "target_node": _str(min_length=1),
                "force_detach": _bool(),
                "chip_count": _int(minimum=1),
                "slice_name": _str(),
                "worker_id": _int(minimum=0),
                "topology": _str(),
            },
            required=["type", "model", "target_node"],
        ),
        "status": _obj(
            {
                "state": _str(),
                "error": _str(),
                "device_ids": _array(_str()),
                "cdi_device_id": _str(),
                "chip_indices": _array(_int()),
                "attach_attempts": _int(
                    "Consecutive transient attach failures (resilience budget)"
                ),
                "quarantined": _bool(
                    "Attach budget exhausted; owner must reallocate"
                ),
                "pending_op": _PENDING_OP,
                "failure": _FAILURE_RECORD,
            }
        ),
    }
)

FLEET_TELEMETRY_SCHEMA = _obj(
    {
        "apiVersion": _str(),
        "kind": _str(),
        "metadata": {"type": "object"},
        "spec": _obj(
            {
                "identity": _str(
                    "Publishing replica identity (the shard/member lease"
                    " identity when sharded)",
                    min_length=1,
                ),
                "seq": _int(
                    "Monotonic publish counter — the aggregator's staleness"
                    " observation clock",
                    minimum=0,
                ),
                "processToken": _str(
                    "One token per OS process; histograms are merged once"
                    " per process so co-located replicas never double-count"
                ),
                "payload": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True,
                    "description": "Telemetry snapshot (histogram bucket"
                    " state, SLO burn rates, GIL ratios, profiler top-N);"
                    " shape owned by runtime/fleet.py, versioned by the"
                    " publisher — never by a CRD migration",
                },
            },
            required=["identity"],
        ),
        "status": _obj({}),
    }
)


NODE_MAINTENANCE_SCHEMA = _obj(
    {
        "apiVersion": _str(),
        "kind": _str(),
        "metadata": {"type": "object"},
        "spec": _obj(
            {
                "node_name": _str(
                    "Host to cordon and drain (live migration evacuates"
                    " every member make-before-break)",
                    min_length=1,
                ),
                "deadline_seconds": {
                    "type": "number",
                    "description": "Seconds the drain may run before"
                    " aborting; 0 uses the operator default"
                    " (--migrate-drain-deadline), negative disables the"
                    " deadline",
                },
                "reason": _str("Operator note, surfaced in events/status"),
            },
            required=["node_name"],
        ),
        "status": _obj(
            {
                "state": _str(
                    enum=["", "Cordoned", "Draining", "Drained", "Aborted"]
                ),
                "started_at": _str("Draining transition; the deadline clock"),
                "evacuated": _int(
                    "Members evacuated off the node by this drain", minimum=0
                ),
                "remaining": _int(
                    "Live members still on the node", minimum=0
                ),
                "message": _str(),
            }
        ),
    }
)


def crd(kind: str, plural: str, singular: str, short: List[str], schema: Dict) -> Dict:
    """Cluster-scoped CRD with status subresource + printer columns
    (reference: cluster-scoped markers, composabilityrequest_types.go:82-84)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "scope": "Cluster",
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": plural,
                "singular": singular,
                "shortNames": short,
            },
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "additionalPrinterColumns": [
                        {
                            "name": "State",
                            "type": "string",
                            "jsonPath": ".status.state",
                        },
                        {
                            "name": "Age",
                            "type": "date",
                            "jsonPath": ".metadata.creationTimestamp",
                        },
                    ],
                    "schema": {"openAPIV3Schema": schema},
                }
            ],
        },
    }


def manifests() -> Dict[str, Dict]:
    return {
        f"{GROUP}_composabilityrequests.yaml": crd(
            "ComposabilityRequest",
            "composabilityrequests",
            "composabilityrequest",
            ["creq"],
            COMPOSABILITY_REQUEST_SCHEMA,
        ),
        f"{GROUP}_composableresources.yaml": crd(
            "ComposableResource",
            "composableresources",
            "composableresource",
            ["cres"],
            COMPOSABLE_RESOURCE_SCHEMA,
        ),
        f"{GROUP}_fleettelemetries.yaml": crd(
            "FleetTelemetry",
            "fleettelemetries",
            "fleettelemetry",
            ["ftel"],
            FLEET_TELEMETRY_SCHEMA,
        ),
        f"{GROUP}_nodemaintenances.yaml": crd(
            "NodeMaintenance",
            "nodemaintenances",
            "nodemaintenance",
            ["nmaint"],
            NODE_MAINTENANCE_SCHEMA,
        ),
    }


def write_manifests(outdir: str) -> List[str]:
    import yaml

    os.makedirs(outdir, exist_ok=True)
    paths = []
    for fn, doc in manifests().items():
        path = os.path.join(outdir, fn)
        with open(path, "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
        paths.append(path)
    return paths


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "deploy/crds"
    for p in write_manifests(out):
        print(p)
