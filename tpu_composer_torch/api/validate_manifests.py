"""Schema validation for the deploy artifacts — the envtest-install gate
(port of ``tpu_composer/api/validate_manifests.py``).

The reference's suites install the generated CRDs into a
real apiserver on every run (suite_test.go:353-355), so a CRD-generation
bug cannot ship. Without apiserver binaries, this module re-implements the
two checks that install performs:

1. **Structural-schema validation of each CRD** (the apiextensions rules a
   real apiserver enforces at CRD-create time): apiVersion/kind/name
   consistency, exactly one storage version, every version carries an
   ``openAPIV3Schema`` of type object, every nested property declares a
   type (or opts out via x-kubernetes-preserve-unknown-fields), list
   schemas carry ``items``.
2. **Instance validation of the shipped examples** against those schemas —
   a mini OpenAPI checker covering the subset controller-gen emits (type,
   properties, required, items, enum, additionalProperties) — so a drift
   between api/types.py and deploy/crds fails CI, not a cluster.

Also shape-checks every document in ``dist/install.yaml`` (apiVersion,
kind, metadata.name present; workload kinds carry a pod template).

Usage: ``python -m tpu_composer_torch.api.validate_manifests <crd-dir> <install.yaml>``
Exit 0 = everything valid; exit 1 prints each finding.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Any, Dict, Iterator, List, Tuple

import yaml

Errors = List[str]


# ---------------------------------------------------------------------------
# structural schema rules (apiserver CRD-create analog)
# ---------------------------------------------------------------------------

def _walk_schema(schema: Dict[str, Any], path: str) -> Iterator[Tuple[str, Dict[str, Any]]]:
    yield path, schema
    for name, sub in (schema.get("properties") or {}).items():
        yield from _walk_schema(sub, f"{path}.{name}")
    if isinstance(schema.get("items"), dict):
        yield from _walk_schema(schema["items"], f"{path}[]")
    if isinstance(schema.get("additionalProperties"), dict):
        yield from _walk_schema(schema["additionalProperties"], f"{path}{{}}")


def validate_crd(doc: Dict[str, Any], source: str) -> Errors:
    errs: Errors = []

    def err(msg: str) -> None:
        errs.append(f"{source}: {msg}")

    if doc.get("apiVersion") != "apiextensions.k8s.io/v1":
        err(f"apiVersion {doc.get('apiVersion')!r} != apiextensions.k8s.io/v1")
    if doc.get("kind") != "CustomResourceDefinition":
        err(f"kind {doc.get('kind')!r} != CustomResourceDefinition")
    spec = doc.get("spec") or {}
    names = spec.get("names") or {}
    for field in ("kind", "plural", "singular", "listKind"):
        if not names.get(field):
            err(f"spec.names.{field} missing")
    expected_name = f"{names.get('plural', '?')}.{spec.get('group', '?')}"
    if (doc.get("metadata") or {}).get("name") != expected_name:
        err(
            f"metadata.name {(doc.get('metadata') or {}).get('name')!r}"
            f" != <plural>.<group> ({expected_name!r})"
        )
    if spec.get("scope") not in ("Cluster", "Namespaced"):
        err(f"spec.scope {spec.get('scope')!r} invalid")

    versions = spec.get("versions") or []
    if not versions:
        err("spec.versions empty")
    storage = [v for v in versions if v.get("storage")]
    if len(storage) != 1:
        err(f"exactly one storage version required, found {len(storage)}")
    for v in versions:
        vname = v.get("name", "?")
        schema = ((v.get("schema") or {}).get("openAPIV3Schema"))
        if not isinstance(schema, dict):
            err(f"version {vname}: schema.openAPIV3Schema missing")
            continue
        if schema.get("type") != "object":
            err(f"version {vname}: root schema type must be 'object'")
        for path, node in _walk_schema(schema, vname):
            if node.get("x-kubernetes-preserve-unknown-fields"):
                continue
            if "type" not in node:
                err(f"{path}: property missing 'type' (not structural)")
                continue
            if node["type"] == "array" and "items" not in node:
                err(f"{path}: array without 'items'")
        for col in v.get("additionalPrinterColumns") or []:
            if not col.get("jsonPath", "").startswith("."):
                err(f"version {vname}: printer column jsonPath"
                    f" {col.get('jsonPath')!r} must start with '.'")
    return errs


# ---------------------------------------------------------------------------
# instance validation (the subset of OpenAPI controller-gen emits)
# ---------------------------------------------------------------------------

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
}


def validate_instance(obj: Any, schema: Dict[str, Any], path: str) -> Errors:
    errs: Errors = []
    if schema.get("x-kubernetes-preserve-unknown-fields"):
        return errs
    t = schema.get("type")
    if t == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            return [f"{path}: expected integer, got {type(obj).__name__}"]
    elif t == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            return [f"{path}: expected number, got {type(obj).__name__}"]
    elif t in _TYPES and not isinstance(obj, _TYPES[t]):
        return [f"{path}: expected {t}, got {type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errs.append(f"{path}: {obj!r} not in enum {schema['enum']}")
    if t == "object":
        props = schema.get("properties") or {}
        for req in schema.get("required") or []:
            if req not in obj:
                errs.append(f"{path}: required field {req!r} missing")
        extra = schema.get("additionalProperties")
        for k, v in obj.items():
            if k in props:
                errs.extend(validate_instance(v, props[k], f"{path}.{k}"))
            elif isinstance(extra, dict):
                errs.extend(validate_instance(v, extra, f"{path}.{k}"))
            elif extra is False or (props and extra is None):
                # A real apiserver would silently PRUNE unknown fields;
                # flagging them here is deliberate lint strictness — a
                # pruned field in an example is a typo shipping to users.
                errs.append(f"{path}: unknown field {k!r}")
    elif t == "array":
        for i, item in enumerate(obj):
            errs.extend(
                validate_instance(item, schema.get("items") or {}, f"{path}[{i}]")
            )
    return errs


# ---------------------------------------------------------------------------
# install.yaml shape checks
# ---------------------------------------------------------------------------

_POD_TEMPLATE_KINDS = {"Deployment", "DaemonSet", "StatefulSet"}


def validate_install_doc(doc: Dict[str, Any], idx: int, source: str) -> Errors:
    errs: Errors = []
    where = f"{source}[doc {idx}]"
    for field in ("apiVersion", "kind"):
        if not doc.get(field):
            errs.append(f"{where}: {field} missing")
    if doc.get("kind") != "Namespace" and not (doc.get("metadata") or {}).get("name"):
        errs.append(f"{where}: metadata.name missing")
    if doc.get("kind") in _POD_TEMPLATE_KINDS:
        tmpl = (((doc.get("spec") or {}).get("template") or {}).get("spec") or {})
        if not tmpl.get("containers"):
            errs.append(f"{where}: {doc['kind']} without pod template containers")
    return errs


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def validate_all(crd_dir: str, install_yaml: str,
                 examples_dir: str = "examples") -> Errors:
    errs: Errors = []
    schemas_by_kind: Dict[str, Dict[str, Any]] = {}

    for path in sorted(glob.glob(os.path.join(crd_dir, "*.yaml"))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if not doc:
                    continue
                errs.extend(validate_crd(doc, os.path.basename(path)))
                names = (doc.get("spec") or {}).get("names") or {}
                for v in (doc.get("spec") or {}).get("versions") or []:
                    schema = (v.get("schema") or {}).get("openAPIV3Schema")
                    if names.get("kind") and schema:
                        schemas_by_kind[names["kind"]] = schema

    if os.path.isdir(examples_dir):
        for path in sorted(glob.glob(os.path.join(examples_dir, "*.yaml"))):
            with open(path) as f:
                for doc in yaml.safe_load_all(f):
                    if not doc:
                        continue
                    schema = schemas_by_kind.get(doc.get("kind", ""))
                    if schema is None:
                        continue
                    errs.extend(
                        validate_instance(doc, schema, os.path.basename(path))
                    )

    if os.path.exists(install_yaml):
        with open(install_yaml) as f:
            for i, doc in enumerate(yaml.safe_load_all(f)):
                if not doc:
                    continue
                errs.extend(
                    validate_install_doc(doc, i, os.path.basename(install_yaml))
                )
                if doc.get("kind") == "CustomResourceDefinition":
                    errs.extend(validate_crd(doc, f"{install_yaml}[doc {i}]"))
    else:
        errs.append(f"{install_yaml}: not found (run `python -m"
                    " tpu_composer_torch.api.packaging installer`)")
    return errs


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print("usage: validate_manifests <crd-dir> <install.yaml>")
        return 2
    errs = validate_all(args[0], args[1])
    for e in errs:
        print(f"INVALID  {e}")
    if errs:
        return 1
    print("manifests valid")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
