"""Deployment packaging: consolidated installer + OLM-style bundle
(port of ``tpu_composer/api/packaging.py``).

Reference analogs (Makefile:275-329): ``build-installer`` (kustomize build →
dist/install.yaml) and the operator-sdk ``bundle`` target (CSV manifest +
metadata/annotations.yaml validated by operator-sdk). We generate both from
the flat ``deploy/`` tree without external tooling: the installer is the
kustomization's resource list concatenated in order; the bundle carries the
CRDs plus a minimal ClusterServiceVersion whose deployment spec is lifted
from deploy/manager.yaml.

The port reads the same ``deploy/`` tree as the JAX package and ships the
same documents, except that the two containers which start the operator
and the node agent run the port's binaries (``PORT_COMMANDS``) from the
port's image (``PORT_IMAGE``, built from ``Dockerfile.torch``): the CSV's
names and the package name stay the same.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List

import yaml

VERSION = "0.1.0"
PACKAGE = "tpu-composer"

#: The port's operator and node-agent image (``make docker-build-torch``).
PORT_IMAGE = "tpu-composer-torch:latest"

#: deploy/'s container commands that start the JAX package's binaries,
#: and the port's commands that take their place.
PORT_COMMANDS = {
    ("python", "-m", "tpu_composer"): ["python", "-m", "tpu_composer_torch"],
    ("python", "-m", "tpu_composer.agent.serve"): [
        "python", "-m", "tpu_composer_torch.agent.serve"],
}


def port_containers(doc: dict) -> dict:
    """``doc`` (a workload with a pod template) with each container whose
    command starts a JAX-package binary given the port's command and the
    port's image, in place."""
    pod = ((doc.get("spec") or {}).get("template") or {}).get("spec") or {}
    for container in pod.get("containers") or []:
        command = tuple(container.get("command") or ())
        if command in PORT_COMMANDS:
            container["command"] = list(PORT_COMMANDS[command])
            container["image"] = PORT_IMAGE
    return doc


def _kustomize_resources(deploy_dir: str) -> List[str]:
    with open(os.path.join(deploy_dir, "kustomization.yaml")) as f:
        kustomization = yaml.safe_load(f)
    return [os.path.join(deploy_dir, r) for r in kustomization.get("resources", [])]


def build_installer(deploy_dir: str, out_file: str) -> str:
    """Concatenate the kustomization's resources into one apply-able YAML
    (the `kustomize build > dist/install.yaml` analog)."""
    docs: List[dict] = []
    for path in _kustomize_resources(deploy_dir):
        with open(path) as f:
            docs.extend(port_containers(d) for d in yaml.safe_load_all(f) if d)
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        f.write("# Generated by `python -m tpu_composer_torch.api.packaging"
                " installer` — do not edit.\n")
        yaml.safe_dump_all(docs, f, sort_keys=False)
    return out_file


def _load_deployment(deploy_dir: str) -> dict:
    with open(os.path.join(deploy_dir, "manager.yaml")) as f:
        for doc in yaml.safe_load_all(f):
            if doc and doc.get("kind") == "Deployment":
                return port_containers(doc)
    raise ValueError(f"no Deployment found in {deploy_dir}/manager.yaml")


def build_bundle(deploy_dir: str, out_dir: str, version: str = VERSION) -> str:
    """Emit an OLM-shaped bundle: manifests/ (CSV + CRDs) and
    metadata/annotations.yaml."""
    manifests = os.path.join(out_dir, "manifests")
    metadata = os.path.join(out_dir, "metadata")
    # Regenerate from scratch: a stale manifest surviving a CRD rename would
    # ship a bundle that installs a deleted CRD.
    for sub in (manifests, metadata):
        shutil.rmtree(sub, ignore_errors=True)
        os.makedirs(sub)

    owned = []
    for path in _kustomize_resources(deploy_dir):
        if os.sep + "crds" + os.sep not in path:
            continue
        with open(path) as f:
            crd = yaml.safe_load(f)
        owned.append({
            "name": crd["metadata"]["name"],
            "kind": crd["spec"]["names"]["kind"],
            "version": crd["spec"]["versions"][0]["name"],
        })
        out = os.path.join(manifests, os.path.basename(path))
        with open(out, "w") as f:
            yaml.safe_dump(crd, f, sort_keys=False)

    deployment = _load_deployment(deploy_dir)
    csv = {
        "apiVersion": "operators.coreos.com/v1alpha1",
        "kind": "ClusterServiceVersion",
        "metadata": {
            "name": f"{PACKAGE}.v{version}",
            "annotations": {"description": "TPU-native composable resource operator"},
        },
        "spec": {
            "displayName": "TPU Composer",
            "version": version,
            "maturity": "alpha",
            "provider": {"name": PACKAGE},
            "customresourcedefinitions": {
                "owned": sorted(owned, key=lambda o: o["name"])
            },
            "install": {
                "strategy": "deployment",
                "spec": {
                    "deployments": [
                        {
                            "name": deployment["metadata"]["name"],
                            "spec": deployment["spec"],
                        }
                    ]
                },
            },
        },
    }
    with open(os.path.join(manifests, f"{PACKAGE}.clusterserviceversion.yaml"), "w") as f:
        yaml.safe_dump(csv, f, sort_keys=False)

    annotations = {
        "annotations": {
            "operators.operatorframework.io.bundle.mediatype.v1": "registry+v1",
            "operators.operatorframework.io.bundle.manifests.v1": "manifests/",
            "operators.operatorframework.io.bundle.metadata.v1": "metadata/",
            "operators.operatorframework.io.bundle.package.v1": PACKAGE,
            "operators.operatorframework.io.bundle.channels.v1": "alpha",
        }
    }
    with open(os.path.join(metadata, "annotations.yaml"), "w") as f:
        yaml.safe_dump(annotations, f, sort_keys=False)
    return out_dir


def build_catalog(
    bundle_dir: str,
    out_dir: str,
    bundle_image: str,
    version: str = VERSION,
) -> str:
    """Render a File-Based Catalog (FBC) from the bundle — the reference's
    `make catalog-build` (Makefile:275-329) uses opm to do this; the FBC
    schema (olm.package / olm.channel / olm.bundle JSON documents) is plain
    data, so we emit it directly plus a catalog.Dockerfile that serves it
    with opm's registry server."""
    os.makedirs(out_dir, exist_ok=True)
    csv_name = f"{PACKAGE}.v{version}"
    docs = [
        {
            "schema": "olm.package",
            "name": PACKAGE,
            "defaultChannel": "alpha",
        },
        {
            "schema": "olm.channel",
            "package": PACKAGE,
            "name": "alpha",
            "entries": [{"name": csv_name}],
        },
        {
            "schema": "olm.bundle",
            "name": csv_name,
            "package": PACKAGE,
            "image": bundle_image,
            "properties": [
                {
                    "type": "olm.package",
                    "value": {"packageName": PACKAGE, "version": version},
                }
            ],
        },
    ]
    with open(os.path.join(out_dir, "catalog.json"), "w") as f:
        for doc in docs:
            json.dump(doc, f, indent=2)
            f.write("\n")
    # The Dockerfile lives in the PARENT of the configs dir (opm's own
    # scaffolding convention): opm parses EVERY file under /configs as FBC,
    # so a Dockerfile inside the ADDed dir would break `opm serve`.
    dockerfile = os.path.join(
        os.path.dirname(os.path.abspath(out_dir)), "catalog.Dockerfile"
    )
    rel = os.path.basename(out_dir.rstrip("/"))
    with open(dockerfile, "w") as f:
        f.write(
            "# File-Based Catalog image (opm serve), reference Makefile:316-329\n"
            "FROM quay.io/operator-framework/opm:latest\n"
            "ENTRYPOINT [\"/bin/opm\"]\n"
            "CMD [\"serve\", \"/configs\", \"--cache-dir=/tmp/cache\"]\n"
            f"ADD {rel} /configs\n"
            "LABEL operators.operatorframework.io.index.configs.v1=/configs\n"
        )
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_composer_torch.api.packaging")
    p.add_argument("command", choices=["installer", "bundle", "catalog"])
    p.add_argument("--deploy-dir", default="deploy")
    p.add_argument("--bundle", default="bundle")
    p.add_argument("--bundle-image", default=f"{PACKAGE}-bundle:latest")
    p.add_argument("--out", default=None)
    p.add_argument("--version", default=VERSION)
    args = p.parse_args(argv)
    if args.command == "installer":
        out = build_installer(args.deploy_dir, args.out or "dist/install.yaml")
    elif args.command == "bundle":
        out = build_bundle(args.deploy_dir, args.out or "bundle", args.version)
    else:
        out = build_catalog(args.bundle, args.out or "dist/catalog",
                            args.bundle_image, args.version)
    print(out)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
