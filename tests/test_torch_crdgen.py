"""The port's CRD generator (tpu_composer_torch/api/crdgen.py) held against
the JAX package's (tests/test_cmd.py's TestCrdGen).

The two operators serve one API group from the same types, so the port's
``manifests()`` must equal the JAX package's exactly and the checked-in
``deploy/crds``: a CRD that differed would leave the shared tree stale
for one of them.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import pytest
import yaml

from tests.torch_operator import run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CRDS = os.path.join(REPO, "deploy", "crds")
FILES = [
    "tpu.composer.dev_composabilityrequests.yaml",
    "tpu.composer.dev_composableresources.yaml",
    "tpu.composer.dev_fleettelemetries.yaml",
    "tpu.composer.dev_nodemaintenances.yaml",
]


def _crdgen(tw):
    return importlib.import_module(f"{tw.root}.api.crdgen")


def _manifests(tw):
    return _crdgen(tw).manifests()


def _port_manifests():
    from tpu_composer_torch.api.crdgen import manifests

    return manifests()


def test_manifests_equal_the_jax_packages():
    jax_docs, port_docs = run_both(_manifests)
    assert sorted(port_docs) == FILES
    assert port_docs == jax_docs


@pytest.mark.parametrize("name", FILES)
def test_checked_in_manifests_are_current(name):
    """deploy/crds matches what the port's crdgen produces."""
    with open(os.path.join(CRDS, name)) as f:
        on_disk = yaml.safe_load(f)
    assert on_disk == _port_manifests()[name], f"{name} is stale"


def test_manifests_shape():
    docs = _port_manifests()

    def version(name):
        return docs[name]["spec"]["versions"][0]

    def schema(name):
        return version(name)["schema"]["openAPIV3Schema"]

    maint = schema("tpu.composer.dev_nodemaintenances.yaml")
    assert maint["properties"]["spec"]["required"] == ["node_name"]
    assert maint["properties"]["status"]["properties"]["state"]["enum"] == [
        "", "Cordoned", "Draining", "Drained", "Aborted"]
    fleet_spec = schema("tpu.composer.dev_fleettelemetries.yaml")[
        "properties"]["spec"]
    assert fleet_spec["required"] == ["identity"]
    assert fleet_spec["properties"]["payload"][
        "x-kubernetes-preserve-unknown-fields"] is True
    req = "tpu.composer.dev_composabilityrequests.yaml"
    assert docs[req]["spec"]["scope"] == "Cluster"
    assert version(req)["subresources"] == {"status": {}}
    resource = schema(req)["properties"]["spec"]["properties"]["resource"]
    assert resource["required"] == ["type", "model", "size"]
    assert resource["properties"]["type"]["enum"] == ["tpu", "gpu",
                                                      "cxlmemory"]


def _written(tw, tmp_path):
    out = os.path.join(str(tmp_path), tw.root)
    paths = _crdgen(tw).write_manifests(out)
    docs = {}
    for p in paths:
        with open(p) as f:
            docs[os.path.relpath(p, out)] = f.read()
    return docs


def test_write_manifests_writes_the_jax_packages_four_files(tmp_path):
    jax_files, port_files = run_both(_written, tmp_path)
    assert sorted(port_files) == FILES
    assert port_files == jax_files  # byte for byte
    for text in port_files.values():
        assert yaml.safe_load(text)["apiVersion"] == "apiextensions.k8s.io/v1"


def test_module_entry_point_writes_the_four_files(tmp_path):
    out = tmp_path / "crds"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_composer_torch.api.crdgen", str(out)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(out)) == FILES
    assert res.stdout.split() == [str(out / name) for name in FILES]
