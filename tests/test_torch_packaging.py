"""The port's packaging (tpu_composer_torch/api/{packaging,
validate_manifests}.py) held against the JAX package's
(tests/test_packaging.py).

Both read the one ``deploy/`` tree. The port's installer and bundle hold
the JAX package's documents except the two containers that start the
operator and the node agent, which run the port's binaries from the
port's image (``Dockerfile.torch``): their command and image differ, and
nothing else. The
shared examples and the port's H100 example decode and pass the port's
admission; ``validate_all`` finds nothing in the real artefacts and the
same errors as the JAX copy in the broken ones. Every path is under the
repo root, whatever the working directory.
"""

from __future__ import annotations

import copy
import glob
import importlib
import json
import os

import pytest
import yaml

from tests.torch_operator import PORT_ROOT, run_both, twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy")
CRDS = os.path.join(DEPLOY, "crds")
H100_EXAMPLES = os.path.join(REPO, "tpu_composer_torch", "examples")
H100_EXAMPLE = os.path.join(H100_EXAMPLES, "composabilityrequest-h100.yaml")
SHARED_EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml")))

JAX_IMAGE = "tpu-composer:latest"
PORT_IMAGE = "tpu-composer-torch:latest"

#: (kind, container) -> (the JAX package's command and image, the port's).
REWRITTEN = {
    ("Deployment", "manager"): (
        {"command": ["python", "-m", "tpu_composer"], "image": JAX_IMAGE},
        {"command": ["python", "-m", "tpu_composer_torch"],
         "image": PORT_IMAGE}),
    ("DaemonSet", "agent"): (
        {"command": ["python", "-m", "tpu_composer.agent.serve"],
         "image": JAX_IMAGE},
        {"command": ["python", "-m", "tpu_composer_torch.agent.serve"],
         "image": PORT_IMAGE}),
}

PORT = twin(PORT_ROOT)


def _api(tw, name):
    return importlib.import_module(f"{tw.root}.api.{name}")


def _load_all(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _commands(doc):
    pod = doc["spec"]["template"]["spec"]
    return {c["name"]: c.get("command") for c in pod["containers"]}


def _rewritten(doc):
    """The rewritten fields of each container: {name: {command, image}}."""
    pod = doc["spec"]["template"]["spec"]
    return {c["name"]: {k: c.get(k) for k in ("command", "image")}
            for c in pod["containers"]}


def _with_jax_containers(doc):
    """``doc`` with the port's rewritten containers (command and image
    both the port's) put back to the JAX package's; counts what it put
    back."""
    doc = copy.deepcopy(doc)
    put_back = 0
    pod = ((doc.get("spec") or {}).get("template") or {}).get("spec") or {}
    for c in pod.get("containers") or []:
        jax_fields, port_fields = REWRITTEN.get((doc["kind"], c["name"]),
                                                (None, None))
        if port_fields is not None and all(
                c.get(k) == v for k, v in port_fields.items()):
            c.update(copy.deepcopy(jax_fields))
            put_back += 1
    return doc, put_back


# ---------------------------------------------------------------------------
# examples
# ---------------------------------------------------------------------------


def _admit(tw, path):
    """Decode ``path``, validate its spec and create it through a store
    with the validating webhooks (and the node a pinned example names);
    returns the stored object's spec."""
    with open(path) as f:
        doc = yaml.safe_load(f)
    obj = tw.scheme.default_scheme().decode(doc)
    assert isinstance(obj, tw.types.ComposabilityRequest)
    obj.spec.validate()
    store = tw.store.Store()
    node = tw.types.Node(metadata=tw.types.ObjectMeta(name="tpu-host-3"))
    node.status.tpu_slots = 8
    store.create(node)
    tw.validating.register_validating_webhooks(store)
    store.create(obj)
    return tw.scheme.default_scheme().encode(
        store.get(tw.types.ComposabilityRequest, obj.metadata.name))["spec"]


@pytest.mark.parametrize("path", SHARED_EXAMPLES, ids=os.path.basename)
def test_shared_example_passes_both_admissions(path):
    jax_spec, port_spec = run_both(_admit, path)
    assert port_spec == jax_spec


def test_h100_example_passes_the_ports_admission():
    spec = _admit(PORT, H100_EXAMPLE)
    assert spec["resource"]["type"] == "gpu"
    assert spec["resource"]["model"] == "nvidia-h100-sxm"
    assert spec["resource"]["size"] == 1


def test_examples_cover_tpu_gpu_and_the_h100():
    types, models = set(), set()
    for path in SHARED_EXAMPLES + [H100_EXAMPLE]:
        with open(path) as f:
            resource = yaml.safe_load(f)["spec"]["resource"]
        types.add(resource["type"])
        models.add(resource["model"])
    assert types == {"tpu", "gpu"}
    assert "nvidia-h100-sxm" in models


# ---------------------------------------------------------------------------
# the installer and the bundle
# ---------------------------------------------------------------------------


def _installer(tw, tmp_path):
    out = os.path.join(str(tmp_path), tw.root, "install.yaml")
    return _load_all(_api(tw, "packaging").build_installer(DEPLOY, out))


def test_installer_differs_only_in_the_two_commands(tmp_path):
    jax_docs, port_docs = run_both(_installer, tmp_path)
    assert len(port_docs) == len(jax_docs)
    kinds = [d["kind"] for d in port_docs]
    assert kinds.count("CustomResourceDefinition") == 4
    for expected in ("Deployment", "DaemonSet", "ClusterRole",
                     "ValidatingWebhookConfiguration"):
        assert expected in kinds, f"missing {expected}: {kinds}"
    rewritten = []
    for jax_doc, port_doc in zip(jax_docs, port_docs):
        restored, n = _with_jax_containers(port_doc)
        assert restored == jax_doc
        if n:
            rewritten.append((port_doc["kind"], port_doc["metadata"]["name"]))
    assert sorted(k for k, _ in rewritten) == ["DaemonSet", "Deployment"]
    for (kind, container), (jax_fields, port_fields) in REWRITTEN.items():
        jax_w = next(d for d in jax_docs if d["kind"] == kind)
        port_w = next(d for d in port_docs if d["kind"] == kind)
        assert _rewritten(jax_w)[container] == jax_fields
        assert _rewritten(port_w)[container] == port_fields
    assert _api(PORT, "packaging").PORT_IMAGE == PORT_IMAGE


def _bundle(tw, tmp_path):
    out = _api(tw, "packaging").build_bundle(
        DEPLOY, os.path.join(str(tmp_path), tw.root, "bundle"))
    files = {}
    for r, _, fs in os.walk(out):
        for f in fs:
            path = os.path.join(r, f)
            files[os.path.relpath(path, out)] = _load_all(path)
    return files


def test_bundle_differs_only_in_the_managers_command(tmp_path):
    jax_files, port_files = run_both(_bundle, tmp_path)
    assert set(port_files) == set(jax_files)
    assert "metadata/annotations.yaml" in port_files
    csv_name = "manifests/tpu-composer.clusterserviceversion.yaml"
    assert sum(1 for f in port_files if "tpu.composer.dev_" in f) == 4
    for name in port_files:
        if name != csv_name:
            assert port_files[name] == jax_files[name], name
    [jax_csv], [port_csv] = jax_files[csv_name], port_files[csv_name]
    owned = port_csv["spec"]["customresourcedefinitions"]["owned"]
    assert {o["kind"] for o in owned} == {
        "ComposabilityRequest", "ComposableResource",
        "FleetTelemetry", "NodeMaintenance",
    }
    [dep] = port_csv["spec"]["install"]["spec"]["deployments"]
    assert _rewritten(dep)["manager"] == REWRITTEN[
        ("Deployment", "manager")][1]
    restored, n = _with_jax_containers(
        {"kind": "Deployment", "spec": copy.deepcopy(dep["spec"])})
    assert n == 1  # the bundle carries no DaemonSet
    port_csv["spec"]["install"]["spec"]["deployments"][0]["spec"] = (
        restored["spec"])
    assert port_csv == jax_csv
    ann = port_files["metadata/annotations.yaml"][0]["annotations"]
    assert ann["operators.operatorframework.io.bundle.package.v1"] == (
        "tpu-composer")


def test_catalog_renders_fbc(tmp_path):
    packaging = _api(PORT, "packaging")
    bundle = tmp_path / "bundle"
    packaging.build_bundle(DEPLOY, str(bundle))
    out = tmp_path / "catalog"
    packaging.build_catalog(str(bundle), str(out), "reg.example/bundle:v1")
    text = (out / "catalog.json").read_text()
    decoder = json.JSONDecoder()
    docs, idx = [], 0
    while idx < len(text):
        while idx < len(text) and text[idx].isspace():
            idx += 1
        if idx >= len(text):
            break
        doc, idx = decoder.raw_decode(text, idx)
        docs.append(doc)
    assert {d["schema"] for d in docs} == {
        "olm.package", "olm.channel", "olm.bundle"}
    bundle_doc = next(d for d in docs if d["schema"] == "olm.bundle")
    assert bundle_doc["image"] == "reg.example/bundle:v1"
    dockerfile = tmp_path / "catalog.Dockerfile"  # parent of configs dir
    assert dockerfile.exists()
    assert not (out / "catalog.Dockerfile").exists()
    assert "ADD catalog /configs" in dockerfile.read_text()


def test_packaging_cli_writes_the_installer(tmp_path, capsys):
    out = str(tmp_path / "dist" / "install.yaml")
    assert _api(PORT, "packaging").main(
        ["installer", "--deploy-dir", DEPLOY, "--out", out]) == 0
    assert capsys.readouterr().out.strip() == out
    deployment = next(d for d in _load_all(out) if d["kind"] == "Deployment")
    assert _commands(deployment)["manager"] == ["python", "-m",
                                                "tpu_composer_torch"]
    assert _rewritten(deployment)["manager"]["image"] == PORT_IMAGE


# ---------------------------------------------------------------------------
# manifest validation
# ---------------------------------------------------------------------------


def test_real_artifacts_validate(tmp_path):
    install = str(tmp_path / "install.yaml")
    _api(PORT, "packaging").build_installer(DEPLOY, install)
    validate_all = _api(PORT, "validate_manifests").validate_all
    assert validate_all(CRDS, install,
                        examples_dir=os.path.join(REPO, "examples")) == []
    assert validate_all(CRDS, install, examples_dir=H100_EXAMPLES) == []


def _crd(name):
    with open(os.path.join(CRDS, name)) as f:
        return yaml.safe_load(f)


def _broken_structure(tw):
    crd = _crd("tpu.composer.dev_composabilityrequests.yaml")
    del crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]["type"]
    return _api(tw, "validate_manifests").validate_crd(crd, "broken.yaml")


def _two_storage_versions(tw):
    crd = _crd("tpu.composer.dev_composableresources.yaml")
    v = dict(crd["spec"]["versions"][0])
    v["name"] = "v1alpha2"
    crd["spec"]["versions"].append(v)  # second storage=true
    return _api(tw, "validate_manifests").validate_crd(crd, "broken.yaml")


BAD_EXAMPLES = {
    "typo": ("    type: tpu\n    model: tpu-v4\n"
             "    size: 4\n    allocation_polcy: samenode\n",
             "allocation_polcy"),
    "enum": ("    type: quantum\n    model: tpu-v4\n    size: 4\n", "enum"),
}


def _bad_example(tw, tmp_path, case):
    base = os.path.join(str(tmp_path), tw.root)
    ex = os.path.join(base, "examples")
    os.makedirs(ex)
    with open(os.path.join(ex, "bad.yaml"), "w") as f:
        f.write("apiVersion: tpu.composer.dev/v1alpha1\n"
                "kind: ComposabilityRequest\n"
                "metadata:\n  name: bad\n"
                "spec:\n  resource:\n" + BAD_EXAMPLES[case][0])
    install = os.path.join(base, "install.yaml")
    _api(tw, "packaging").build_installer(DEPLOY, install)
    return _api(tw, "validate_manifests").validate_all(
        CRDS, install, examples_dir=ex)


@pytest.mark.parametrize("case,needle", [
    ("structure", "missing 'type'"),
    ("storage", "exactly one storage version"),
    ("typo", "allocation_polcy"),
    ("enum", "enum"),
])
def test_broken_artifacts_give_the_jax_packages_errors(tmp_path, case,
                                                       needle):
    if case == "structure":
        jax_errs, port_errs = run_both(_broken_structure)
    elif case == "storage":
        jax_errs, port_errs = run_both(_two_storage_versions)
    else:
        jax_errs, port_errs = run_both(_bad_example, tmp_path, case)
    assert port_errs == jax_errs
    assert any(needle in e for e in port_errs), port_errs


def test_validate_cli_exit_codes(tmp_path, capsys, monkeypatch):
    main = _api(PORT, "validate_manifests").main
    install = str(tmp_path / "install.yaml")
    _api(PORT, "packaging").build_installer(DEPLOY, install)
    monkeypatch.chdir(tmp_path)  # no examples/ here: CRDs and installer
    assert main([CRDS, install]) == 0
    assert main([CRDS, str(tmp_path / "missing.yaml")]) == 1
    assert main([CRDS]) == 2
    out = capsys.readouterr().out
    assert "manifests valid" in out and "INVALID" in out
