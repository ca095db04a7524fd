"""The port's admission webhooks in the wire loop against the JAX
package's (tests/test_webhook_e2e.py's twin): each package's
``FakeApiServer`` calls its package's ``AdmissionServer`` over HTTPS
(self-signed cert, ``openssl``) as a Validating/MutatingWebhookConfiguration
would, on every create: denials fail the API call with the rule's text,
and JSONPatches land in the stored Pod; with an H100 pod beside the TPU
one.

Each scenario runs once per package (``run_both``) and returns the API's
answer (status code and message, or the stored object, masked).
Tolerance: exact.
"""

from __future__ import annotations

import json
import subprocess
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)

GROUP, VERSION = "tpu.composer.dev", "v1alpha1"
CR_PREFIX = f"/apis/{GROUP}/{VERSION}/composabilityrequests"
POD_PREFIX = "/api/v1/pods"
H100 = "nvidia-h100-sxm"


@pytest.fixture(scope="module")
def tls_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("webhook-tls")
    cert, key = d / "tls.crt", d / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


def _world(tls_files, scenario):
    """``scenario(tw, store, srv)`` with ``tw``'s TLS webhook registered
    with ``tw``'s fake apiserver, on each package."""
    cert, key = tls_files

    def run(tw):
        store = tw.store.Store()
        server_mod = tw.admission_server
        webhook = server_mod.AdmissionServer(store, bind="127.0.0.1:0",
                                             certfile=cert, keyfile=key)
        webhook.start()
        base = f"https://{webhook.address}"
        srv = tw.apiserver.FakeApiServer({
            CR_PREFIX: {"kind": "ComposabilityRequest",
                        "apiVersion": f"{GROUP}/{VERSION}"},
            POD_PREFIX: {"kind": "Pod", "apiVersion": "v1"}})
        srv.webhooks = [
            {"prefix": CR_PREFIX, "url": base + server_mod.VALIDATE_PATH,
             "operations": {"CREATE", "UPDATE"}},
            {"prefix": POD_PREFIX, "url": base + server_mod.MUTATE_PATH,
             "operations": {"CREATE"}}]
        srv.start()
        try:
            return scenario(tw, store, srv)
        finally:
            srv.stop()
            webhook.stop()

    jax_out, port_out = run_both(run)
    assert jax_out == port_out
    return port_out


def api_post(srv, prefix, obj):
    req = urllib.request.Request(
        f"{srv.url}{prefix}", data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        return 201, json.loads(urllib.request.urlopen(req).read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["message"]


def cr_doc(name, **res):
    spec = {"type": "tpu", "model": "tpu-v4", "size": 4}
    spec.update(res)
    return {"apiVersion": f"{GROUP}/{VERSION}", "kind": "ComposabilityRequest",
            "metadata": {"name": name}, "spec": {"resource": spec}}


def _existing(tw, store, **res):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="existing"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(**res))))


def _unpinned_doc(tw, store):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="pinned"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="gpu", model="gpu-a100", size=1, allocation_policy="samenode",
            target_node="worker-3"))))
    unpinned = t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="unpinned"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="gpu", model="gpu-a100", size=1,
            allocation_policy="samenode")))
    unpinned.status.resources["gpu-y"] = t.ResourceStatus(
        state="Online", node_name="worker-3")
    return unpinned.to_dict()


CR_CASES = {
    "valid_request_admitted_and_stored": (
        lambda tw, store: cr_doc("ok"), 201, None),
    "invalid_request_rejected_with_denial_message": (
        lambda tw, store: cr_doc("bad", allocation_policy="differentnode",
                                 target_node="worker-0"), 403,
        "differentnode"),
    "duplicate_policy_rejected_via_store": (
        lambda tw, store: (_existing(
            tw, store, type="tpu", model="tpu-v4", size=4,
            allocation_policy="differentnode"),
            cr_doc("dup", allocation_policy="differentnode"))[1], 403,
        "existing"),
    "unpinned_incoming_with_allocated_node_denied": (
        _unpinned_doc, 403, "already targets worker-3"),
    "h100_request_admitted_and_stored": (
        lambda tw, store: cr_doc("h100", type="gpu", model=H100, size=1),
        201, None),
    "h100_invalid_request_rejected": (
        lambda tw, store: cr_doc("h100-bad", type="gpu", model=H100, size=1,
                                 allocation_policy="differentnode",
                                 target_node="worker-0"), 403,
        "differentnode"),
}


@pytest.mark.parametrize("case", sorted(CR_CASES))
def test_validating_over_the_wire_matches_jax(tls_files, case):
    make, want_code, text = CR_CASES[case]

    def scenario(tw, store, srv):
        doc = make(tw, store)
        code, body = api_post(srv, CR_PREFIX, doc)
        stored = srv.get_object(CR_PREFIX, doc["metadata"]["name"])
        return {"code": code,
                "message": body if code != 201 else None,
                "uid": bool(body["metadata"]["uid"]) if code == 201 else None,
                "stored": stored is not None}

    out = _world(tls_files, scenario)
    assert out["code"] == want_code
    assert out["stored"] is (want_code == 201)
    if text:
        assert text in out["message"]


def _slice_request(tw, store, name, model, size, topology, hosts, per_host):
    t = tw.types
    req = t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="gpu" if model == H100 else "tpu", model=model, size=size)))
    req.status.slice = t.SliceStatus(
        name=f"{name}-slice", topology=topology, num_hosts=len(hosts),
        chips_per_host=per_host, worker_hostnames=list(hosts))
    store.create(req)
    return req


def _pod(tw, name, labels=None, image="jax:latest"):
    meta = {"name": name}
    if labels is not None:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"containers": [{"name": "main", "image": image}]}}


def test_tpu_pod_gets_coordinates_injected(tls_files):
    def scenario(tw, store, srv):
        _slice_request(tw, store, "train", "tpu-v5e", 8, "2x4", ["host-a"], 8)
        api_post(srv, POD_PREFIX, _pod(tw, "worker-0", {
            tw.coordinates.LABEL_INJECT: "train",
            tw.coordinates.LABEL_WORKER_ID: "0"}))
        stored = srv.get_object(POD_PREFIX, "worker-0")
        return {e["name"]: e["value"]
                for e in stored["spec"]["containers"][0].get("env", [])}

    env = _world(tls_files, scenario)
    assert env["TPU_WORKER_ID"] == "0"
    assert env["TPU_WORKER_HOSTNAMES"] == "host-a"
    assert "2x4" in json.dumps(env)


def test_unlabeled_pod_stored_untouched(tls_files):
    def scenario(tw, store, srv):
        api_post(srv, POD_PREFIX, _pod(tw, "plain", image="busybox"))
        return srv.get_object(POD_PREFIX, "plain")["spec"]

    spec = _world(tls_files, scenario)
    assert "env" not in spec["containers"][0]


def test_h100_pod_gets_inject_pod_env_over_the_wire(tls_files):
    """An H100 request's pod, created through the port's apiserver,
    is stored with exactly the port's ``inject_pod_env`` spec: torchrun's
    env and the worker's node pin."""
    cert, key = tls_files
    from tests.torch_operator import twin

    tw = twin("tpu_composer_torch")
    store = tw.store.Store()
    req = _slice_request(tw, store, "train", H100, 16, "8x2",
                         ["host-a", "host-b"], 8)
    webhook = tw.admission_server.AdmissionServer(
        store, bind="127.0.0.1:0", certfile=cert, keyfile=key)
    webhook.start()
    srv = tw.apiserver.FakeApiServer({POD_PREFIX: {"kind": "Pod",
                                                   "apiVersion": "v1"}})
    srv.webhooks = [{"prefix": POD_PREFIX,
                     "url": f"https://{webhook.address}"
                            f"{tw.admission_server.MUTATE_PATH}",
                     "operations": {"CREATE"}}]
    srv.start()
    try:
        pod = _pod(tw, "worker-1", {tw.coordinates.LABEL_INJECT: "train",
                                    tw.coordinates.LABEL_WORKER_ID: "1"},
                   image="torch:latest")
        api_post(srv, POD_PREFIX, pod)
        stored = srv.get_object(POD_PREFIX, "worker-1")
    finally:
        srv.stop()
        webhook.stop()
    want = tw.coordinates.inject_pod_env(pod, req.status.slice, 1, H100)
    assert stored["spec"] == want["spec"]
    env = {e["name"]: e["value"] for e in stored["spec"]["containers"][0]["env"]}
    assert env == tw.coordinates.slice_env(req.status.slice, 1, H100)
    assert stored["spec"]["nodeSelector"]["kubernetes.io/hostname"] == "host-b"
