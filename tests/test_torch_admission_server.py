"""The port's AdmissionReview server and TLS metrics port against the JAX
package's (tests/test_admission_server.py's twin, and
tests/test_runtime.py's secure-metrics case): the validate endpoint's
verdicts and messages, the pod-mutation JSONPatch (an H100 request's
patch carries the port's torchrun env), the passthroughs, HTTPS with a
self-signed cert (``openssl``), a stalled handshake that blocks no other
client, and the Manager's metrics port behind TLS and a bearer token.

Each scenario runs once per package (``run_both``), each package's
server over its own store, and returns the AdmissionReview responses
(patches decoded) and status codes. Tolerance: exact.
"""

from __future__ import annotations

import base64
import json
import socket
import ssl
import subprocess
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_operator import run_both, twin

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


def post(url, review, context=None):
    req = urllib.request.Request(
        url, data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10, context=context) as resp:
        return json.loads(resp.read())


def review_for(obj, uid="uid-1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "object": obj}}


def request_doc(name="req-a", type_="tpu", model="tpu-v4", size=4, **res):
    return {"apiVersion": "tpu.composer.dev/v1alpha1",
            "kind": "ComposabilityRequest", "metadata": {"name": name},
            "spec": {"resource": {"type": type_, "model": model, "size": size,
                                  **res}}}


def pod_doc(labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "worker-pod", "labels": labels or {}},
            "spec": {"containers": [{"name": "train", "image": "img",
                                     "env": [{"name": "KEEP",
                                              "value": "1"}]}]}}


def decoded(out):
    """The review's response with its JSONPatch decoded."""
    resp = dict(out["response"])
    if "patch" in resp:
        resp["patch"] = json.loads(base64.b64decode(resp["patch"]))
    return {"kind": out["kind"], "response": resp}


def _running(tw, store, name="train", hosts=("h0", "h1"), model="tpu-v4",
             topology=None, per_host=4):
    t = tw.types
    req = store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="gpu" if model == H100 else "tpu", model=model,
            size=per_host * len(hosts)))))
    req.status.slice = t.SliceStatus(
        name=f"{name}-slice",
        topology=topology or f"2x2x{len(hosts)}", num_hosts=len(hosts),
        chips_per_host=per_host, worker_hostnames=list(hosts))
    store.update_status(req)
    return req


def _served(scenario):
    def run(tw):
        store = tw.store.Store()
        srv = tw.admission_server.AdmissionServer(store)
        srv.start()
        try:
            return scenario(tw, store, f"http://{srv.address}")
        finally:
            srv.stop()
    jax_out, port_out = run_both(run)
    assert jax_out == port_out
    return port_out


def _validate(base, doc):
    return decoded(post(base + "/validate-tpu-composer-dev-v1alpha1-"
                               "composabilityrequest", review_for(doc)))


def _mutate(base, pod):
    return decoded(post(base + "/mutate-v1-pod", review_for(pod)))


def _existing(tw, store):
    t = tw.types
    store.create(t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name="existing"),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=2,
            allocation_policy="differentnode"))))


VALIDATE_CASES = {
    "valid_request_allowed": (lambda tw, s: request_doc(), True),
    "policy_violation_denied": (lambda tw, s: request_doc(
        allocation_policy="differentnode", target_node="n1"), False),
    "duplicate_against_store_denied": (lambda tw, s: (_existing(tw, s), request_doc(
        name="dupe", size=2, allocation_policy="differentnode"))[1], False),
    "spec_validation_errors_denied": (lambda tw, s: request_doc(size=-1),
                                      False),
    "wrong_kind_denied": (lambda tw, s: {
        "kind": "ComposableResource", "apiVersion": "tpu.composer.dev/v1alpha1",
        "metadata": {"name": "x"}, "spec": {"model": "m", "target_node": "n"}},
        False),
    "h100_request_allowed": (lambda tw, s: request_doc(
        type_="gpu", model=H100, size=8), True),
    "h100_policy_violation_denied": (lambda tw, s: request_doc(
        type_="gpu", model=H100, size=1, allocation_policy="differentnode",
        target_node="n1"), False),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_endpoint_matches_jax(case):
    make, allowed = VALIDATE_CASES[case]
    out = _served(lambda tw, store, base: _validate(base, make(tw, store)))
    assert out["kind"] == "AdmissionReview"
    assert out["response"]["allowed"] is allowed
    if not allowed:
        assert out["response"]["status"]["message"]


MUTATE_CASES = {
    "opted_in_pod_gets_patch": lambda tw, s: (_running(tw, s), pod_doc({
        tw.coordinates.LABEL_INJECT: "train",
        tw.coordinates.LABEL_WORKER_ID: "1"}))[1],
    "unlabeled_pod_passes_unpatched": lambda tw, s: pod_doc(),
    "pod_racing_allocation_admitted_unpatched": lambda tw, s: (
        s.create(tw.types.ComposabilityRequest(
            metadata=tw.meta.ObjectMeta(name="pending"),
            spec=tw.types.ComposabilityRequestSpec(
                resource=tw.types.ResourceDetails(
                    type="tpu", model="tpu-v4", size=4)))),
        pod_doc({tw.coordinates.LABEL_INJECT: "pending"}))[1],
    "bad_worker_id_denied": lambda tw, s: (_running(tw, s), pod_doc({
        tw.coordinates.LABEL_INJECT: "train",
        tw.coordinates.LABEL_WORKER_ID: "not-a-number"}))[1],
}


@pytest.mark.parametrize("case", sorted(MUTATE_CASES))
def test_mutate_endpoint_matches_jax(case):
    out = _served(lambda tw, store, base: _mutate(
        base, MUTATE_CASES[case](tw, store)))
    resp = out["response"]
    if case == "bad_worker_id_denied":
        assert resp["allowed"] is False
        return
    assert resp["allowed"] is True
    if case != "opted_in_pod_gets_patch":
        assert "patch" not in resp
        return
    (op,) = resp["patch"]
    assert (op["op"], op["path"]) == ("replace", "/spec")
    env = {e["name"]: e["value"] for e in op["value"]["containers"][0]["env"]}
    assert env["KEEP"] == "1" and env["TPU_WORKER_ID"] == "1"
    assert env["TPU_WORKER_HOSTNAMES"] == "h0,h1"
    assert op["value"]["nodeSelector"]["kubernetes.io/hostname"] == "h1"


def test_h100_pod_patch_equals_inject_pod_env():
    """An H100 request's labelled pod: the patch's spec is exactly the
    port's ``inject_pod_env`` of the pod for that worker."""
    tw = twin("tpu_composer_torch")
    store = tw.store.Store()
    req = _running(tw, store, hosts=("h0", "h1"), model=H100,
                   topology="8x2", per_host=8)
    srv = tw.admission_server.AdmissionServer(store)
    srv.start()
    try:
        pod = pod_doc({tw.coordinates.LABEL_INJECT: "train",
                       tw.coordinates.LABEL_WORKER_ID: "1"})
        out = _mutate(f"http://{srv.address}", pod)
    finally:
        srv.stop()
    want = tw.coordinates.inject_pod_env(pod, req.status.slice, 1, H100)
    (op,) = out["response"]["patch"]
    assert op["value"] == want["spec"]
    env = {e["name"]: e["value"] for e in op["value"]["containers"][0]["env"]}
    assert env["PET_NODE_RANK"] == "1" and env["MASTER_ADDR"] == "h0"
    assert not any(k.startswith("TPU_") for k in env)


@pytest.fixture(scope="module")
def tls(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "tls.crt", d / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


def _client_ctx(cert):
    ctx = ssl.create_default_context(cafile=cert)
    ctx.check_hostname = False
    return ctx


@pytest.mark.parametrize("stalled", [False, True],
                         ids=["round_trip", "stalled_handshake"])
def test_https_with_self_signed_cert(tls, stalled):
    cert, key = tls

    def scenario(tw):
        srv = tw.admission_server.AdmissionServer(
            tw.store.Store(), certfile=cert, keyfile=key)
        srv.start()
        try:
            host, port = srv.address.split(":")
            blocker = (socket.create_connection((host, int(port)))
                       if stalled else None)  # holds TCP, never TLS
            try:
                out = post(f"https://{srv.address}/validate-tpu-composer-dev-"
                           "v1alpha1-composabilityrequest",
                           review_for(request_doc()),
                           context=_client_ctx(cert))
            finally:
                if blocker is not None:
                    blocker.close()
            return {"tls": srv.tls, "out": out}
        finally:
            srv.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out["tls"] and port_out["out"]["response"]["allowed"] is True


def test_metrics_port_enforces_token_and_tls(tls, tmp_path):
    cert, key = tls

    def code(url, token=None, context=None):
        headers = {"Authorization": f"Bearer {token}"} if token else {}
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url, headers=headers), context=context) as resp:
                return resp.status, resp.read().decode().startswith("#")
        except urllib.error.HTTPError as e:
            return e.code, False

    def scenario(tw):
        token = tmp_path / f"{tw.root}.token"
        token.write_text("scrape-secret\n")
        mgr = tw.manager.Manager(
            health_addr="127.0.0.1:0", metrics_addr="127.0.0.1:0",
            metrics_certfile=cert, metrics_keyfile=key,
            metrics_token_file=str(token))
        mgr.start()
        try:
            ctx = _client_ctx(cert)
            base = f"https://127.0.0.1:{mgr.metrics_port}/metrics"
            out = [code(base, context=ctx),
                   code(base, "scrape-secret", ctx)]
            token.write_text("rotated\n")  # re-read per request
            out += [code(base, "scrape-secret", ctx),
                    code(base, "rotated", ctx),
                    code(f"https://127.0.0.1:{mgr.metrics_port}/other",
                         "rotated", ctx),
                    code(f"http://127.0.0.1:{mgr.health_port}/metrics")]
            return out
        finally:
            mgr.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert [c for c, _ in port_out] == [401, 200, 401, 200, 404, 404]


def test_metrics_token_without_cert_is_refused(tmp_path):
    """``--metrics-token-file`` without ``--metrics-cert`` exits at
    startup: a bearer token must not cross plain HTTP."""

    def scenario(tw):
        args = tw.cmd.build_parser().parse_args([
            "--health-probe-bind-address", "",
            "--metrics-bind-address", "127.0.0.1:0",
            "--metrics-token-file", str(tmp_path / "token")])
        try:
            tw.cmd.build_manager(args).stop()
        except SystemExit as e:
            return str(e)
        return "built"

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out and "--metrics-cert" in port_out
