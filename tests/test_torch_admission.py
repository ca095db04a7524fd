"""The port's validating admission against the JAX package's
(tests/test_admission.py's twin): the ComposabilityRequest rules on
create and update (differentnode with a target, duplicate differentnode,
samenode conflicts by spec and by the allocated node, deletion-path
updates never denied), the coordinate injection into a Pod, and the CDI
env of a composed slice equal to ``status.slice``'s coordinates; with
H100 requests beside the TPU and loose-GPU ones.

Each scenario runs once per package (``run_both``) through the store's
admission chain (``register_validating_webhooks``) and returns every
step's outcome (the stored object's name, or the exception's type and
message). Tolerance: exact.
"""

from __future__ import annotations

import copy

import pytest
import torch

from tests.torch_operator import outcome, run_both, twin

torch.set_num_threads(1)

H100 = "nvidia-h100-sxm"


def _req(tw, name, type_="gpu", model="gpu-a100", size=1, policy="samenode",
         target=""):
    t = tw.types
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type=type_, model=model, size=size, allocation_policy=policy,
            target_node=target)))


def _guarded(tw):
    store = tw.store.Store()
    tw.validating.register_validating_webhooks(store)
    return store


def _name(obj):
    return obj.metadata.name


def _allocated(store, tw, name, node, key="gpu-x"):
    obj = store.get(tw.types.ComposabilityRequest, name)
    obj.status.resources[key] = tw.types.ResourceStatus(
        state="Online", node_name=node)
    store.update_status(obj)
    return store.get(tw.types.ComposabilityRequest, name)


def _steps_differentnode_with_target(tw, s, **m):
    return [outcome(lambda: _name(s.create(_req(
        tw, "a", policy="differentnode", target="worker-0", **m))))]


def _steps_duplicate_differentnode(tw, s, **m):
    return [outcome(lambda: _name(s.create(_req(
        tw, n, policy="differentnode", **m)))) for n in ("a", "b")]


def _steps_differentnode_different_model(tw, s, **m):
    return [outcome(lambda: _name(s.create(_req(
        tw, "a", policy="differentnode", **m)))),
        outcome(lambda: _name(s.create(_req(
            tw, "b", policy="differentnode", model="gpu-h100"))))]


def _steps_samenode_same_target(tw, s, **m):
    return [outcome(lambda: _name(s.create(_req(
        tw, n, target="worker-0", **m)))) for n in ("a", "b")]


def _steps_samenode_distinct_targets(tw, s, **m):
    return [outcome(lambda: _name(s.create(_req(
        tw, n, target=t, **m)))) for n, t in (("a", "worker-0"),
                                              ("b", "worker-1"))]


def _steps_update_validated_too(tw, s, **m):
    s.create(_req(tw, "a", policy="differentnode", **m))
    b = s.create(_req(tw, "b", policy="samenode", **m))
    b.spec.resource.allocation_policy = "differentnode"
    return [outcome(lambda: _name(s.update(b)))]


def _steps_samenode_conflict_via_allocated_node(tw, s, **m):
    s.create(_req(tw, "a", **m))
    _allocated(s, tw, "a", "worker-3")
    return [outcome(lambda: _name(s.create(_req(
        tw, "b", target="worker-3", **m))))]


def _steps_samenode_conflict_from_unpinned_incoming(tw, s, **m):
    s.create(_req(tw, "a", target="worker-3", **m))
    s.create(_req(tw, "b", **m))
    b = _allocated(s, tw, "b", "worker-3", "gpu-y")
    b.spec.resource.size = 2
    return [outcome(lambda: _name(s.update(b)))]


def _steps_samenode_unpinned_pair_distinct_nodes(tw, s, **m):
    s.create(_req(tw, "a", target="worker-3", **m))
    s.create(_req(tw, "b", **m))
    b = _allocated(s, tw, "b", "worker-4", "gpu-y")
    b.spec.resource.size = 2
    return [outcome(lambda: _name(s.update(b)))]


def _steps_terminating_finalizer_removal_not_wedged(tw, s, **m):
    a = s.create(_req(tw, "a", **m))
    a.metadata.finalizers = [tw.types.FINALIZER]
    s.update(a)
    _allocated(s, tw, "a", "worker-3")
    s.delete(tw.types.ComposabilityRequest, "a")
    out = [outcome(lambda: _name(s.create(_req(tw, "b", target="worker-3",
                                               **m))))]
    a = s.get(tw.types.ComposabilityRequest, "a")
    a.metadata.finalizers = []
    out.append(outcome(lambda: s.update(a) is not None))
    out.append(s.try_get(tw.types.ComposabilityRequest, "a") is None)
    return out


def _steps_terminating_other_does_not_block_newcomer(tw, s, **m):
    a = s.create(_req(tw, "a", target="worker-3", **m))
    a.metadata.finalizers = [tw.types.FINALIZER]
    s.update(a)
    s.delete(tw.types.ComposabilityRequest, "a")
    return [outcome(lambda: _name(s.create(_req(tw, "b", target="worker-3",
                                                **m))))]


CASES = {
    "differentnode_with_target": (_steps_differentnode_with_target,
                                  ["denied"]),
    "duplicate_differentnode": (_steps_duplicate_differentnode,
                                ["a", "denied"]),
    "differentnode_different_model": (_steps_differentnode_different_model,
                                      ["a", "b"]),
    "samenode_same_target": (_steps_samenode_same_target, ["a", "denied"]),
    "samenode_distinct_targets": (_steps_samenode_distinct_targets,
                                  ["a", "b"]),
    "update_validated_too": (_steps_update_validated_too, ["denied"]),
    "samenode_conflict_via_allocated_node": (
        _steps_samenode_conflict_via_allocated_node, ["denied"]),
    "samenode_conflict_from_unpinned_incoming": (
        _steps_samenode_conflict_from_unpinned_incoming, ["denied"]),
    "samenode_unpinned_pair_distinct_nodes": (
        _steps_samenode_unpinned_pair_distinct_nodes, ["b"]),
    "terminating_finalizer_removal_not_wedged": (
        _steps_terminating_finalizer_removal_not_wedged, ["b", True, True]),
    "terminating_other_does_not_block_newcomer": (
        _steps_terminating_other_does_not_block_newcomer, ["b"]),
}
MODELS = {"gpu": dict(type_="gpu", model="gpu-a100"),
          "tpu": dict(type_="tpu", model="tpu-v4"),
          "h100": dict(type_="gpu", model=H100)}


def _short(result):
    if isinstance(result, (tuple, list)) and result[0] == "raised":
        assert result[1] == "AdmissionDenied", result
        return "denied"
    return result


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_validating_webhook_matches_jax(case, kind):
    steps, want = CASES[case]

    def scenario(tw):
        return steps(tw, _guarded(tw), **MODELS[kind])

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert [_short(r) for r in port_out] == want


def _slice(tw, model_hosts=("worker-0", "worker-1"), topology="2x2x2",
           chips=4):
    return tw.types.SliceStatus(
        name="job-slice", topology=topology, num_hosts=len(model_hosts),
        chips_per_host=chips, worker_hostnames=list(model_hosts))


def test_slice_env_and_inject_pod_env_match_jax():
    def scenario(tw):
        pod = {"spec": {"containers": [
            {"name": "main", "env": [{"name": "TPU_WORKER_ID",
                                      "value": "keep"}]},
            {"name": "sidecar"}]}}
        env = tw.coordinates.slice_env(_slice(tw), 1, "tpu-v4")
        tw.coordinates.inject_pod_env(pod, _slice(tw), 1, "tpu-v4")
        return {"env": env, "pod": pod}

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    main = {e["name"]: e["value"]
            for e in port_out["pod"]["spec"]["containers"][0]["env"]}
    assert main["TPU_WORKER_ID"] == "keep"  # the user's value wins
    assert (port_out["pod"]["spec"]["nodeSelector"]
            ["kubernetes.io/hostname"] == "worker-1")


def test_h100_pod_gets_torchrun_env_and_node_pin():
    """An H100 slice's pod: every container gets ``slice_env``'s torchrun
    env (a user's own value wins), pinned to its worker's host."""
    tw = twin("tpu_composer_torch")
    status = _slice(tw, topology="8x2", chips=8)
    want = tw.coordinates.slice_env(status, 1, H100)
    assert want["PET_NODE_RANK"] == "1" and want["WORLD_SIZE"] == "16"
    pod = {"spec": {"containers": [
        {"name": "main", "env": [{"name": "MASTER_PORT", "value": "1234"}]},
        {"name": "sidecar"}]}}
    tw.coordinates.inject_pod_env(pod, status, 1, H100)
    main, side = ({e["name"]: e["value"] for e in c["env"]}
                  for c in pod["spec"]["containers"])
    assert side == want
    assert main == {**want, "MASTER_PORT": "1234"}
    assert pod["spec"]["nodeSelector"]["kubernetes.io/hostname"] == "worker-1"


def test_cdi_env_matches_final_allocation():
    """The env a composed slice's CDI specs carry equals its
    ``status.slice`` coordinates, on both packages."""

    def scenario(tw):
        store = tw.store.Store()
        for i in range(4):
            n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=f"worker-{i}"))
            n.status.tpu_slots = 4
            store.create(n)
        pool = tw.inmem.InMemoryPool()
        agent = tw.fake.FakeNodeAgent(pool=pool)
        req_rec = tw.req.ComposabilityRequestReconciler(store, pool)
        res_rec = tw.rc.ComposableResourceReconciler(store, pool, agent)
        store.create(_req(tw, "job", type_="tpu", model="tpu-v4", size=8))
        for _ in range(30):
            req_rec.reconcile("job")
            for c in store.list(tw.types.ComposableResource):
                res_rec.reconcile(c.metadata.name)
            if (store.get(tw.types.ComposabilityRequest, "job").status.state
                    == tw.types.REQUEST_STATE_RUNNING):
                break
        got = store.get(tw.types.ComposabilityRequest, "job")
        hosts = got.status.slice.worker_hostnames
        envs = [copy.deepcopy(agent.published_spec(
            host, f"job-slice-worker{w}").env) for w, host in enumerate(hosts)]
        for w, env in enumerate(envs):
            assert env["TPU_WORKER_ID"] == str(w)
            assert env["TPU_WORKER_HOSTNAMES"] == ",".join(hosts)
            assert env["TPU_TOPOLOGY"] == got.status.slice.topology
        return {"state": got.status.state, "envs": envs}

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out and port_out["state"] == "Running"
