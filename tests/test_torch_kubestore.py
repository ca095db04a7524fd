"""The port's ``KubeStore`` against the JAX package's
(tests/test_kubestore.py's twin, its ``cmd.main``-free cases, and
tests/test_lease_election.py's ``TestLeaseOnKubeStore``): typed CRUD,
conflicts, the status subresource, finalizer-gated deletes, label
selectors, core Nodes (``tpu.composer.dev/chips``), watches, kubeconfig
loading, the full operator on the cluster-shaped API, the watch-backed
read cache, the wire budget of one attach, transport errors, the
retry-once classification on both transports, reflector tombstones, the
hostile wire (410 compaction, severed and killed streams) and node GC
inside a watch gap, and Lease CAS over the wire.

Each scenario runs once per package (``run_both``): the package's
``KubeStore`` against the package's ``FakeApiServer`` (over the mux,
the default), and returns the objects, event sequences, error types and
wire counts the reference asserts on; the reference's invariants are
asserted on the way. Threaded scenarios return only what their outcome
fixes, never timings. Tolerance: exact.

Cross-package cases: the port's ``KubeStore`` against the JAX
``FakeApiServer``, and the JAX ``KubeStore`` against the port's, on both
transports, give the outcomes each package gives against its own.
"""

from __future__ import annotations

import contextlib
import threading
import time
import urllib.parse
import urllib.request

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)

GROUP, VERSION = "tpu.composer.dev", "v1alpha1"
CR_PREFIX = f"/apis/{GROUP}/{VERSION}/composabilityrequests"
RES_PREFIX = f"/apis/{GROUP}/{VERSION}/composableresources"
NODE_PREFIX = "/api/v1/nodes"


def wait_for(predicate, timeout=40.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@contextlib.contextmanager
def cluster(tw, server_tw=None, **kw):
    """``tw``'s KubeStore against ``server_tw``'s (default: the same
    package's) fake apiserver."""
    server_tw = server_tw or tw
    srv = server_tw.apiserver.FakeApiServer(
        server_tw.apiserver.operator_resources(GROUP, VERSION))
    srv.start()
    kw.setdefault("watch_reconnect_s", 0.05)
    ks = tw.kubestore.KubeStore(
        config=tw.kubestore.KubeConfig(host=srv.url), **kw)
    try:
        yield srv, ks
    finally:
        ks.close()
        srv.stop()


def core_node(tw, name, chips=4):
    return tw.apiserver.core_node_doc(
        name, chips=chips, chip_resource=tw.kubestore.CHIP_RESOURCE)


def request(tw, name, size=1, labels=None, finalizers=None):
    t = tw.types
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name, labels=labels or {},
                                    finalizers=finalizers or []),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=size)))


def non_watch_gets(apiserver, prefix):
    with apiserver.state.lock:
        log = list(apiserver.request_log)
    return [(m, p) for m, p in log
            if m == "GET" and p.split("?")[0].startswith(prefix)
            and "watch=true" not in p]


def _drain_events(q, into, budget_s=0.2):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        try:
            into.append(q.get(timeout=0.05))
        except Exception:
            pass


# ----------------------------------------------------------------------
# CRUD
# ----------------------------------------------------------------------
def create_get_roundtrip(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        created = ks.create(request(tw, "r1", size=4, labels={"a": "b"}))
        assert created.metadata.uid
        assert created.metadata.resource_version > 0
        got = ks.get(CR, "r1")
        assert got.spec.resource.size == 4 and got.metadata.labels == {"a": "b"}
        return got.to_dict()


def duplicate_create_is_already_exists(tw, server_tw=None):
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "dup"))
        with pytest.raises(tw.store.AlreadyExistsError) as e:
            ks.create(request(tw, "dup"))
        return type(e.value).__name__, str(e.value)


def stale_rv_update_conflicts(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        req = ks.create(request(tw, "c1"))
        fresh = ks.get(CR, "c1")
        fresh.spec.resource.size = 2
        ks.update(fresh)
        req.spec.resource.size = 8
        with pytest.raises(tw.store.ConflictError) as e:
            ks.update(req)
        return type(e.value).__name__, ks.get(CR, "c1").to_dict()


def status_subresource_is_isolated(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "s1"))
        obj = ks.get(CR, "s1")
        obj.status.state = "Running"
        ks.update_status(obj)
        obj2 = ks.get(CR, "s1")
        assert obj2.status.state == "Running"
        obj2.spec.resource.size = 2
        ks.update(obj2)
        obj3 = ks.get(CR, "s1")
        assert obj3.status.state == "Running"
        assert obj3.spec.resource.size == 2 and obj3.metadata.generation == 2
        return obj3.to_dict()


def finalizer_gated_delete(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "f1", finalizers=["tpu.composer.dev/fin"]))
        ks.delete(CR, "f1")
        terminating = ks.get(CR, "f1")
        assert terminating.being_deleted
        terminating.remove_finalizer("tpu.composer.dev/fin")
        ks.update(terminating)
        assert ks.try_get(CR, "f1") is None
        with pytest.raises(tw.store.NotFoundError):
            ks.get(CR, "f1")
        return terminating.being_deleted


def label_selector_list(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        for i, team in enumerate(["red", "blue", "red"]):
            ks.create(request(tw, f"l{i}", labels={"team": team}))
        reds = [o.metadata.name
                for o in ks.list(CR, label_selector={"team": "red"})]
        assert reds == ["l0", "l2"]
        return reds


def core_nodes_translate(tw, server_tw=None):
    with cluster(tw, server_tw) as (srv, ks):
        srv.put_object(NODE_PREFIX, core_node(tw, "worker-0", chips=4))
        srv.put_object(NODE_PREFIX, core_node(tw, "worker-1", chips=0))
        byname = {n.metadata.name: n for n in ks.list(tw.types.Node)}
        assert byname["worker-0"].status.tpu_slots == 4
        assert byname["worker-0"].status.ready
        assert byname["worker-0"].status.milli_cpu == 8000
        assert byname["worker-1"].status.tpu_slots == 0
        return {n: v.status.to_dict() for n, v in sorted(byname.items())}


def watch_streams_events(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        q = ks.watch("ComposabilityRequest")
        try:
            ks.create(request(tw, "w1"))
            evt = q.get(timeout=5)
            assert evt.type == "ADDED" and evt.obj.metadata.name == "w1"
            seen = [(evt.type, evt.obj.status.state)]
            obj = ks.get(CR, "w1")
            obj.status.state = "Running"
            ks.update_status(obj)
            deadline = time.monotonic() + 10
            while True:
                evt = q.get(timeout=max(0.1, deadline - time.monotonic()))
                assert evt.type == "MODIFIED" and evt.obj.metadata.name == "w1"
                if evt.obj.status.state == "Running":
                    break
            seen.append((evt.type, evt.obj.status.state))
            return seen
        finally:
            ks.stop_watch(q)


def kubeconfig_file_reaches_the_server(tw, tmp_path):
    """A kubeconfig (current context, token user) loads into a KubeConfig
    whose KubeStore reaches the server; the inline CA is materialized to a
    temporary file that ``cleanup`` removes."""
    import base64

    import yaml

    srv = tw.apiserver.FakeApiServer(
        tw.apiserver.operator_resources(GROUP, VERSION))
    srv.start()
    kc = tmp_path / f"kubeconfig-{tw.root}"
    kc.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "test",
        "contexts": [{"name": "test", "context": {"cluster": "c",
                                                  "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {
            "server": srv.url,
            "certificate-authority-data": base64.b64encode(
                b"-----BEGIN CERTIFICATE-----\n").decode()}}],
        "users": [{"name": "u", "user": {"token": "dummy"}}],
    }))
    cfg = tw.kubestore.KubeConfig.from_kubeconfig(str(kc))
    try:
        assert cfg.host == srv.url and cfg.token == "dummy"
        ca = cfg.ca_file
        assert ca and open(ca, "rb").read() == b"-----BEGIN CERTIFICATE-----\n"
        ks = tw.kubestore.KubeStore(
            config=tw.kubestore.KubeConfig(host=cfg.host, token=cfg.token))
        try:
            listed = ks.list(tw.types.ComposabilityRequest)
        finally:
            ks.close()
        assert listed == []
        cfg.cleanup()
        import os

        assert not os.path.exists(ca)
        return cfg.token, listed, cfg.temp_files
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# the operator on the cluster-shaped API
# ----------------------------------------------------------------------
@contextlib.contextmanager
def operator(tw):
    with cluster(tw) as (srv, ks):
        for i in range(4):
            srv.put_object(NODE_PREFIX, core_node(tw, f"worker-{i}", chips=4))
        pool = tw.inmem.InMemoryPool()
        agent = tw.fake.FakeNodeAgent(pool=pool)
        mgr = tw.manager.Manager(store=ks)
        mgr.add_controller(tw.req.ComposabilityRequestReconciler(
            ks, pool, timing=tw.req.RequestTiming(updating_poll=0.05,
                                                  cleaning_poll=0.05)))
        mgr.add_controller(tw.rc.ComposableResourceReconciler(
            ks, pool, agent, timing=tw.rc.ResourceTiming(
                attach_poll=0.05, visibility_poll=0.05, detach_poll=0.05,
                detach_fast=0.05, busy_poll=0.05)))
        mgr.add_runnable(tw.syncer.UpstreamSyncer(ks, pool, period=0.1,
                                                  grace=0.5))
        mgr.start(workers_per_controller=2)
        try:
            yield srv, ks, pool, agent, mgr
        finally:
            mgr.stop()


def _cr_doc(name, size, **resource):
    return {"apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ComposabilityRequest", "metadata": {"name": name},
            "spec": {"resource": dict(type="tpu", model="tpu-v4", size=size,
                                      **resource)}}


def _children(srv):
    with srv.state.lock:
        return [o for (p, _), o in srv.state.objects.items()
                if p == RES_PREFIX]


def kubectl_applied_request_reaches_running(tw):
    with operator(tw) as (srv, ks, pool, agent, mgr):
        srv.put_object(CR_PREFIX, _cr_doc("from-kubectl", 8))

        def running():
            obj = srv.get_object(CR_PREFIX, "from-kubectl")
            return obj and obj.get("status", {}).get("state") == "Running"

        assert wait_for(running)
        obj = srv.get_object(CR_PREFIX, "from-kubectl")
        n_resources = len(obj["status"]["resources"])
        assert n_resources >= 1 and _children(srv)
        n_children = len(_children(srv))
        req = urllib.request.Request(f"{srv.url}{CR_PREFIX}/from-kubectl",
                                     method="DELETE")
        urllib.request.urlopen(req)
        assert wait_for(lambda: srv.get_object(CR_PREFIX, "from-kubectl")
                        is None)
        assert wait_for(lambda: not _children(srv))
        assert not pool.get_resources()
        return {"state": obj["status"]["state"], "resources": n_resources,
                "children": n_children,
                "slice": obj["status"].get("slice", {}).get("topology")}


def attach_wire_ops_bounded(tw):
    with operator(tw) as (srv, ks, pool, agent, mgr):
        time.sleep(0.5)
        with srv.state.lock:
            srv.request_log.clear()
        srv.put_object(CR_PREFIX, _cr_doc("budget", 4))

        def running():
            obj = srv.get_object(CR_PREFIX, "budget")
            return obj and obj.get("status", {}).get("state") == "Running"

        assert wait_for(running)
        with srv.state.lock:
            log = list(srv.request_log)
        reads = [(m, p) for m, p in log if m == "GET" and "watch=true" not in p]
        writes = [(m, p) for m, p in log if m in ("POST", "PUT", "DELETE")]
        assert len(reads) <= 3, f"read side chatty again: {reads}"
        assert len(writes) <= 20, f"write side exploded: {writes}"
        return {"reads_bounded": len(reads) <= 3,
                "writes_bounded": len(writes) <= 20}


def node_deleted_inside_watch_gap_gcs_children(tw):
    with operator(tw) as (srv, ks, pool, agent, mgr):
        srv.put_object(CR_PREFIX, _cr_doc("gap-victim", 4,
                                          target_node="worker-1"))

        def running():
            obj = srv.get_object(CR_PREFIX, "gap-victim")
            return obj and obj.get("status", {}).get("state") == "Running"

        assert wait_for(running)
        unblock = srv.watch_blocker()
        srv.sever_watches()
        srv.delete_object(NODE_PREFIX, "worker-1")
        srv.compact()
        unblock()

        def no_children_on_node():
            return not [o for o in _children(srv)
                        if o.get("spec", {}).get("target_node") == "worker-1"]

        assert wait_for(no_children_on_node, timeout=40)
        assert wait_for(lambda: not [d for d in pool.get_resources()
                                     if d.node == "worker-1"], timeout=40)
        return {"gc": True}


# ----------------------------------------------------------------------
# the watch-backed read cache
# ----------------------------------------------------------------------
def cached_reads_are_wire_free(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "cached", size=2, labels={"tier": "a"}))
        for _ in range(20):
            assert ks.get(CR, "cached").spec.resource.size == 2
        for _ in range(5):
            assert len(ks.list(CR)) == 1
        assert len(ks.list(CR, {"tier": "a"})) == 1
        gets = non_watch_gets(srv, CR_PREFIX)
        assert len(gets) <= 2, f"cached reads leaked to the wire: {gets}"
        return len(gets) <= 2


def read_your_writes_through_cache(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "ryw"))
        fresh = ks.get(CR, "ryw")
        fresh.spec.resource.size = 4
        ks.update(fresh)
        size = ks.get(CR, "ryw").spec.resource.size
        assert size == 4
        return size


def watchers_share_one_connection(tw, server_tw=None):
    with cluster(tw, server_tw) as (srv, ks):
        qs = [ks.watch("ComposabilityRequest") for _ in range(3)]
        time.sleep(0.3)
        with srv.state.lock:
            watch_gets = [p for m, p in srv.request_log
                          if m == "GET" and p.startswith(CR_PREFIX)
                          and "watch=true" in p]
        assert len(watch_gets) == 1
        ks.create(request(tw, "fanout"))
        names = [q.get(timeout=5).obj.metadata.name for q in qs]
        assert names == ["fanout"] * 3
        return len(watch_gets), names


def relist_synthesizes_deleted(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        q = ks.watch("ComposabilityRequest")
        for name in ("keep", "ghost"):
            ks.create(request(tw, name))
        seen = set()
        while seen != {"keep", "ghost"}:
            seen.add(q.get(timeout=5).obj.metadata.name)
        with srv.state.lock:
            del srv.state.objects[(CR_PREFIX, "ghost")]
        ks._reflectors["ComposabilityRequest"]._watch._relist()

        def got_deleted():
            try:
                while True:
                    evt = q.get(timeout=0.2)
                    if evt.type == "DELETED" and \
                            evt.obj.metadata.name == "ghost":
                        return True
            except Exception:
                return False

        assert wait_for(got_deleted, timeout=5)
        assert wait_for(lambda: ks.try_get(CR, "ghost") is None, timeout=5)
        assert ks.try_get(CR, "keep") is not None
        return sorted(o.metadata.name for o in ks.list(CR))


# ----------------------------------------------------------------------
# transport errors and retry classification
# ----------------------------------------------------------------------
def unreachable_server_raises_store_error(tw):
    ks = tw.kubestore.KubeStore(
        config=tw.kubestore.KubeConfig(host="http://127.0.0.1:1"))
    try:
        with pytest.raises(tw.store.StoreError) as e:
            ks.list(tw.types.ComposabilityRequest)
        return type(e.value).__name__
    finally:
        ks.close()


def _resource(tw, name):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="tpu", model="tpu-v4",
                                      target_node="n0"))


@contextlib.contextmanager
def _proxied_store(tw, mux):
    srv = tw.apiserver.FakeApiServer(
        tw.apiserver.operator_resources(GROUP, VERSION))
    srv.start()
    host = urllib.parse.urlsplit(srv.url)
    proxy = tw.netchaos.ChaosProxy(host.hostname or "127.0.0.1",
                                   host.port or 80)
    ks = tw.kubestore.KubeStore(
        config=tw.kubestore.KubeConfig(host=proxy.url), cache_reads=False,
        wire_mux=mux, wire_ping_period=0.2, wire_ping_misses=1)
    try:
        yield srv, proxy, ks
    finally:
        ks.close()
        proxy.stop()
        srv.stop()


def _run_midflight(srv, proxy, fn, latency=0.5, cut_after=0.2, warmup=None):
    out: dict = {}

    def work():
        if warmup is not None:
            warmup()
        srv.latency_s = latency
        try:
            out["result"] = fn()
        except Exception as e:  # classified by the caller
            out["error"] = e

    t = threading.Thread(target=work, name="midflight")
    t.start()
    time.sleep(cut_after)
    proxy.cut()
    t.join(timeout=30)
    srv.latency_s = 0.0
    assert not t.is_alive(), "verb wedged past the cut"
    return out.get("result"), out.get("error")


def midflight_create_surfaces_store_error_not_blind_retry(tw, mux):
    R = tw.types.ComposableResource
    with _proxied_store(tw, mux) as (srv, proxy, ks):
        warmup = None
        if not mux:
            def warmup():
                with pytest.raises(tw.store.NotFoundError):
                    ks.get(R, "absent")
        _, err = _run_midflight(srv, proxy,
                                lambda: ks.create(_resource(tw, "ambig-c")),
                                warmup=warmup)
        assert isinstance(err, tw.store.StoreError), err
        assert not isinstance(err, tw.store.AlreadyExistsError)
        posts = [e for e in srv.request_log if e == ("POST", RES_PREFIX)]
        assert len(posts) == 1
        return type(err).__name__, len(posts)


def midflight_delete_surfaces_store_error_not_blind_retry(tw, mux):
    R = tw.types.ComposableResource
    with _proxied_store(tw, mux) as (srv, proxy, ks):
        ks.create(_resource(tw, "ambig-del"))
        warmup = (lambda: ks.get(R, "ambig-del")) if not mux else None
        _, err = _run_midflight(srv, proxy,
                                lambda: ks.delete(R, "ambig-del"),
                                warmup=warmup)
        assert isinstance(err, tw.store.StoreError), err
        assert not isinstance(err, tw.store.NotFoundError)
        dels = [e for e in srv.request_log
                if e == ("DELETE", f"{RES_PREFIX}/ambig-del")]
        assert len(dels) == 1
        return type(err).__name__, len(dels)


def midflight_read_is_retried(tw, mux):
    R = tw.types.ComposableResource
    with _proxied_store(tw, mux) as (srv, proxy, ks):
        ks.create(_resource(tw, "retry-read"))
        warmup = (lambda: ks.get(R, "retry-read")) if not mux else None
        result, err = _run_midflight(srv, proxy,
                                     lambda: ks.get(R, "retry-read"),
                                     warmup=warmup)
        assert err is None, f"idempotent GET not retried: {err}"
        assert result.name == "retry-read"
        return result.name


def midflight_cas_update_is_retried_never_store_error(tw, mux):
    R = tw.types.ComposableResource
    with _proxied_store(tw, mux) as (srv, proxy, ks):
        ks.create(_resource(tw, "retry-cas"))
        got = ks.get(R, "retry-cas")
        got.spec.target_node = "n1"
        warmup = (lambda: ks.get(R, "retry-cas")) if not mux else None
        _, err = _run_midflight(srv, proxy, lambda: ks.update(got),
                                warmup=warmup)
        assert err is None or isinstance(err, tw.store.ConflictError), err
        fresh = ks.get(R, "retry-cas")
        assert fresh.spec.target_node in ("n0", "n1")
        return err is None or isinstance(err, tw.store.ConflictError)


# ----------------------------------------------------------------------
# reflector tombstones
# ----------------------------------------------------------------------
def stale_write_response_cannot_resurrect_purged_object(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        assert ks.try_get(CR, "zombie") is None
        req = ks.create(request(tw, "zombie"))
        stale = req.deepcopy()
        ks.delete(CR, "zombie")
        assert wait_for(lambda: ks.try_get(CR, "zombie") is None)
        ks._reflectors["ComposabilityRequest"].note_write(stale)
        assert ks.try_get(CR, "zombie") is None
        return ks.try_get(CR, "zombie")


def tombstone_eviction_tracks_refresh_recency(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.try_get(CR, "warmup")
        refl = ks._reflectors["ComposabilityRequest"]
        with refl._lock:
            refl._tombstones.clear()
            refl._note_tombstone("hot", 1)
            for i in range(4096):
                refl._note_tombstone(f"cold-{i}", 10 + i)
            refl._note_tombstone("hot", 99999)
            refl._note_tombstone("trigger", 100000)
            assert "hot" in refl._tombstones
            assert refl._tombstones["hot"] == 99999
            refl._note_tombstone("hot", 5)
            assert refl._tombstones["hot"] == 99999
            return len(refl._tombstones), sorted(refl._tombstones)[:5]


def recreated_name_clears_its_tombstone(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        ks.create(request(tw, "phoenix"))
        ks.delete(CR, "phoenix")
        assert wait_for(lambda: ks.try_get(CR, "phoenix") is None)
        ks.create(request(tw, "phoenix"))
        assert wait_for(lambda: ks.try_get(CR, "phoenix") is not None)
        time.sleep(0.3)
        assert ks.try_get(CR, "phoenix") is not None
        return ks.get(CR, "phoenix").metadata.resource_version


# ----------------------------------------------------------------------
# the hostile wire
# ----------------------------------------------------------------------
def compaction_gap_recovers_via_wire_relist(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        q = ks.watch("ComposabilityRequest")
        for name in ("keep", "ghost", "phoenix"):
            ks.create(request(tw, name))
        assert wait_for(lambda: all(ks.try_get(CR, n) is not None
                                    for n in ("keep", "ghost", "phoenix")))
        old_uid = ks.get(CR, "phoenix").metadata.uid
        unblock = srv.watch_blocker()
        srv.sever_watches()
        srv.delete_object(CR_PREFIX, "ghost")
        srv.delete_object(CR_PREFIX, "phoenix")
        srv.put_object(CR_PREFIX, _cr_doc("phoenix", 1))
        srv.put_object(CR_PREFIX, _cr_doc("newborn", 1))
        srv.compact()
        lists_before = len(non_watch_gets(srv, CR_PREFIX))
        unblock()
        assert wait_for(lambda: ks.try_get(CR, "ghost") is None)
        assert wait_for(lambda: ks.try_get(CR, "newborn") is not None)
        assert wait_for(lambda: ks.try_get(CR, "phoenix") is not None
                        and ks.get(CR, "phoenix").metadata.uid != old_uid)
        assert ks.try_get(CR, "keep") is not None
        relisted = len(non_watch_gets(srv, CR_PREFIX)) > lists_before
        assert relisted
        events = []
        _drain_events(q, events, budget_s=0.5)
        assert [e for e in events
                if e.type == "DELETED" and e.obj.metadata.name == "ghost"]
        time.sleep(0.3)
        assert ks.try_get(CR, "ghost") is None
        return relisted, sorted(o.metadata.name for o in ks.list(CR))


def resume_within_horizon_replays_deletes_without_relist(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        q = ks.watch("ComposabilityRequest")
        for name in ("stays", "goes"):
            ks.create(request(tw, name))
        assert wait_for(lambda: all(ks.try_get(CR, n) is not None
                                    for n in ("stays", "goes")))
        unblock = srv.watch_blocker()
        srv.sever_watches()
        srv.delete_object(CR_PREFIX, "goes")
        lists_before = len(non_watch_gets(srv, CR_PREFIX))
        unblock()
        assert wait_for(lambda: ks.try_get(CR, "goes") is None)
        assert ks.try_get(CR, "stays") is not None
        events = []
        _drain_events(q, events, budget_s=0.5)
        assert any(e.type == "DELETED" and e.obj.metadata.name == "goes"
                   for e in events)
        lists_after = len(non_watch_gets(srv, CR_PREFIX))
        assert lists_after == lists_before
        return lists_after - lists_before


def repeated_socket_kills_under_churn_converge(tw, server_tw=None):
    CR = tw.types.ComposabilityRequest
    with cluster(tw, server_tw) as (srv, ks):
        for i in range(12):
            name = f"churn-{i}"
            ks.create(request(tw, name))
            if i % 3 == 0:
                srv.kill_watch_connections()
            if i % 2 == 0:
                ks.delete(CR, name)
            if i % 4 == 1:
                srv.kill_watch_connections()
        survivors = {f"churn-{i}" for i in range(12) if i % 2 == 1}

        def converged():
            return all((ks.try_get(CR, f"churn-{i}") is not None)
                       == (f"churn-{i}" in survivors) for i in range(12))

        assert wait_for(converged)
        time.sleep(0.3)
        assert converged()
        return sorted(o.metadata.name for o in ks.list(CR))


# ----------------------------------------------------------------------
# Lease CAS over the wire
# ----------------------------------------------------------------------
def lease_cas_over_the_wire(tw):
    prefix = ("/apis/coordination.k8s.io/v1/namespaces/tpu-composer-system"
              "/leases")
    srv = tw.apiserver.FakeApiServer({
        prefix: {"kind": "Lease", "apiVersion": "coordination.k8s.io/v1"}})
    srv.start()
    ks = tw.kubestore.KubeStore(config=tw.kubestore.KubeConfig(host=srv.url),
                                watch_reconnect_s=0.05)
    try:
        LeaseElector, Lease = tw.leases.LeaseElector, tw.lease.Lease
        a = LeaseElector(ks, identity="pod-a", lease_duration_s=1.0,
                         renew_period_s=0.2)
        b = LeaseElector(ks, identity="pod-b", lease_duration_s=1.0,
                         renew_period_s=0.2)
        assert a.try_acquire()
        assert not b.try_acquire()
        holders = [ks.get(Lease, a.name).spec.holder_identity]
        a.release()
        assert wait_for(b.try_acquire, timeout=3)
        holders.append(ks.get(Lease, b.name).spec.holder_identity)
        b.release()
        assert holders == ["pod-a", "pod-b"]
        return holders, a.name
    finally:
        ks.close()
        srv.stop()


SCENARIOS = [
    create_get_roundtrip,
    duplicate_create_is_already_exists,
    stale_rv_update_conflicts,
    status_subresource_is_isolated,
    finalizer_gated_delete,
    label_selector_list,
    core_nodes_translate,
    watch_streams_events,
    kubectl_applied_request_reaches_running,
    cached_reads_are_wire_free,
    read_your_writes_through_cache,
    watchers_share_one_connection,
    relist_synthesizes_deleted,
    attach_wire_ops_bounded,
    unreachable_server_raises_store_error,
    stale_write_response_cannot_resurrect_purged_object,
    tombstone_eviction_tracks_refresh_recency,
    recreated_name_clears_its_tombstone,
    compaction_gap_recovers_via_wire_relist,
    resume_within_horizon_replays_deletes_without_relist,
    repeated_socket_kills_under_churn_converge,
    node_deleted_inside_watch_gap_gcs_children,
    lease_cas_over_the_wire,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("mux", [True, False])
@pytest.mark.parametrize("scenario", [
    midflight_create_surfaces_store_error_not_blind_retry,
    midflight_delete_surfaces_store_error_not_blind_retry,
    midflight_read_is_retried,
    midflight_cas_update_is_retried_never_store_error,
], ids=lambda f: f.__name__)
def test_retry_classification_matches_jax(scenario, mux):
    jax_out, port_out = run_both(scenario, mux)
    assert port_out == jax_out


def test_kubeconfig_file_reaches_the_server(tmp_path):
    jax_out, port_out = run_both(kubeconfig_file_reaches_the_server, tmp_path)
    assert port_out == jax_out


# ----------------------------------------------------------------------
# Cross-package: each KubeStore against the other package's apiserver
# ----------------------------------------------------------------------
CROSS = [
    create_get_roundtrip,
    stale_rv_update_conflicts,
    status_subresource_is_isolated,
    finalizer_gated_delete,
    core_nodes_translate,
    watch_streams_events,
    cached_reads_are_wire_free,
    relist_synthesizes_deleted,
    resume_within_horizon_replays_deletes_without_relist,
]


@pytest.mark.parametrize("scenario", CROSS, ids=lambda f: f.__name__)
def test_each_store_against_the_other_package_server(scenario):
    """The port's KubeStore against the JAX apiserver and the JAX
    KubeStore against the port's give what the JAX KubeStore gets from
    the JAX apiserver (uids and timestamps masked)."""
    from tests.torch_operator import mask, seeded_uuids

    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    outs = []
    for client, server in ((jax, jax), (port, jax), (jax, port)):
        with seeded_uuids(0):
            outs.append(mask(scenario(client, server)))
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]


@pytest.mark.parametrize("mux", [True, False])
def test_the_port_operator_over_the_jax_apiserver(mux):
    """The port's full request path (both reconcilers on its KubeStore)
    takes an H100 request to Running on the JAX package's apiserver, on
    either transport, and the mux carried the traffic when on."""
    port, jax = twin(PORT_ROOT), twin(JAX_ROOT)
    srv = jax.apiserver.FakeApiServer(
        jax.apiserver.operator_resources(GROUP, VERSION))
    srv.start()
    srv.put_object(NODE_PREFIX, jax.apiserver.core_node_doc(
        "gpu-0", chips=8, chip_resource=port.kubestore.CHIP_RESOURCE))
    ks = port.kubestore.KubeStore(
        config=port.kubestore.KubeConfig(host=srv.url),
        watch_reconnect_s=0.05, wire_mux=mux)
    pool = port.inmem.InMemoryPool(chips={"nvidia-h100-sxm": 8})
    mgr = port.manager.Manager(store=ks)
    mgr.add_controller(port.req.ComposabilityRequestReconciler(
        ks, pool, timing=port.req.RequestTiming(updating_poll=0.05,
                                                cleaning_poll=0.05)))
    mgr.add_controller(port.rc.ComposableResourceReconciler(
        ks, pool, port.fake.FakeNodeAgent(pool=pool),
        timing=port.rc.ResourceTiming(attach_poll=0.05,
                                      visibility_poll=0.05)))
    mgr.start(workers_per_controller=2)
    try:
        srv.put_object(CR_PREFIX, {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ComposabilityRequest", "metadata": {"name": "h100"},
            "spec": {"resource": {"type": "gpu", "model": "nvidia-h100-sxm",
                                  "size": 2}}})

        def running():
            obj = srv.get_object(CR_PREFIX, "h100")
            return obj and obj.get("status", {}).get("state") == "Running"

        assert wait_for(running), srv.get_object(CR_PREFIX, "h100")
        status = srv.get_object(CR_PREFIX, "h100")["status"]
        assert status["slice"]["worker_hostnames"] == ["gpu-0"]
        assert (status["slice"]["num_hosts"],
                status["slice"]["chips_per_host"]) == (1, 2)
        assert (ks._mux is not None) is mux and not ks._mux_failed
    finally:
        mgr.stop()
        ks.close()
        srv.stop()
