"""The port's ``tpuc-mux/1`` framed transport against the JAX package's
(tests/test_wiremux.py's twin): the frame codec (dribbled reads,
truncation, the length cap, garbage payloads, a seeded fuzz corpus), one
live socket doing everything at once against the package's fake
apiserver (pipelined verbs, CAS conflicts, watch pushes, resume cursors,
the 410 persona, denied watches), the kill switch and the HTTP fallback,
the event-driven loops the mux enables (the syncer's doorbell, the
inventory publisher), liveness (pings, the send deadline, watch death,
flap damping), ``ChurnDriver`` on the mux, the TLS wire and the send
safety net.

Each scenario runs once per package (``run_both``), each against its own
package's ``FakeApiServer`` (and ``ChaosProxy``), and returns the status
codes, names, event sequences and counters the reference asserts on;
the reference's invariants, wall-clock bounds included, are asserted on
the way. Tolerance: exact.

Cross-package cases: the codec encodes the same bytes and reads the same
outcomes on a seeded fuzz corpus in both packages, and each package's
``MuxClient`` drives the other package's apiserver over the mux.
"""

from __future__ import annotations

import contextlib
import io
import json
import random
import shutil
import socket
import ssl
import subprocess
import threading
import time
import urllib.parse

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)

GROUP, VERSION = "tpu.composer.dev", "v1alpha1"
CR_PREFIX = f"/apis/{GROUP}/{VERSION}/composabilityrequests"
RES_PREFIX = f"/apis/{GROUP}/{VERSION}/composableresources"


def cr_doc(name: str, count: int = 0) -> dict:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "ComposabilityRequest",
        "metadata": {"name": name},
        "spec": {"resource": {"type": "tpu", "model": "tpu-v4", "size": 1},
                 "count": count},
    }


@contextlib.contextmanager
def served(tw):
    server = tw.apiserver.FakeApiServer(
        tw.apiserver.operator_resources(GROUP, VERSION))
    server.start()
    try:
        yield server
    finally:
        server.stop()


@contextlib.contextmanager
def proxied(tw, srv):
    host = urllib.parse.urlsplit(srv.url)
    proxy = tw.netchaos.ChaosProxy(host.hostname or "127.0.0.1",
                                   host.port or 80)
    try:
        yield proxy
    finally:
        proxy.stop()


def _resource(tw, name, node="n0"):
    t = tw.types
    return t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="tpu", model="tpu-v4",
                                      target_node=node),
        status=t.ComposableResourceStatus())


def _kube(tw, url, **kw):
    ks = tw.kubestore
    return ks.KubeStore(config=ks.KubeConfig(host=url), **kw)


# ----------------------------------------------------------------------
# frame codec
# ----------------------------------------------------------------------
class _Dribble:
    """File-like that returns at most ``chunk`` bytes per read."""

    def __init__(self, data: bytes, chunk: int = 1) -> None:
        self._fp = io.BytesIO(data)
        self._chunk = chunk

    def read(self, n: int) -> bytes:
        return self._fp.read(min(n, self._chunk))


def _raises(fn, exc, match=None):
    with pytest.raises(exc, match=match) as e:
        fn()
    return str(e.value)


def roundtrip_one_byte_reads_across_frame_boundaries(tw):
    wm = tw.wiremux
    frames = [
        {"id": 1, "method": "GET", "path": "/x", "body": None},
        {"watch": 2, "event": {"type": "ADDED", "object": {"a": "b" * 300}}},
        {"id": 3, "code": 409, "body": {"reason": "Conflict"}},
    ]
    wire = b"".join(wm.encode_frame(f) for f in frames)
    fp = _Dribble(wire, chunk=1)
    assert [wm.read_frame(fp) for _ in frames] == frames
    assert wm.read_frame(fp) is None
    return wire.hex()


def eof_mid_payload_is_a_truncation_error(tw):
    wm = tw.wiremux
    wire = wm.encode_frame({"id": 1, "code": 200, "body": {}})
    return _raises(lambda: wm.read_frame(_Dribble(wire[:-3], chunk=5)),
                   wm.MuxError)


def eof_mid_length_prefix_is_a_truncation_error(tw):
    wm = tw.wiremux
    wire = wm.encode_frame({"id": 1})
    return _raises(lambda: wm.read_frame(_Dribble(wire[:2])), wm.MuxError)


def eof_between_header_and_body(tw):
    wm = tw.wiremux
    wire = wm.encode_frame({"id": 1})
    return _raises(lambda: wm.read_frame(_Dribble(wire[:4], chunk=4)),
                   wm.MuxError)


def corrupt_length_prefix_hits_the_cap(tw):
    wm = tw.wiremux
    huge = (wm.MAX_FRAME + 1).to_bytes(4, "big") + b"x"
    return _raises(lambda: wm.read_frame(_Dribble(huge, chunk=64)),
                   wm.MuxError, "cap")


def garbage_payload_is_a_mux_error_not_a_leak(tw):
    wm = tw.wiremux
    wire = len(b"\xff\xfe{not json").to_bytes(4, "big") + b"\xff\xfe{not json"
    a = _raises(lambda: wm.read_frame(_Dribble(wire, chunk=3)), wm.MuxError,
                "corrupt frame payload")
    wire = len(b"[1,2]").to_bytes(4, "big") + b"[1,2]"
    b = _raises(lambda: wm.read_frame(_Dribble(wire, chunk=5)), wm.MuxError,
                "not an object")
    return [a, b]


FUZZ_SEED = 0x7C20


def _fuzz_wire(tw, rng: random.Random) -> bytes:
    frames = []
    for _ in range(rng.randint(1, 3)):
        frames.append({
            "id": rng.randint(1, 1 << 30),
            "method": rng.choice(["GET", "POST", "PUT", "DELETE"]),
            "path": "/x/" + "p" * rng.randint(0, 200),
            "body": {"k": "v" * rng.randint(0, 500)},
        })
    return b"".join(tw.wiremux.encode_frame(f) for f in frames)


def _fuzz_mutate(rng: random.Random, wire: bytes) -> bytes:
    mode = rng.randrange(5)
    if mode == 0:
        return wire
    if mode == 1 and len(wire) > 1:
        return wire[: rng.randrange(1, len(wire))]
    if mode == 2:
        i = rng.randrange(len(wire))
        return wire[:i] + bytes([wire[i] ^ (1 << rng.randrange(8))]) \
            + wire[i + 1:]
    if mode == 3:
        return rng.randbytes(4) + wire[4:]
    return wire + rng.randbytes(rng.randint(1, 64))


def seeded_fuzz_terminates_with_frames_none_or_mux_error(tw, seed=FUZZ_SEED):
    """Per input of the seeded corpus: its bytes' digest and what the
    reader returned, frame by frame, until EOF or a MuxError."""
    import hashlib

    wm = tw.wiremux
    rng = random.Random(seed)
    outcomes = {"frames": 0, "eof": 0, "error": 0}
    trace = []
    for _ in range(250):
        data = _fuzz_mutate(rng, _fuzz_wire(tw, rng))
        fp = _Dribble(data, chunk=rng.choice([1, 2, 3, 7, 64, 4096]))
        steps = [hashlib.sha256(data).hexdigest()[:16]]
        for _ in range(16):
            try:
                frame = wm.read_frame(fp)
            except wm.MuxError as e:
                outcomes["error"] += 1
                steps.append(("error", str(e)))
                break
            except MemoryError as e:  # pragma: no cover - the cap failed
                raise AssertionError(
                    "codec tried to allocate past the frame cap") from e
            if frame is None:
                outcomes["eof"] += 1
                steps.append(("eof",))
                break
            assert isinstance(frame, dict)
            outcomes["frames"] += 1
            steps.append(("frame", frame.get("id")))
        else:
            raise AssertionError("reader never terminated on fuzz input")
        trace.append(steps)
    assert all(outcomes.values()), outcomes
    return {"outcomes": outcomes, "trace": trace}


def oversized_prefix_never_reads_the_claimed_size(tw):
    wm = tw.wiremux
    rng = random.Random(FUZZ_SEED + 1)

    class CountingFp:
        def __init__(self, data: bytes) -> None:
            self._fp = io.BytesIO(data)
            self.asked = 0

        def read(self, n: int) -> bytes:
            self.asked = max(self.asked, n)
            return self._fp.read(n)

    rejected = 0
    for _ in range(50):
        size = rng.randint(wm.MAX_FRAME + 1, 1 << 40)
        fp = CountingFp(size.to_bytes(5, "big")[-4:] + b"x" * 16)
        size32 = int.from_bytes(size.to_bytes(5, "big")[-4:], "big")
        if size32 <= wm.MAX_FRAME:
            continue
        with pytest.raises(wm.MuxError, match="cap"):
            wm.read_frame(fp)
        assert fp.asked <= wm._LEN.size
        rejected += 1
    return rejected


# ----------------------------------------------------------------------
# one socket, everything at once
# ----------------------------------------------------------------------
def pipelined_verbs_and_cas_conflict(tw):
    with served(tw) as srv:
        client = tw.wiremux.MuxClient(srv.url)
        try:
            code, created = client.request("POST", CR_PREFIX,
                                           body=cr_doc("mux-a"))
            assert code == 201
            rv = created["metadata"]["resourceVersion"]
            winner = dict(created)
            winner["spec"] = dict(winner["spec"], count=1)
            c2, _ = client.request("PUT", f"{CR_PREFIX}/mux-a", body=winner)
            assert c2 == 200
            c3, status = client.request("PUT", f"{CR_PREFIX}/mux-a",
                                        body=winner)
            assert c3 == 409 and status.get("reason") == "Conflict"
            assert ("POST", CR_PREFIX) in srv.request_log
            assert ("PUT", f"{CR_PREFIX}/mux-a") in srv.request_log
            assert rv
            return [code, c2, c3, status, list(srv.request_log)]
        finally:
            client.close()


def injected_latency_does_not_serialize_pipelined_verbs(tw):
    with served(tw) as srv:
        client = tw.wiremux.MuxClient(srv.url)
        srv.latency_s = 0.1
        try:
            n = 6
            errs, codes = [], []

            def post(i):
                try:
                    code, _ = client.request("POST", CR_PREFIX,
                                             body=cr_doc(f"pipe-{i}"))
                    codes.append(code)
                except Exception as e:  # surfaced below
                    errs.append(e)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            wall = time.perf_counter() - t0
            assert not errs, errs
            assert wall < 0.45, f"{n} pipelined verbs took {wall:.2f}s"
            return sorted(codes)
        finally:
            srv.latency_s = 0.0
            client.close()


def watch_push_interleaved_with_verbs_on_one_socket(tw):
    with served(tw) as srv:
        client = tw.wiremux.MuxClient(srv.url)
        try:
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                 timeout=5)
            names = [f"inter-{i}" for i in range(6)]
            for n in names:
                assert client.request("POST", CR_PREFIX,
                                      body=cr_doc(n))[0] == 201
            assert client.request(
                "DELETE", f"{CR_PREFIX}/{names[0]}")[0] == 200
            seen, rvs = [], []
            for line in watch:
                ev = json.loads(line)
                seen.append((ev["type"], ev["object"]["metadata"]["name"]))
                rvs.append(int(ev["object"]["metadata"]["resourceVersion"]))
                if ev["type"] == "DELETED":
                    break
            assert seen == [("ADDED", n) for n in names] + \
                [("DELETED", names[0])]
            assert rvs == sorted(rvs), f"pushes reordered: {rvs}"
            watch.shutdown()
            return seen, rvs
        finally:
            client.close()


def mid_watch_reconnect_resumes_from_cursor(tw):
    with served(tw) as srv:
        client = tw.wiremux.MuxClient(srv.url)
        try:
            srv.put_object(CR_PREFIX, cr_doc("resume-a"))
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                 timeout=5)
            ev = json.loads(next(watch))
            assert ev["type"] == "ADDED"
            cursor = int(ev["object"]["metadata"]["resourceVersion"])
        finally:
            client.close()
        srv.put_object(CR_PREFIX, cr_doc("resume-b"))
        client2 = tw.wiremux.MuxClient(srv.url)
        try:
            watch2 = client2.watch(
                f"{CR_PREFIX}?watch=true&resourceVersion={cursor}", timeout=5)
            ev = json.loads(next(watch2))
            got = (ev["type"], ev["object"]["metadata"]["name"])
            assert got == ("ADDED", "resume-b")
            watch2.shutdown()
            return cursor, got
        finally:
            client2.close()


def compacted_resume_cursor_gets_410_error_event(tw):
    with served(tw) as srv:
        client = tw.wiremux.MuxClient(srv.url)
        try:
            for i in range(4):
                srv.put_object(CR_PREFIX, cr_doc(f"gone-{i}"))
            srv.compact()
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=1",
                                 timeout=5)
            ev = json.loads(next(watch))
            assert ev["type"] == "ERROR" and ev["object"]["code"] == 410
            with pytest.raises(StopIteration):
                next(watch)
            return ev
        finally:
            client.close()


def watch_open_denied_maps_to_http_error(tw):
    with served(tw) as srv:
        srv.fail_hooks.append(
            lambda method, path: (503, "ServiceUnavailable", "boom")
            if "watch=true" in path else None)
        client = tw.wiremux.MuxClient(srv.url)
        try:
            with pytest.raises(tw.wiremux.MuxHTTPError) as ei:
                client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                             timeout=5)
            assert ei.value.code == 503
            return ei.value.code, ei.value.body
        finally:
            srv.fail_hooks.clear()
            client.close()


# ----------------------------------------------------------------------
# kill switch + fallback
# ----------------------------------------------------------------------
def store_semantics_identical_both_transports(tw, mux):
    t = tw.types
    with served(tw) as srv:
        store = _kube(tw, srv.url, cache_reads=False, wire_mux=mux)
        try:
            store.create(_resource(tw, "ks-par"))
            got = store.get(t.ComposableResource, "ks-par")
            assert got.spec.model == "tpu-v4"
            got.spec.target_node = "n1"
            store.update(got)
            with pytest.raises(tw.store.ConflictError):
                store.update(got)
            fresh = store.get(t.ComposableResource, "ks-par")
            assert fresh.spec.target_node == "n1"
            names = [x.name for x in store.list(t.ComposableResource)]
            assert names == ["ks-par"]
            store.delete(t.ComposableResource, "ks-par")
            with pytest.raises(tw.store.NotFoundError):
                store.get(t.ComposableResource, "ks-par")
            assert (store._mux is not None) is mux
            return fresh.to_dict(), names, list(srv.request_log)
        finally:
            store.close()


def env_kill_switch_disables_mux(tw, monkeypatch):
    monkeypatch.setenv("TPUC_WIRE_MUX", "0")
    with served(tw) as srv:
        store = _kube(tw, srv.url, cache_reads=False)
        try:
            store.create(_resource(tw, "ks-env"))
            name = store.get(tw.types.ComposableResource, "ks-env").name
            assert name == "ks-env" and store._mux is None
            return name
        finally:
            store.close()


def server_decline_falls_back_to_http_for_good(tw, monkeypatch):
    wm = tw.wiremux

    def declined(self):
        raise wm.MuxUnsupported("server declined mux upgrade")

    monkeypatch.setattr(wm.MuxClient, "_handshake", declined)
    with served(tw) as srv:
        store = _kube(tw, srv.url, cache_reads=False, wire_mux=True)
        try:
            store.create(_resource(tw, "ks-decl"))
            name = store.get(tw.types.ComposableResource, "ks-decl").name
            assert name == "ks-decl" and store._mux_failed
            assert tw.metrics.wire_mux_active.total() == 0.0
            return name, store._mux_failed
        finally:
            store.close()


def watch_cache_runs_on_mux(tw):
    R = tw.types.ComposableResource
    with served(tw) as srv:
        store = _kube(tw, srv.url, cache_reads=True, watch_reconnect_s=0.05,
                      wire_mux=True)
        try:
            store.create(_resource(tw, "wc-a"))
            assert store.get(R, "wc-a").name == "wc-a"
            before = len(srv.request_log)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if store.get(R, "wc-a") is not None:
                    break
                time.sleep(0.01)
            for _ in range(20):
                store.get(R, "wc-a")
            assert len(srv.request_log) == before
            srv.put_object(RES_PREFIX, {
                "apiVersion": f"{GROUP}/{VERSION}",
                "kind": "ComposableResource",
                "metadata": {"name": "wc-b"},
                "spec": {"type": "tpu", "model": "tpu-v4",
                         "targetNode": "n1"},
            })
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if any(r.name == "wc-b" for r in store.list(R)):
                    break
                time.sleep(0.01)
            else:
                raise AssertionError(
                    "server-side create never reached the mux-fed cache")
            return sorted(r.name for r in store.list(R))
        finally:
            store.close()


# ----------------------------------------------------------------------
# event-driven control loops
# ----------------------------------------------------------------------
class _StubSession:
    """Just the registration surface the runnables wire into."""

    def __init__(self, healthy: bool = True) -> None:
        self._healthy = healthy
        self.event_handlers = []
        self.gap_handlers = []
        self.state_handlers = []

    def on_event(self, h):
        self.event_handlers.append(h)

    def on_gap(self, h):
        self.gap_handlers.append(h)

    def on_state(self, h):
        self.state_handlers.append(h)

    def healthy(self):
        return self._healthy

    def fire(self, evt):
        for h in self.event_handlers:
            h(evt)


def syncer_relist_demotion_tracks_session_health(tw):
    Syncer = tw.syncer.UpstreamSyncer
    session = _StubSession(healthy=True)
    syncer = Syncer(tw.store.Store(), fabric=None, period=2.0,
                    session=session, fallback_multiplier=20.0)
    out = [syncer.effective_period()]
    session._healthy = False
    out.append(syncer.effective_period())
    out.append(Syncer(tw.store.Store(), fabric=None,
                      period=2.0).effective_period())
    assert out == [40.0, 2.0, 2.0]
    return out


def syncer_wakes_on_inventory_events_only(tw):
    ev = tw.fevents
    session = _StubSession()
    syncer = tw.syncer.UpstreamSyncer(tw.store.Store(), fabric=None,
                                      period=60.0, session=session)
    session.fire(ev.FabricEvent(seq=1, type=ev.EVENT_HEALTH))
    out = [syncer._wake.is_set()]
    session.fire(ev.FabricEvent(seq=2, type=ev.EVENT_INVENTORY))
    out.append(syncer._wake.is_set())
    syncer._wake.clear()
    for h in session.gap_handlers:
        h()
    out.append(syncer._wake.is_set())
    assert out == [False, True, True]
    return out


def doorbell_bursts_coalesce_to_base_period(tw):
    ev = tw.fevents
    session = _StubSession(healthy=True)
    syncer = tw.syncer.UpstreamSyncer(tw.store.Store(), fabric=None,
                                      period=0.3, session=session,
                                      fallback_multiplier=100.0)
    passes: list = []
    syncer.sync_once = lambda: passes.append(time.monotonic())
    stop = threading.Event()
    t = threading.Thread(target=syncer, args=(stop,),
                         name="coalesce-syncer", daemon=True)
    t.start()
    end = time.monotonic() + 0.9
    while time.monotonic() < end:
        session.fire(ev.FabricEvent(seq=1, type=ev.EVENT_INVENTORY))
        time.sleep(0.01)
    time.sleep(0.1)
    stop.set()
    syncer._wake.set()
    t.join(5.0)
    assert not t.is_alive()
    assert 1 <= len(passes) <= 5, passes
    gaps = [b - a for a, b in zip(passes, passes[1:])]
    assert all(g >= 0.25 for g in gaps), gaps
    return {"coalesced": 1 <= len(passes) <= 5}


def _inventory_owner(tw, name, ids, pending=False):
    t = tw.types
    owner = t.ComposableResource(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposableResourceSpec(type="tpu", model="tpu-v4",
                                      target_node="inv-node"))
    owner.status.state = t.RESOURCE_STATE_ONLINE
    owner.status.device_ids = list(ids)
    if pending:
        owner.status.pending_op = t.PendingOp(verb="add", nonce="n1")
    return owner


def inventory_publisher_repairs_vanished_publication(tw):
    pubm, FabricDevice = tw.publisher, tw.provider.FabricDevice
    store = tw.store.Store()
    store.create(_inventory_owner(tw, "inv-owner", ["dev-0", "dev-1"]))

    class Fabric:
        def get_resources(self):
            return [FabricDevice(device_id=f"dev-{i}", node="inv-node",
                                 model="tpu-v4", slice_name="g0",
                                 resource_name="inv-owner")
                    for i in range(2)]

    pub = pubm.InventoryPublisher(store, Fabric(), period=60.0)
    out = [pub.reconcile_once(), pub.repairs]
    assert out == [1, 1]
    dp = pubm.DevicePublisher(store)
    out.append(dp.devices_invisible("inv-node", ["dev-0", "dev-1"]))
    out.append(pub.reconcile_once())
    assert out[2:] == [False, 0]
    return out


def inventory_publisher_leaves_inflight_owners_alone(tw):
    pubm, FabricDevice = tw.publisher, tw.provider.FabricDevice
    store = tw.store.Store()
    store.create(_inventory_owner(tw, "inv-busy", ["dev-9"], pending=True))

    class Fabric:
        def get_resources(self):
            return [FabricDevice(device_id="dev-9", node="inv-node",
                                 model="tpu-v4", slice_name="g0",
                                 resource_name="inv-busy")]

    pub = pubm.InventoryPublisher(store, Fabric(), period=60.0)
    out = [pub.reconcile_once(),
           pubm.DevicePublisher(store).devices_invisible("inv-node",
                                                         ["dev-9"])]
    assert out == [0, True]
    return out


# ----------------------------------------------------------------------
# liveness: pings, send deadline, watch death, flap damping
# ----------------------------------------------------------------------
def silent_partition_fails_all_pendings_and_watches_at_once(tw):
    wm, m = tw.wiremux, tw.metrics
    with served(tw) as srv, proxied(tw, srv) as chaos:
        rtt_before = m.wire_ping_rtt_seconds.count()
        client = wm.MuxClient(chaos.url, ping_period=0.2, ping_misses=1,
                              connect_timeout=2.0)
        try:
            assert client.request("POST", CR_PREFIX,
                                  body=cr_doc("live-a"))[0] == 201
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                 timeout=30)
            assert json.loads(next(watch))["type"] == "ADDED"
            deadline = time.monotonic() + 5
            while (m.wire_ping_rtt_seconds.count() == rtt_before
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert m.wire_ping_rtt_seconds.count() > rtt_before
            chaos.partition()
            fails: list = []

            def pending_get():
                t0 = time.monotonic()
                try:
                    client.request("GET", f"{CR_PREFIX}/live-a", timeout=30)
                    fails.append(("response?!", time.monotonic() - t0))
                except wm.MuxError:
                    fails.append(("muxerr", time.monotonic() - t0))

            def pending_watch():
                t0 = time.monotonic()
                try:
                    next(watch)
                    fails.append(("event?!", time.monotonic() - t0))
                except wm.MuxError:
                    fails.append(("muxerr", time.monotonic() - t0))
                except StopIteration:
                    fails.append(("clean-end?!", time.monotonic() - t0))

            threads = [threading.Thread(target=pending_get,
                                        name=f"live-get-{i}")
                       for i in range(4)]
            threads.append(threading.Thread(target=pending_watch,
                                            name="live-watch"))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            kinds = sorted(k for k, _ in fails)
            assert kinds.count("muxerr") == 5, fails
            times = [dt for _, dt in fails]
            assert max(times) < 5.0, fails
            assert max(times) - min(times) < 1.0, fails
            return kinds
        finally:
            client.close()


def dead_connection_reconnects_and_counts_the_metric(tw):
    wm, m = tw.wiremux, tw.metrics
    with served(tw) as srv, proxied(tw, srv) as chaos:
        before = m.wire_mux_reconnects_total.total()
        client = wm.MuxClient(chaos.url, ping_period=0.1, ping_misses=1,
                              connect_timeout=2.0)
        try:
            assert client.request("POST", CR_PREFIX,
                                  body=cr_doc("rc-a"))[0] == 201
            chaos.cut()
            code, body = client.request("GET", f"{CR_PREFIX}/rc-a",
                                        timeout=10, idempotent=True)
            assert code == 200 and body["metadata"]["name"] == "rc-a"
            delta = m.wire_mux_reconnects_total.total() - before
            assert delta == 1 and client.fail_streak == 0
            return code, delta, client.fail_streak
        finally:
            client.close()


def send_timeout_unwedges_a_stalled_peer(tw):
    wm = tw.wiremux
    with served(tw) as srv, proxied(tw, srv) as chaos:
        client = wm.MuxClient(chaos.url, ping_period=0.0, send_timeout=1.0,
                              connect_timeout=2.0)
        try:
            assert client.request("POST", CR_PREFIX,
                                  body=cr_doc("stall-a"))[0] == 201
            chaos.partition("c2s")
            big = cr_doc("stall-b")
            big["spec"]["blob"] = "x" * (16 * 1024 * 1024)
            t0 = time.monotonic()
            with pytest.raises(wm.MuxError):
                client.request("POST", CR_PREFIX, body=big, timeout=30)
            assert time.monotonic() - t0 < 15.0
            return "MuxError"
        finally:
            client.close()


def killed_connection_fails_watch_well_under_idle_period(tw):
    wm = tw.wiremux
    with served(tw) as srv, proxied(tw, srv) as chaos:
        client = wm.MuxClient(chaos.url, ping_period=0.0, connect_timeout=2.0)
        try:
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                 timeout=30)
            outcome: list = []

            def consume():
                t0 = time.monotonic()
                try:
                    next(watch)
                    outcome.append(("event?!", time.monotonic() - t0))
                except wm.MuxError as e:
                    outcome.append(("muxerr", time.monotonic() - t0, str(e)))
                except (StopIteration, OSError):
                    outcome.append(("wrong-type", time.monotonic() - t0))

            t = threading.Thread(target=consume, name="watch-death")
            t.start()
            time.sleep(0.1)
            t_cut = time.monotonic()
            chaos.cut()
            t.join(timeout=10)
            assert not t.is_alive()
            assert outcome and outcome[0][0] == "muxerr", outcome
            assert "connection died" in outcome[0][2]
            srv.put_object(CR_PREFIX, cr_doc("rewatch-a"))
            watch2 = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                  timeout=10)
            ev = json.loads(next(watch2))
            assert ev["object"]["metadata"]["name"] == "rewatch-a"
            assert time.monotonic() - t_cut < 10.0
            watch2.shutdown()
            return outcome[0][0], ev["type"], ev["object"]["metadata"]["name"]
        finally:
            client.close()


def mux_http_fallback_needs_k_consecutive_failures(tw, monkeypatch):
    wm, m = tw.wiremux, tw.metrics
    dials = {"n": 0}

    def blackhole(self):
        dials["n"] += 1
        raise wm.MuxError("dial blackhole")

    monkeypatch.setattr(wm.MuxClient, "_handshake", blackhole)
    degraded_before = m.wire_mux_degraded_total.total()
    with served(tw) as srv:
        store = _kube(tw, srv.url, cache_reads=False, wire_mux=True,
                      wire_mux_max_fails=3)
        try:
            deadline = time.monotonic() + 20
            while not store._mux_failed and time.monotonic() < deadline:
                try:
                    store.get(tw.types.ComposableResource, "absent")
                except (tw.store.StoreError, tw.store.NotFoundError):
                    pass
                time.sleep(0.08)
            assert store._mux_failed, "damper never tripped"
            assert dials["n"] >= 3
            assert m.wire_mux_degraded_total.total() == degraded_before + 1
            assert m.wire_mux_active.total() == 0.0
            store.create(_resource(tw, "damped"))
            name = store.get(tw.types.ComposableResource, "damped").name
            assert name == "damped"
            return name, m.wire_mux_degraded_total.total() - degraded_before
        finally:
            store.close()


def one_mid_flight_loss_on_healthy_wire_never_degrades(tw):
    with served(tw) as srv, proxied(tw, srv) as chaos:
        store = _kube(tw, chaos.url, cache_reads=False, wire_mux=True,
                      wire_mux_max_fails=1, wire_ping_period=0.2,
                      wire_ping_misses=1)
        try:
            store.create(_resource(tw, "flap-a"))
            srv.latency_s = 0.4
            got: list = []

            def read_through_cut():
                got.append(store.get(tw.types.ComposableResource,
                                     "flap-a").name)

            t = threading.Thread(target=read_through_cut, name="flap-get")
            t.start()
            time.sleep(0.15)
            chaos.cut()
            t.join(timeout=15)
            assert not t.is_alive()
            assert got == ["flap-a"]
            assert not store._mux_failed
            return got, store._mux_failed
        finally:
            srv.latency_s = 0.0
            store.close()


def churn_driver_speaks_mux(tw):
    with served(tw) as srv:
        drv = tw.churn.ChurnDriver(srv.url, plan=None, group=GROUP,
                                   version=VERSION, wire_mux=True)
        try:
            code, _ = drv._req("POST", CR_PREFIX, cr_doc("churn-mux"))
            assert code == 201 and drv._mux is not None
            code2, body = drv._req("GET", f"{CR_PREFIX}/churn-mux", None)
            assert code2 == 200
            assert body["metadata"]["name"] == "churn-mux"
            return code, code2, body["metadata"]["name"]
        finally:
            drv.close()


SCENARIOS = [
    roundtrip_one_byte_reads_across_frame_boundaries,
    eof_mid_payload_is_a_truncation_error,
    eof_mid_length_prefix_is_a_truncation_error,
    eof_between_header_and_body,
    corrupt_length_prefix_hits_the_cap,
    garbage_payload_is_a_mux_error_not_a_leak,
    seeded_fuzz_terminates_with_frames_none_or_mux_error,
    oversized_prefix_never_reads_the_claimed_size,
    pipelined_verbs_and_cas_conflict,
    injected_latency_does_not_serialize_pipelined_verbs,
    watch_push_interleaved_with_verbs_on_one_socket,
    mid_watch_reconnect_resumes_from_cursor,
    compacted_resume_cursor_gets_410_error_event,
    watch_open_denied_maps_to_http_error,
    watch_cache_runs_on_mux,
    syncer_relist_demotion_tracks_session_health,
    syncer_wakes_on_inventory_events_only,
    doorbell_bursts_coalesce_to_base_period,
    inventory_publisher_repairs_vanished_publication,
    inventory_publisher_leaves_inflight_owners_alone,
    silent_partition_fails_all_pendings_and_watches_at_once,
    dead_connection_reconnects_and_counts_the_metric,
    send_timeout_unwedges_a_stalled_peer,
    killed_connection_fails_watch_well_under_idle_period,
    one_mid_flight_loss_on_healthy_wire_never_degrades,
    churn_driver_speaks_mux,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("mux", [True, False])
def test_store_semantics_identical_both_transports(mux):
    jax_out, port_out = run_both(store_semantics_identical_both_transports,
                                 mux)
    assert port_out == jax_out


@pytest.mark.parametrize("scenario", [
    env_kill_switch_disables_mux,
    server_decline_falls_back_to_http_for_good,
    mux_http_fallback_needs_k_consecutive_failures,
], ids=lambda f: f.__name__)
def test_patched_scenario_matches_jax(scenario, monkeypatch):
    jax_out, port_out = run_both(scenario, monkeypatch)
    assert port_out == jax_out


# ----------------------------------------------------------------------
# TLS wire
# ----------------------------------------------------------------------
class _TlsMuxServer:
    """Minimal TLS-terminating tpuc-mux/1 endpoint over one package's
    codec: per-connection thread does the TLS handshake, answers the HTTP
    Upgrade with 101, then echoes verbs and answers pings — or, with
    ``stall=True``, goes dark after the 101 (never reads again)."""

    def __init__(self, wm, certfile: str, keyfile: str, stall: bool = False):
        self._wm = wm
        self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._ctx.load_cert_chain(certfile, keyfile)
        self._stall = stall
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self.port = self._lsock.getsockname()[1]
        self.url = f"https://127.0.0.1:{self.port}"
        self._stop = threading.Event()
        self._conns: list = []
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="tls-mux-accept").start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw, _ = self._lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(raw,), daemon=True,
                             name="tls-mux-conn").start()

    def _serve(self, raw: socket.socket) -> None:
        wm = self._wm
        try:
            sock = self._ctx.wrap_socket(raw, server_side=True)
        except (ssl.SSLError, OSError):
            raw.close()
            return
        self._conns.append(sock)
        try:
            head = b""
            while b"\r\n\r\n" not in head:
                b1 = sock.recv(1)
                if not b1:
                    return
                head += b1
            sock.sendall(b"HTTP/1.1 101 Switching Protocols\r\n"
                         b"Upgrade: tpuc-mux/1\r\nConnection: Upgrade\r\n\r\n")
            if self._stall:
                self._stop.wait()
                return
            rfile = sock.makefile("rb")
            while True:
                frame = wm.read_frame(rfile)
                if frame is None:
                    return
                if "ping" in frame:
                    sock.sendall(wm.encode_frame({"pong": frame["ping"]}))
                elif "id" in frame:
                    body = frame.get("body") or {}
                    sock.sendall(wm.encode_frame({
                        "id": frame["id"], "code": 200,
                        "body": {"echo_bytes": len(json.dumps(body))},
                    }))
        except (wm.MuxError, OSError, ValueError):
            return
        finally:
            sock.close()

    def stop(self) -> None:
        self._stop.set()
        for s in [self._lsock] + self._conns:
            try:
                s.close()
            except OSError:
                pass


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "2",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


class _FlagRejectingSock:
    """Delegates to a real socket but rejects flags on send() exactly the
    way ``ssl.SSLSocket`` does — while NOT being an SSLSocket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock

    def send(self, data, flags: int = 0) -> int:
        if flags:
            raise ValueError("non-zero flags not allowed in calls to send()")
        return self._sock.send(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def post_handshake_verbs_and_pings_cross_a_tls_wire(tw, cert):
    wm, m = tw.wiremux, tw.metrics
    server = _TlsMuxServer(wm, *cert)
    ctx = ssl.create_default_context(cafile=cert[0])
    rtt_before = m.wire_ping_rtt_seconds.count()
    client = wm.MuxClient(server.url, ssl_context=ctx, ping_period=0.1,
                          connect_timeout=5.0)
    try:
        blob = "x" * (4 * wm.TLS_SEND_CHUNK)
        code, body = client.request("POST", "/echo", body={"blob": blob},
                                    timeout=10)
        assert code == 200 and body["echo_bytes"] > len(blob)
        deadline = time.monotonic() + 5
        while (m.wire_ping_rtt_seconds.count() == rtt_before
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert m.wire_ping_rtt_seconds.count() > rtt_before
        return code, body
    finally:
        client.close()
        server.stop()


def stalled_tls_peer_fails_send_within_deadline(tw, cert):
    wm = tw.wiremux
    server = _TlsMuxServer(wm, *cert, stall=True)
    ctx = ssl.create_default_context(cafile=cert[0])
    client = wm.MuxClient(server.url, ssl_context=ctx, ping_period=0.0,
                          send_timeout=1.0, connect_timeout=5.0)
    try:
        big = cr_doc("tls-stall")
        big["spec"]["blob"] = "x" * (8 * 1024 * 1024)
        t0 = time.monotonic()
        with pytest.raises(wm.MuxError):
            client.request("POST", CR_PREFIX, body=big, timeout=30)
        assert time.monotonic() - t0 < 15.0
        return "MuxError"
    finally:
        client.close()
        server.stop()


@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl CLI unavailable for cert generation")
@pytest.mark.parametrize("scenario", [
    post_handshake_verbs_and_pings_cross_a_tls_wire,
    stalled_tls_peer_fails_send_within_deadline,
], ids=lambda f: f.__name__)
def test_tls_scenario_matches_jax(scenario, tls_cert):
    jax_out, port_out = run_both(scenario, tls_cert)
    assert port_out == jax_out


def flag_rejecting_socket_fails_as_muxerror_not_valueerror(tw):
    wm = tw.wiremux
    a, b = socket.socketpair()
    conn = wm._MuxConn(_FlagRejectingSock(a))
    try:
        with pytest.raises(wm.MuxError):
            conn.send({"id": 1, "method": "GET", "path": "/x"})
        assert conn.dead.is_set()
        return conn.dead.is_set()
    finally:
        conn.close()
        b.close()


def test_send_value_error_safety_net_matches_jax():
    jax_out, port_out = run_both(
        flag_rejecting_socket_fails_as_muxerror_not_valueerror)
    assert port_out == jax_out


# ----------------------------------------------------------------------
# Cross-package wire
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_encodes_the_same_bytes_in_both_packages(seed):
    """Seeded frames encode to the same bytes in both packages, and each
    package's reader decodes the other's mutated streams alike."""
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    rng_j, rng_p = random.Random(seed), random.Random(seed)
    for _ in range(100):
        wj, wp = _fuzz_wire(jax, rng_j), _fuzz_wire(port, rng_p)
        assert wj == wp
    assert jax.wiremux.PROTOCOL == port.wiremux.PROTOCOL == "tpuc-mux/1"
    assert jax.wiremux.MAX_FRAME == port.wiremux.MAX_FRAME
    out_j = seeded_fuzz_terminates_with_frames_none_or_mux_error(jax, seed)
    out_p = seeded_fuzz_terminates_with_frames_none_or_mux_error(port, seed)
    assert out_p == out_j


def _client_drives_server(client_tw, server_tw):
    """``client_tw``'s MuxClient against ``server_tw``'s apiserver: a
    create, a CAS conflict, a watch push and a delete on one socket."""
    with served(server_tw) as srv:
        client = client_tw.wiremux.MuxClient(srv.url, ping_period=0.1)
        try:
            watch = client.watch(f"{CR_PREFIX}?watch=true&resourceVersion=0",
                                 timeout=5)
            code, created = client.request("POST", CR_PREFIX,
                                           body=cr_doc("x-a"))
            stale = dict(created, spec=dict(created["spec"], count=2))
            c2, _ = client.request("PUT", f"{CR_PREFIX}/x-a", body=stale)
            c3, status = client.request("PUT", f"{CR_PREFIX}/x-a", body=stale)
            c4, _ = client.request("DELETE", f"{CR_PREFIX}/x-a")
            events = []
            for line in watch:
                ev = json.loads(line)
                events.append((ev["type"], ev["object"]["metadata"]["name"],
                               ev["object"]["spec"].get("count")))
                if ev["type"] == "DELETED":
                    break
            watch.shutdown()
            return [code, c2, c3, status.get("reason"), c4, events,
                    list(srv.request_log)]
        finally:
            client.close()


def test_each_client_talks_to_the_other_package_server():
    jax, port = twin(JAX_ROOT), twin(PORT_ROOT)
    same_jax = _client_drives_server(jax, jax)
    assert _client_drives_server(port, jax) == same_jax
    assert _client_drives_server(jax, port) == same_jax
    assert _client_drives_server(port, port) == same_jax
    assert same_jax[:5] == [201, 200, 409, "Conflict", 200]
