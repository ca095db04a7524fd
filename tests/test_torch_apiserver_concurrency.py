"""The port's fake apiserver under concurrency, against the JAX
package's (tests/test_apiserver_concurrency.py's twin): four worker
PROCESSES race optimistic-concurrency increments on one object over
plain HTTP while a watcher streams, and eight threads race two kinds
over one ``tpuc-mux/1`` socket with a mux watch per kind. CAS admits
exactly one writer per version (no lost update), each kind's watch sees
strictly increasing resourceVersions ending on the stored object, and
the shared rv counter never gives two kinds one version.

Each scenario runs once per package (``run_both``), against the
package's ``FakeApiServer`` and with its ``MuxClient``, and returns the
final counts, the admitted increments and whether every ordering held;
the reference's invariants are asserted on the way. Interleavings
differ from run to run, so the versions themselves are not compared.
Tolerance: exact.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from tests.torch_operator import run_both

torch.set_num_threads(1)

PREFIX = "/apis/test.dev/v1/counters"
PREFIX_B = "/apis/test.dev/v1/gauges"

# Worker subprocess: pure stdlib so spawn cost stays milliseconds. Loops
# optimistic-concurrency increments until it lands `wins` of them, then
# prints its win count. argv: base_url, object_url, wins.
_WORKER = r"""
import json, sys, urllib.error, urllib.request

base, url, wins = sys.argv[1], sys.argv[2], int(sys.argv[3])
landed = 0
while landed < wins:
    with urllib.request.urlopen(url, timeout=10) as resp:
        obj = json.load(resp)
    obj["spec"]["count"] += 1
    body = json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=body, method="PUT",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=10):
            landed += 1
    except urllib.error.HTTPError as e:
        if e.code != 409:
            raise
print(landed)
"""


def four_process_cas_hammer_loses_no_updates(tw):
    srv = tw.apiserver.FakeApiServer(
        {PREFIX: {"kind": "Counter", "apiVersion": "test.dev/v1"}})
    base = srv.start()
    try:
        srv.put_object(PREFIX, {
            "apiVersion": "test.dev/v1", "kind": "Counter",
            "metadata": {"name": "shared"}, "spec": {"count": 0}})
        obj_url = f"{base}{PREFIX}/shared"
        rvs, watcher_err = [], []
        watch_url = f"{base}{PREFIX}?watch=true&resourceVersion=0"

        def watch():
            try:
                with urllib.request.urlopen(watch_url, timeout=60) as resp:
                    for line in resp:
                        ev = json.loads(line)
                        rv = int(ev["object"]["metadata"]["resourceVersion"])
                        rvs.append((ev["type"], rv, ev["object"]))
                        if ev["object"].get("spec", {}).get("count") == 100:
                            return
            except Exception as e:  # surfaced in the main thread's assert
                watcher_err.append(e)

        wt = threading.Thread(target=watch, daemon=True)
        wt.start()
        workers = [
            subprocess.Popen([sys.executable, "-c", _WORKER, base, obj_url,
                              "25"], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for _ in range(4)]
        landed = 0
        for w in workers:
            out, err = w.communicate(timeout=60)
            assert w.returncode == 0, f"worker failed: {err}"
            landed += int(out.strip())
        assert landed == 100
        with urllib.request.urlopen(obj_url, timeout=10) as resp:
            final = json.load(resp)
        assert final["spec"]["count"] == 100
        wt.join(timeout=30)
        assert not watcher_err, f"watcher died: {watcher_err[0]!r}"
        assert not wt.is_alive(), "watcher never saw the final count"
        seen = [rv for (_t, rv, _o) in rvs]
        ordered = seen == sorted(set(seen))
        assert ordered, f"watch stream reordered or duplicated: {seen}"
        assert rvs[-1][2]["spec"]["count"] == 100
        assert rvs[-1][1] == int(final["metadata"]["resourceVersion"])
        return {"landed": landed, "final": final["spec"]["count"],
                "ordered": ordered, "last_is_final": True}
    finally:
        srv.stop()


def two_kind_mux_hammer_against_sharded_locks(tw):
    srv = tw.apiserver.FakeApiServer({
        PREFIX: {"kind": "Counter", "apiVersion": "test.dev/v1"},
        PREFIX_B: {"kind": "Gauge", "apiVersion": "test.dev/v1"},
    })
    base = srv.start()
    client = tw.wiremux.MuxClient(base)
    wins_per_worker, workers_per_kind = 15, 4
    target = wins_per_worker * workers_per_kind
    try:
        for prefix, kind in ((PREFIX, "Counter"), (PREFIX_B, "Gauge")):
            srv.put_object(prefix, {
                "apiVersion": "test.dev/v1", "kind": kind,
                "metadata": {"name": "shared"}, "spec": {"count": 0}})
        events = {PREFIX: [], PREFIX_B: []}
        watch_errs, errs = [], []

        def watch(prefix):
            try:
                w = client.watch(f"{prefix}?watch=true&resourceVersion=0",
                                 timeout=30)
                for line in w:
                    ev = json.loads(line)
                    events[prefix].append(
                        int(ev["object"]["metadata"]["resourceVersion"]))
                    if ev["object"]["spec"].get("count") == target:
                        w.shutdown()
                        return
            except Exception as e:
                watch_errs.append(e)

        def hammer(prefix):
            landed = 0
            try:
                while landed < wins_per_worker:
                    code, obj = client.request("GET", f"{prefix}/shared",
                                               timeout=30)
                    assert code == 200, (code, obj)
                    obj["spec"]["count"] += 1
                    code, out = client.request("PUT", f"{prefix}/shared",
                                               body=obj, timeout=30)
                    if code == 200:
                        landed += 1
                    else:
                        assert code == 409, (code, out)
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=watch, args=(p,))
                   for p in (PREFIX, PREFIX_B)]
        threads += [threading.Thread(target=hammer, args=(p,))
                    for p in (PREFIX, PREFIX_B)
                    for _ in range(workers_per_kind)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, f"hammer died: {errs[0]!r}"
        assert not watch_errs, f"watcher died: {watch_errs[0]!r}"
        assert not any(t.is_alive() for t in threads), "hammer deadlocked"
        finals = {}
        for prefix in (PREFIX, PREFIX_B):
            code, final = client.request("GET", f"{prefix}/shared")
            assert code == 200 and final["spec"]["count"] == target
            finals[prefix] = final["spec"]["count"]
            seen = events[prefix]
            assert seen == sorted(set(seen)), seen
        assert not set(events[PREFIX]) & set(events[PREFIX_B])
        return {"finals": finals, "ordered": True, "disjoint": True}
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("scenario", [
    four_process_cas_hammer_loses_no_updates,
    two_kind_mux_hammer_against_sharded_locks,
], ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    jax_out, port_out = run_both(scenario)
    assert port_out == jax_out
