"""The port's process-mode fleet (``fleet/proc.py``: ``python -m
tpu_composer_torch`` replicas as real OS processes over the port's fake
apiserver and tests/torch_fake_fabric.py) against the JAX package's
(tests/test_proc_fleet.py's twin).

- A light smoke, in tier-1: two replicas of each package over one TPU
  request; both balance the shard leases, run it to Running with one
  attach, and exit 0 on a graceful drain, leaving their trace files.
- The kill -9 failover soak and the two-process mini-churn, marked
  ``slow`` and ``proc`` as the JAX ones are: the same scenario on each
  package side by side, compared by what it fixes (convergence, lease
  ownership, zero double attach, the stitched cross-process trace).
"""

from __future__ import annotations

import os
import signal
import time

import pytest
import torch

from tests.test_crash_restart import assert_no_double_attach
from tests.torch_operator import PORT_ROOT, ROOTS, twin

torch.set_num_threads(1)

GROUP, VERSION = "tpu.composer.dev", "v1alpha1"
GV = f"{GROUP}/{VERSION}"
LEASE_S = 2.0
RENEW_S = 0.25
TAKEOVER_BOUND_S = LEASE_S + 4 * RENEW_S + 1.0


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.05)
    raise TimeoutError(what)


def _cr_doc(name, size):
    return {"apiVersion": GV, "kind": "ComposabilityRequest",
            "metadata": {"name": name},
            "spec": {"resource": {"type": "tpu", "model": "tpu-v4",
                                  "size": size}}}


def _cr_states(fleet):
    with fleet.apiserver.state.lock:
        return {lname: (obj.get("status") or {}).get("state")
                for (prefix, lname), obj in fleet.apiserver.state.objects.items()
                if prefix == fleet.cr_prefix}


def _pending_intents(fleet):
    with fleet.apiserver.state.lock:
        return sum(1 for (prefix, _), obj
                   in fleet.apiserver.state.objects.items()
                   if prefix == fleet.res_prefix
                   and (obj.get("status") or {}).get("pending_op"))


def _pool_attach_events(fleet):
    raw, _cursor = fleet.pool.poll_events(0, timeout=0)
    events = []
    for e in raw:
        if e.type != "op_completed" or e.outcome != "ok":
            continue
        if e.verb == "add":
            events.append(("attach", e.resource, e.nonce))
        elif e.verb == "remove":
            events.append(("release", e.resource))
    return events


def _drain_all(fleet):
    """SIGTERM every live replica at once, then wait for each (one signal
    each: a second one landing while the interpreter exits kills it)."""
    live = fleet.live()
    for rep in live:
        rep.proc.send_signal(signal.SIGTERM)
    return {rep.name: rep.proc.wait(timeout=30) for rep in live}


def test_port_fleet_spawns_the_ports_binary_and_fake_fabric():
    src = (twin(PORT_ROOT).proc.__file__)
    with open(src) as f:
        text = f.read()
    assert '"-m", "tpu_composer_torch"' in text
    assert "tests.torch_fake_fabric" in text and "tests.fake_fabric" not in text


def test_two_replica_smoke_matches_jax(tmp_path):
    """Two replicas per package over one size-2 request: the same
    convergence, one attach per child, graceful exits, trace files."""

    def run(root):
        tw = twin(root)
        fleet = tw.proc.ProcFleet(str(tmp_path / root), nodes=2,
                                  chips_per_node=4, shards=4,
                                  expected_replicas=2,
                                  lease_duration_s=LEASE_S,
                                  lease_renew_s=RENEW_S)
        with fleet:
            for name in ("smoke-a", "smoke-b"):
                fleet.spawn(name, wait_ready_s=60)
            _wait(lambda: len(fleet.shard_owners()) == fleet.shards
                  and len(set(fleet.shard_owners().values())) == 2, 30,
                  "shard leases never balanced across both replicas")
            fleet.apiserver.put_object(fleet.cr_prefix, _cr_doc("one", 2))
            _wait(lambda: _cr_states(fleet) == {"one": "Running"}, 60,
                  f"the request never ran: {_cr_states(fleet)}")
            _wait(lambda: _pending_intents(fleet) == 0, 30,
                  "durable intents never drained")
            events = _pool_attach_events(fleet)
            assert_no_double_attach(events)
            rcs = _drain_all(fleet)
            traces = [os.path.basename(p) for p in fleet.trace_files()]
            merged = fleet.merged_trace()
            names = sorted({e["args"]["name"] for e in merged["traceEvents"]
                            if e.get("name") == "process_name"})
            return {"states": _cr_states(fleet),
                    "owners": sorted(set(fleet.shard_owners().values())),
                    "attaches": len([e for e in events if e[0] == "attach"]),
                    "rcs": rcs, "traces": sorted(traces),
                    "names": [n for n in names if n.startswith("smoke-")]}

    jax_out, port_out = (run(root) for root in ROOTS)
    assert jax_out == port_out
    assert port_out["rcs"] == {"smoke-a": 0, "smoke-b": 0}
    assert port_out["attaches"] == 1
    assert port_out["names"] == ["smoke-a", "smoke-b"]


def _kill9_failover(root, workdir):
    tw = twin(root)
    fleet = tw.proc.ProcFleet(workdir, nodes=8, chips_per_node=4, shards=8,
                              expected_replicas=2, lease_duration_s=LEASE_S,
                              lease_renew_s=RENEW_S)
    with fleet:
        fleet.spawn("alpha", wait_ready_s=60)
        fleet.spawn("beta", wait_ready_s=60)
        _wait(lambda: len(fleet.shard_owners()) == fleet.shards
              and len(set(fleet.shard_owners().values())) == 2, 30,
              "shard leases never balanced across both replicas")
        total = 12
        for i in range(total):
            fleet.apiserver.put_object(fleet.cr_prefix,
                                       _cr_doc(f"wave-{i:02d}", 2))

        def pick_victim():
            counts = fleet.in_flight_intents()
            return max(counts, key=counts.get) if counts else None

        try:
            victim = _wait(pick_victim, 15, "no in-flight intents seen")
        except TimeoutError:
            victim = fleet.live()[0].name
        survivors = [r.name for r in fleet.live() if r.name != victim]
        fleet.kill(victim)
        _wait(lambda: len(_cr_states(fleet)) == total and all(
            s == "Running" for s in _cr_states(fleet).values()),
            TAKEOVER_BOUND_S + 30, f"no convergence: {_cr_states(fleet)}")
        _wait(lambda: _pending_intents(fleet) == 0, 30,
              "durable intents never drained after failover")
        owners = fleet.shard_owners()
        events = _pool_attach_events(fleet)
        assert_no_double_attach(events)
        fleet.stop_all()
        merged = fleet.merged_trace()
        victim_pid = tw.tracing.replica_pid(victim)
        names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
                 if e.get("name") == "process_name"}
        by_trace = {}
        for e in merged["traceEvents"]:
            tid = (e.get("args") or {}).get("trace_id")
            if e.get("ph") == "X" and tid:
                by_trace.setdefault(tid, []).append(e)
        stitched = {f["args"]["trace_id"] for f in merged["traceEvents"]
                    if f.get("ph") in ("s", "f") and f["args"].get("stitched")}
        connected = [t for t, evs in by_trace.items()
                     if victim_pid in {e["pid"] for e in evs}
                     and any(e["name"] == "adopt" and e["pid"] != victim_pid
                             for e in evs) and t in stitched]
        return {"converged": True, "owners_complete": len(owners) == 8,
                "victim_owns": victim in owners.values(),
                "owners_survive": set(owners.values()) <= set(survivors),
                "prekill": "trace_prekill" in fleet.replicas[victim].artifacts,
                "victim_named": names.get(victim_pid) == victim,
                "stitched_failover": bool(connected)}


@pytest.mark.slow
@pytest.mark.proc
def test_kill9_failover_converges_without_double_attach(tmp_path):
    outs = [_kill9_failover(root, str(tmp_path / root)) for root in ROOTS]
    assert outs[0] == outs[1] == {
        "converged": True, "owners_complete": True, "victim_owns": False,
        "owners_survive": True, "prekill": True, "victim_named": True,
        "stitched_failover": True}


def _mini_churn(root, workdir):
    tw = twin(root)
    plan = tw.churn.generate_plan(seed=17, requests=24, duration_s=4.0,
                                  nodes=16, chips_per_node=4, min_size=1,
                                  max_size=2, cancel_frac=0.2,
                                  resize_frac=0.2, migrate_frac=0.0)
    model = tw.churn.simulate(plan)
    fleet = tw.proc.ProcFleet(workdir, nodes=plan.nodes,
                              chips_per_node=plan.chips_per_node, shards=8,
                              expected_replicas=2, lease_duration_s=LEASE_S,
                              lease_renew_s=RENEW_S)
    with fleet:
        fleet.spawn("smoke-a", wait_ready_s=60)
        fleet.spawn("smoke-b", wait_ready_s=60)
        _wait(lambda: len(fleet.shard_owners()) == fleet.shards, 30,
              "shard leases never fully claimed")
        driver = tw.churn.ChurnDriver(fleet.apiserver.url, plan, GROUP,
                                      VERSION)
        try:
            driver.run()
            _wait(lambda: _cr_states(fleet) and all(
                s == "Running" for s in _cr_states(fleet).values())
                and _pending_intents(fleet) == 0, 60,
                f"mini-churn never converged: {_cr_states(fleet)}")
        finally:
            driver.stop()
        states = _cr_states(fleet)
        cancels = plan.counts().get("cancel", 0)
        assert model["arrivals"] - cancels <= len(states) <= model["arrivals"]
        assert_no_double_attach(_pool_attach_events(fleet))
        fleet.stop_all()
        artifacts = all(os.path.exists(a["log"]) and os.path.exists(a["trace"])
                        for a in fleet.artifact_index().values())
        return {"arrivals": model["arrivals"], "cancels": cancels,
                "converged": True, "artifacts": artifacts}


@pytest.mark.slow
@pytest.mark.proc
def test_two_process_mini_churn_converges(tmp_path):
    outs = [_mini_churn(root, str(tmp_path / root)) for root in ROOTS]
    assert outs[0] == outs[1]
    assert outs[1]["converged"] and outs[1]["artifacts"]

