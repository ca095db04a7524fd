"""The port's command line against the JAX package's (tests/test_cmd.py's
twin, without ``TestCrdGen``): ``build_manager``'s wiring under each
escape hatch, a request to Running through the built manager (unsharded
and over two shards), the validating webhooks on by default, the remote
node agent under ``NODE_AGENT=REMOTE``, the binary as a real process
(``/healthz``, exit 0 on SIGTERM) and the ``trace-merge`` subcommand.

Each scenario runs once per package (``run_both``) with its own
environment, and returns what the reference asserts on: which
collaborators were built, their knobs, the request's final state, exit
codes. The reference's invariants are asserted on the way; the two
packages' results must be equal. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both, twin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_process_knobs():
    """``build_manager`` sets process-wide knobs (tracing, the replica
    tag, the observatory's switches) in each package; put them back for
    the tests that follow in this process."""
    yield
    for root in (JAX_ROOT, PORT_ROOT):
        tw = twin(root)
        tw.tracing.set_enabled(True)
        tw.tracing.set_replica(None)
        tw.profiler.set_enabled(True)
        tw.contention.set_enabled(True)


def _both(monkeypatch, tmp_path, scenario, **env):
    """``scenario(tw, tmp)`` on each package under ``env`` (a value of
    None deletes the variable), with the mock fabric reset first."""

    def run(tw):
        with monkeypatch.context() as m:
            m.setenv("CDI_PROVIDER_TYPE", "MOCK")
            m.delenv("NODE_AGENT", raising=False)
            for k, v in env.items():
                if v is None:
                    m.delenv(k, raising=False)
                else:
                    m.setenv(k, v)
            tw.adapter.reset_shared_mock()
            tmp = tmp_path / tw.root
            tmp.mkdir(exist_ok=True)
            return scenario(tw, tmp)

    jax_out, port_out = run_both(run)
    assert jax_out == port_out
    return port_out


def _build(tw, argv):
    args = tw.cmd.build_parser().parse_args(argv)
    return args, tw.cmd.build_manager(args)


def _controller(tw, mgr, cls):
    return next(c for c in mgr._controllers if isinstance(c, cls))


def _runs(mgr, obj) -> bool:
    return any(getattr(r, "__self__", None) is obj for r in mgr._runnables)


def _wait_running(tw, mgr, name, timeout=20.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        state = mgr.store.get(tw.types.ComposabilityRequest, name).status.state
        if state == tw.types.REQUEST_STATE_RUNNING:
            return state
        time.sleep(0.05)
    return mgr.store.get(tw.types.ComposabilityRequest, name).status.state


def _node(tw, name="worker-0", slots=4):
    n = tw.types.Node(metadata=tw.meta.ObjectMeta(name=name))
    n.status.tpu_slots = slots
    return n


def _request(tw, name, size=4, **resource):
    t = tw.types
    return t.ComposabilityRequest(
        metadata=tw.meta.ObjectMeta(name=name),
        spec=t.ComposabilityRequestSpec(resource=t.ResourceDetails(
            type="tpu", model="tpu-v4", size=size, **resource)))


def test_mock_wiring_reaches_running(monkeypatch, tmp_path):
    def scenario(tw, tmp):
        args, mgr = _build(tw, ["--health-probe-bind-address", "127.0.0.1:0",
                                "--state-dir", str(tmp / "state")])
        try:
            mgr.store.create(_node(tw))
            mgr.start(workers_per_controller=2)
            port = mgr.health_port
            codes = [urllib.request.urlopen(
                f"http://127.0.0.1:{port}{route}").status
                for route in ("/healthz", "/readyz")]
            mgr.store.create(_request(tw, "cli-req"))
            state = _wait_running(tw, mgr, "cli-req")
            metrics = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics").read().decode()
            assert state == tw.types.REQUEST_STATE_RUNNING
            return {"codes": codes, "state": state,
                    "reconcile_metrics": "reconcile" in metrics}
        finally:
            mgr.stop()

    out = _both(monkeypatch, tmp_path, scenario)
    assert out["codes"] == [200, 200] and out["reconcile_metrics"]


def test_fabric_batch_default_and_escape_hatch(monkeypatch, tmp_path):
    def on(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s1"),
                                "--fabric-batch-window", "0.007",
                                "--fabric-concurrency", "3"])
        try:
            rec = _controller(tw, mgr, tw.rc.ComposableResourceReconciler)
            return {"flag": args.fabric_batch,
                    "window": rec.dispatcher.batch_window,
                    "concurrency": rec.dispatcher.concurrency}
        finally:
            mgr.stop()

    def off(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s2")])
        try:
            rec = _controller(tw, mgr, tw.rc.ComposableResourceReconciler)
            return {"flag": args.fabric_batch,
                    "dispatcher": rec.dispatcher is not None}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, on) == {
        "flag": True, "window": 0.007, "concurrency": 3}
    assert _both(monkeypatch, tmp_path, off, TPUC_FABRIC_BATCH="0") == {
        "flag": False, "dispatcher": False}


def test_observatory_default_and_escape_hatch(monkeypatch, tmp_path):
    def on(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s1"),
                                "--profile-interval", "0.02",
                                "--slo-attach-p99", "7.5",
                                "--slo-queue-p99", "0",
                                "--slo-burn-threshold", "3.0"])
        try:
            by_name = {o.name: o for o in mgr.slo_engine.objectives}
            assert mgr.slo_engine.recorder is mgr.recorder
            return {"flag": args.profile, "interval": mgr.profiler.interval,
                    "burn": mgr.slo_engine.burn_threshold,
                    "attach": by_name["attach_p99"].threshold_s,
                    "objectives": sorted(by_name)}
        finally:
            mgr.stop()

    def off(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s2")])
        try:
            return {"flag": args.profile, "profiler": mgr.profiler,
                    "slo": mgr.slo_engine,
                    "sampling": tw.profiler.enabled(),
                    "contention": tw.contention.enabled()}
        finally:
            mgr.stop()
            tw.profiler.set_enabled(True)
            tw.contention.set_enabled(True)

    out = _both(monkeypatch, tmp_path, on)
    assert out["interval"] == 0.02 and out["attach"] == 7.5
    assert "queue_wait_p99" not in out["objectives"]  # 0 disables
    assert _both(monkeypatch, tmp_path, off, TPUC_PROFILE="0") == {
        "flag": False, "profiler": None, "slo": None, "sampling": False,
        "contention": False}


def test_fabric_events_default_and_escape_hatch(monkeypatch, tmp_path):
    def scenario(tw, tmp, argv=()):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s"), *argv])
        try:
            rec = _controller(tw, mgr, tw.rc.ComposableResourceReconciler)
            disp = rec.dispatcher
            session = disp._session if disp is not None else None
            return {"flag": args.fabric_events,
                    "dispatcher": disp is not None,
                    "session": isinstance(session, tw.fevents.FabricSession),
                    "fallback": disp.fallback_multiplier if disp else None,
                    "session_runs": any(
                        isinstance(getattr(r, "__self__", None),
                                   tw.fevents.FabricSession)
                        for r in mgr._runnables)}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, lambda tw, tmp: scenario(
        tw, tmp, ["--fabric-poll-fallback-mult", "11"])) == {
        "flag": True, "dispatcher": True, "session": True, "fallback": 11,
        "session_runs": True}
    assert _both(monkeypatch, tmp_path, scenario,
                 TPUC_FABRIC_EVENTS="0")["session"] is False
    out = _both(monkeypatch, tmp_path, scenario, TPUC_FABRIC_BATCH="0")
    assert not out["dispatcher"] and not out["session_runs"]


def test_fleet_default_and_escape_hatch(monkeypatch, tmp_path):
    def on(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s1"),
                                "--fleet-publish-period", "0.7",
                                "--fleet-stale-after", "9.0",
                                "--slo-attach-p99", "7.5"])
        try:
            by_name = {o.name: o for o in mgr.fleet.slo.objectives}
            assert isinstance(mgr.fleet, tw.fleet.FleetPlane)
            assert mgr.replica_id == mgr.fleet.identity
            assert mgr.fleet.slo.recorder is mgr.recorder
            assert tw.tracing.current_replica() == mgr.replica_id
            return {"flag": args.fleet, "publish": mgr.fleet.publish_period,
                    "stale": mgr.fleet.stale_after_s,
                    "attach": by_name["fleet_attach_p99"].threshold_s,
                    "runs": _runs(mgr, mgr.fleet)}
        finally:
            mgr.stop()
            tw.tracing.set_replica(None)

    def off(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s2")])
        try:
            return {"flag": args.fleet, "fleet": mgr.fleet,
                    "replica": mgr.replica_id,
                    "traced_replica": tw.tracing.current_replica(),
                    "runs": any(isinstance(getattr(r, "__self__", None),
                                           tw.fleet.FleetPlane)
                                for r in mgr._runnables)}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, on) == {
        "flag": True, "publish": 0.7, "stale": 9.0, "attach": 7.5,
        "runs": True}
    assert _both(monkeypatch, tmp_path, off, TPUC_FLEET="0") == {
        "flag": False, "fleet": None, "replica": None,
        "traced_replica": None, "runs": False}


def test_decisions_default_and_escape_hatch(monkeypatch, tmp_path):
    def on(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s1"),
                                "--capacity-sample-period", "0.9",
                                "--slo-goodput-target", "0.92"])
        try:
            rec = _controller(tw, mgr,
                              tw.req.ComposabilityRequestReconciler)
            ledger = rec.scheduler.ledger
            assert isinstance(ledger, tw.ledger.DecisionLedger)
            assert mgr.decisions is ledger and ledger.recorder is mgr.recorder
            assert rec.scheduler.defrag.decision_ledger is ledger
            assert isinstance(mgr.goodput, tw.goodput.GoodputTracker)
            assert mgr.goodput.observe in tw.lifecycle._transition_sinks
            assert mgr.capacity.goodput is mgr.goodput
            goodput = {o.name: o for o in mgr.slo_engine.objectives}["goodput"]
            assert isinstance(goodput, tw.slo.GoodputObjective)
            assert goodput.tracker is mgr.goodput
            assert mgr.slo_engine.annotators["queue_wait_p99"] == (
                ledger.dominant_hold_back_reason)
            out = {"flag": args.decisions, "period": mgr.capacity.period,
                   "target": goodput.target,
                   "capacity_runs": _runs(mgr, mgr.capacity)}
        finally:
            mgr.stop()
        out["sink_left"] = any(
            getattr(s, "__self__", None) is mgr.goodput
            for s in tw.lifecycle._transition_sinks)
        return out

    def off(tw, tmp):
        sinks_before = len(tw.lifecycle._transition_sinks)
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s2")])
        try:
            rec = _controller(tw, mgr,
                              tw.req.ComposabilityRequestReconciler)
            return {"flag": args.decisions,
                    "ledger": rec.scheduler.ledger,
                    "defrag_ledger": rec.scheduler.defrag.decision_ledger,
                    "decisions": mgr.decisions, "goodput": mgr.goodput,
                    "capacity": mgr.capacity,
                    "sinks_added": len(tw.lifecycle._transition_sinks)
                    - sinks_before,
                    "objectives": sorted(
                        o.name for o in mgr.slo_engine.objectives),
                    "annotators": sorted(mgr.slo_engine.annotators)}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, on) == {
        "flag": True, "period": 0.9, "target": 0.92, "capacity_runs": True,
        "sink_left": False}
    out = _both(monkeypatch, tmp_path, off, TPUC_DECISIONS="0")
    assert out["flag"] is False and out["sinks_added"] == 0
    assert out["ledger"] is out["decisions"] is out["capacity"] is None
    assert "goodput" not in out["objectives"]
    assert "queue_wait_p99" not in out["annotators"]


def test_migrate_default_and_escape_hatch(monkeypatch, tmp_path):
    def scenario(tw, tmp, argv=()):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s"), *argv])
        try:
            maint = [c for c in mgr._controllers
                     if isinstance(c, tw.mc.NodeMaintenanceReconciler)]
            req = _controller(tw, mgr, tw.req.ComposabilityRequestReconciler)
            return {"flag": args.migrate,
                    "deadlines": [c.timing.default_deadline for c in maint],
                    "enabled": req.migrate.enabled,
                    "max_concurrent": req.migrate.max_concurrent,
                    "breaker": req.migrate.breaker_fraction,
                    "defrag": req.scheduler.defrag.mode}
        finally:
            mgr.stop()

    out = _both(monkeypatch, tmp_path, lambda tw, tmp: scenario(
        tw, tmp, ["--migrate-max-concurrent", "5",
                  "--migrate-breaker-fraction", "0.4",
                  "--migrate-drain-deadline", "123"]))
    assert out == {"flag": True, "deadlines": [123], "enabled": True,
                   "max_concurrent": 5, "breaker": 0.4, "defrag": "migrate"}
    out = _both(monkeypatch, tmp_path, scenario, TPUC_MIGRATE="0")
    assert (out["flag"], out["deadlines"], out["enabled"],
            out["defrag"]) == (False, [], False, "delete")


def test_survival_layer_default_and_escape_hatches(monkeypatch, tmp_path):
    def on(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s1"),
                                "--overload-period", "0.7",
                                "--overload-shed-quantum", "3.0",
                                "--store-breaker-threshold", "7",
                                "--watchdog-stall-after", "12.0"])
        try:
            gov, wd = mgr.overload, mgr.watchdog
            req = _controller(tw, mgr, tw.req.ComposabilityRequestReconciler)
            assert isinstance(gov, tw.overload.OverloadGovernor)
            assert req.shed_gate is not None
            assert all(c.shed_gate is None for c in mgr._controllers
                       if c is not req)
            assert len(gov._queues) == len(mgr._controllers)
            assert isinstance(mgr.storebreaker, tw.storebreaker.BreakingStore)
            assert isinstance(req.store, tw.cache.CachedClient)
            assert req.store.store is mgr.storebreaker
            assert gov.store_breaker is mgr.storebreaker
            assert isinstance(wd, tw.watchdog.Watchdog)
            assert all(c.watchdog is wd for c in mgr._controllers)
            assert wd.restarter is not None
            return {"flags": [args.overload, args.watchdog,
                              args.store_breaker],
                    "period": gov.period, "quantum": gov.shed_quantum,
                    "governor_runs": _runs(mgr, gov),
                    "threshold": mgr.storebreaker.failure_threshold,
                    "stall_after": wd.stall_after,
                    "watchdog_runs": _runs(mgr, wd),
                    "governor_restartable": wd.snapshot()["subsystems"][
                        "OverloadGovernor"]["restartable"]}
        finally:
            mgr.stop()

    def off(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "s2")])
        try:
            req = _controller(tw, mgr, tw.req.ComposabilityRequestReconciler)
            assert isinstance(req.store, tw.cache.CachedClient)
            return {"flags": [args.overload, args.watchdog,
                              args.store_breaker],
                    "built": [mgr.overload, mgr.watchdog, mgr.storebreaker,
                              req.shed_gate],
                    "controller_watchdogs": [c.watchdog
                                             for c in mgr._controllers],
                    "breaking": isinstance(req.store.store,
                                           tw.storebreaker.BreakingStore),
                    "runs": any(isinstance(
                        getattr(r, "__self__", None),
                        (tw.overload.OverloadGovernor,
                         tw.watchdog.Watchdog)) for r in mgr._runnables)}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, on) == {
        "flags": [True, True, True], "period": 0.7, "quantum": 3.0,
        "governor_runs": True, "threshold": 7, "stall_after": 12.0,
        "watchdog_runs": True, "governor_restartable": True}
    out = _both(monkeypatch, tmp_path, off, TPUC_OVERLOAD="0",
                TPUC_WATCHDOG="0", TPUC_STORE_BREAKER="0")
    assert out["flags"] == [False, False, False]
    assert out["built"] == [None] * 4 and not out["breaking"]
    assert not any(out["controller_watchdogs"]) and not out["runs"]


def test_default_shards_is_unsharded_single_leader_path(monkeypatch,
                                                        tmp_path):
    def scenario(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "state"),
                                "--health-probe-bind-address", ""])
        try:
            syncers = [r for r in mgr._runnables
                       if isinstance(r, tw.syncer.UpstreamSyncer)]
            return {"shards": args.shards, "elector": mgr._elector,
                    "ownership": [c.ownership for c in mgr._controllers],
                    "fences": [c.dispatcher._owns for c in mgr._controllers
                               if getattr(c, "dispatcher", None)],
                    "syncers": [s.ownership for s in syncers]}
        finally:
            mgr.stop()

    out = _both(monkeypatch, tmp_path, scenario)
    assert out["shards"] == 1 and out["elector"] is None
    assert not any(out["ownership"]) and not any(out["fences"])
    assert out["syncers"] == [None]


def test_sharded_wiring_reaches_running(monkeypatch, tmp_path):
    def scenario(tw, tmp):
        args, mgr = _build(tw, ["--state-dir", str(tmp / "state"),
                                "--health-probe-bind-address", "",
                                "--shards", "2", "--lease-duration", "1.0",
                                "--lease-renew-period", "0.2"])
        try:
            assert isinstance(mgr._elector, tw.shards.ShardLeaseElector)
            own = mgr._elector.ownership
            assert all(c.ownership is own for c in mgr._controllers)
            assert all(c.dispatcher._owns is not None
                       for c in mgr._controllers
                       if getattr(c, "dispatcher", None) is not None)
            syncers = [r for r in mgr._runnables
                       if isinstance(r, tw.syncer.UpstreamSyncer)]
            assert syncers and all(s.ownership is own for s in syncers)
            mgr.store.create(_node(tw))
            mgr.start(workers_per_controller=2)
            owned = mgr._elector.owned_shards()
            mgr.store.create(_request(tw, "shard-req"))
            return {"owned": sorted(owned),
                    "state": _wait_running(tw, mgr, "shard-req")}
        finally:
            mgr.stop()

    assert _both(monkeypatch, tmp_path, scenario) == {
        "owned": [0, 1], "state": "Running"}


def test_webhooks_enabled_by_default(monkeypatch, tmp_path):
    def scenario(tw, tmp):
        args, mgr = _build(tw, ["--health-probe-bind-address", ""])
        try:
            mgr.store.create(_request(
                tw, "bad", size=1, allocation_policy="differentnode",
                target_node="worker-0"))
        except tw.validating.AdmissionDenied as e:
            return ("denied", str(e))
        return ("admitted",)

    out = _both(monkeypatch, tmp_path, scenario, ENABLE_WEBHOOKS=None)
    assert out[0] == "denied"


def test_remote_agent_requires_endpoints(monkeypatch, tmp_path):
    def scenario(tw, tmp):
        args, mgr = _build(tw, ["--health-probe-bind-address", ""])
        agents = [c.agent for c in mgr._controllers if hasattr(c, "agent")]
        watchers = [type(r).__name__ for r in mgr._runnables
                    if isinstance(r, tw.watcher.MultiNodeWatcher)]
        return {"remote": [isinstance(a, tw.remote.RemoteNodeAgent)
                           for a in agents], "watchers": watchers}

    out = _both(monkeypatch, tmp_path, scenario, NODE_AGENT="REMOTE")
    assert out == {"remote": [True], "watchers": ["MultiNodeWatcher"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_process(root, tmp_path) -> dict:
    port = _free_port()
    env = dict(os.environ, CDI_PROVIDER_TYPE="MOCK", PYTHONPATH=REPO)
    env.pop("NODE_AGENT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", root, "--health-probe-bind-address",
         f"127.0.0.1:{port}", "--state-dir", str(tmp_path / root / "state")],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30
        up = False
        while time.monotonic() < deadline and not up:
            try:
                up = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=1
                ).status == 200
            except OSError:
                time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        return {"healthz": up, "rc": proc.wait(timeout=30)}
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stderr.close()


def test_process_starts_serves_health_and_exits_on_sigterm(tmp_path):
    """``python -m tpu_composer_torch`` serves /healthz and exits 0 on
    SIGTERM, as ``python -m tpu_composer`` does."""
    outs = [_cli_process(root, tmp_path) for root in (JAX_ROOT, PORT_ROOT)]
    assert outs[0] == outs[1] == {"healthz": True, "rc": 0}


def test_help_names_the_h100_and_every_flag_of_the_reference():
    """``python -m tpu_composer_torch --help`` exits 0 and names the H100;
    the port's flags are the JAX package's (tests/test_torch_isolation.py
    checks that it loads no torch)."""
    res = subprocess.run([sys.executable, "-m", PORT_ROOT, "--help"],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "H100" in res.stdout
    from tpu_composer.cmd.main import build_parser as jax_parser
    from tpu_composer_torch.cmd.main import build_parser as port_parser

    def flags(p):
        return sorted(s for a in p._actions for s in a.option_strings)

    assert flags(port_parser()) == flags(jax_parser())


def _two_replica_traces(tw, tmp):
    tracing = tw.tracing
    tracing.reset()
    try:
        tracing.bind_thread("replica-a")
        with tracing.span("reconcile", cat="controller", trace_id="nonce-42"):
            pass
        doc_a = json.loads(tracing.export_chrome())
        tracing.reset()
        tracing.bind_thread("replica-b")
        with tracing.span("adopt", cat="adoption", trace_id="nonce-42"):
            pass
        doc_b = json.loads(tracing.export_chrome())
    finally:
        tracing.reset()
        if hasattr(tracing._tls, "replica"):
            del tracing._tls.replica
    fa, fb = tmp / "a.json", tmp / "b.json"
    fa.write_text(json.dumps(doc_a))
    fb.write_text(json.dumps(doc_b))
    return fa, fb


def test_trace_merge_merges_and_stitches_files(monkeypatch, tmp_path):
    def scenario(tw, tmp):
        fa, fb = _two_replica_traces(tw, tmp)
        out = tmp / "merged.json"
        rc = tw.cmd.main(["trace-merge", "--out", str(out), str(fa),
                          str(fb)])
        merged = json.loads(out.read_text())
        spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
        flows = [e for e in merged["traceEvents"]
                 if e.get("ph") in ("s", "f") and e["args"].get("stitched")]
        return {"rc": rc, "pids": len({e["pid"] for e in spans}),
                "names": sorted(e["args"]["name"]
                                for e in merged["traceEvents"]
                                if e.get("name") == "process_name"),
                "flows": [(f["ph"], f["args"]["trace_id"]) for f in flows],
                "stitched": merged["metadata"]["stitched_flows"]}

    out = _both(monkeypatch, tmp_path, scenario)
    assert out["rc"] == 0 and out["pids"] == 2 and out["stitched"] == 1
    assert {"replica-a", "replica-b"} <= set(out["names"])
    assert [t for _, t in out["flows"]] == ["nonce-42", "nonce-42"]


def test_trace_merge_unreadable_input_fails_cleanly(monkeypatch, tmp_path,
                                                    capsys):
    def scenario(tw, tmp):
        rc = tw.cmd.main(["trace-merge", str(tmp / "missing.json")])
        return {"rc": rc, "err": "trace-merge:" in capsys.readouterr().err}

    assert _both(monkeypatch, tmp_path, scenario) == {"rc": 1, "err": True}


@pytest.mark.parametrize("how", ["file", "live"])
def test_explain_renders_the_decision_ring(monkeypatch, tmp_path, capsys,
                                           how):
    """``explain <cr>`` renders a placed request's decisions from a live
    operator's health port and from a ``$TPUC_DECISIONS_FILE`` crash dump
    (the port's ``lifecycle.dump_crash`` writes it)."""

    def scenario(tw, tmp):
        dump = tmp / "decisions.json"
        monkeypatch.setenv("TPUC_DECISIONS_FILE", str(dump))
        args, mgr = _build(tw, ["--health-probe-bind-address", "127.0.0.1:0",
                                "--state-dir", str(tmp / "state")])
        try:
            mgr.store.create(_node(tw))
            mgr.start(workers_per_controller=2)
            mgr.store.create(_request(tw, "explained"))
            state = _wait_running(tw, mgr, "explained")
            capsys.readouterr()
            if how == "live":
                rc = tw.cmd.main(["explain", "explained", "--addr",
                                  f"127.0.0.1:{mgr.health_port}"])
            else:
                tw.lifecycle.dump_crash("test")
                rc = tw.cmd.main(["explain", "explained", "--file",
                                  str(dump)])
            text = capsys.readouterr().out
            missing = tw.cmd.main(["explain", "nobody", "--addr",
                                   f"127.0.0.1:{mgr.health_port}"])
        finally:
            mgr.stop()
        return {"state": state, "rc": rc, "missing_rc": missing,
                "placed": "-> placed" in text,
                "header": text.splitlines()[0].split(":")[0],
                "worker": "worker-0" in text}

    out = _both(monkeypatch, tmp_path, scenario)
    assert out == {"state": "Running", "rc": 0, "missing_rc": 1,
                   "placed": True, "header": "explained", "worker": True}
