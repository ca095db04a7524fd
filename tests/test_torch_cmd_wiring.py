"""The command line's store, decision and maintenance wiring against the
JAX package's: the ``cmd.main`` cases of tests/test_decisions.py (the
``explain`` CLI over a live operator's health port and over a decision
ring dump), tests/test_chaosstore.py (``build_store`` wraps the chaos
injector only when a knob is on), tests/test_kubestore.py
(``--kubeconfig`` selects ``KubeStore``, which reaches the apiserver) and
tests/test_migration.py's ``test_node_name_is_immutable`` (the
NodeMaintenance webhook: ``spec.node_name`` is immutable, one drain per
node).

Each scenario runs once per package (``run_both``, each package's own
apiserver where there is one) and returns exit codes, wrapper types and
knobs, and the rendered text's key lines. Tolerance: exact.
"""

from __future__ import annotations

import pytest
import torch
import yaml

from tests.test_torch_decisions import _story
from tests.torch_operator import outcome, run_both

torch.set_num_threads(1)

GROUP, VERSION = "tpu.composer.dev", "v1alpha1"


def test_explain_cli_from_live_operator_and_dump(tmp_path, capsys):
    def scenario(tw):
        w = _story(tw)
        led = w.req_rec.scheduler.ledger
        mgr = tw.manager.Manager(store=w.store, health_addr="127.0.0.1:0",
                                 decisions=led)
        mgr.start()
        capsys.readouterr()
        try:
            live_rc = tw.cmd.main(["explain", "starved", "--addr",
                                   f"127.0.0.1:{mgr.health_port}"])
            live = capsys.readouterr().out
        finally:
            mgr.stop()
        path = str(tmp_path / f"{tw.root}-decisions.json")
        led.dump(path)
        file_rc = tw.cmd.main(["explain", "inference", "--file", path])
        offline = capsys.readouterr().out
        ghost_rc = tw.cmd.main(["explain", "ghost", "--file", path])
        json_rc = tw.cmd.main(["explain", "inference", "--file", path,
                               "--json"])
        as_json = capsys.readouterr().out
        return {"rcs": [live_rc, file_rc, ghost_rc, json_rc],
                "live": ["held-back" in live, "tpu-ports" in live],
                "offline": ["preempting" in offline, "frag" in offline],
                "header": offline.splitlines()[0],
                "json": as_json.lstrip().startswith("{")}

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out["rcs"] == [0, 0, 1, 0]
    assert all(port_out["live"]) and all(port_out["offline"])


def test_cmd_wiring_builds_chaos_store(tmp_path):
    def scenario(tw):
        args = tw.cmd.build_parser().parse_args([
            "--chaos-store-failure-rate", "0.25", "--chaos-store-seed", "42",
            "--state-dir", str(tmp_path / tw.root / "s")])
        chained = tw.cmd.build_store(args)
        bare = tw.cmd.build_store(tw.cmd.build_parser().parse_args(
            ["--state-dir", str(tmp_path / tw.root / "s2")]))
        return {"chaos": isinstance(chained, tw.chaosstore.ChaosStore),
                "rate": chained.failure_rate,
                "inner": type(chained._inner).__name__,
                "bare": type(bare).__name__}

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out == {"chaos": True, "rate": 0.25, "inner": "Store",
                        "bare": "Store"}


def test_build_store_selects_kubestore(tmp_path):
    def scenario(tw):
        srv = tw.apiserver.FakeApiServer(
            tw.apiserver.operator_resources(GROUP, VERSION))
        srv.start()
        kc = tmp_path / f"{tw.root}.kubeconfig"
        kc.write_text(yaml.safe_dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "test",
            "contexts": [{"name": "test",
                          "context": {"cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {"server": srv.url}}],
            "users": [{"name": "u", "user": {"token": "dummy"}}]}))
        try:
            store = tw.cmd.build_store(tw.cmd.build_parser().parse_args(
                ["--kubeconfig", str(kc)]))
            try:
                return {"kube": isinstance(store, tw.kubestore.KubeStore),
                        "listed": store.list(tw.types.ComposabilityRequest)}
            finally:
                store.close()
        finally:
            srv.stop()

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out == {"kube": True, "listed": []}


def test_node_name_is_immutable():
    def scenario(tw):
        store = tw.store.Store()
        tw.validating.register_validating_webhooks(store)
        m = tw.maintenance

        def maint(name, node):
            return m.NodeMaintenance(metadata=tw.meta.ObjectMeta(name=name),
                                     spec=m.NodeMaintenanceSpec(node_name=node))

        out = [outcome(lambda: store.create(maint("mx", "worker-0")).name)]
        mx = store.get(m.NodeMaintenance, "mx")
        mx.spec.node_name = "worker-1"
        out.append(outcome(store.update, mx))
        out.append(outcome(store.create, maint("mx2", "worker-0")))
        out.append(outcome(lambda: store.create(maint("my", "worker-2")).name))
        return out

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out[0] == "mx" and port_out[3] == "my"
    for denied in port_out[1:3]:
        assert denied[:2] == ["raised", "AdmissionDenied"]
    assert "immutable" in port_out[1][2]
    assert "already drains worker-0" in port_out[2][2]


@pytest.mark.parametrize("phase", ["CREATE", "UPDATE"])
def test_maintenance_webhook_validates_the_spec(phase):
    """An invalid NodeMaintenance (no node) is refused by the webhook on
    create, and on an update that clears the node."""

    def scenario(tw):
        store = tw.store.Store()
        tw.validating.register_validating_webhooks(store)
        m = tw.maintenance
        obj = m.NodeMaintenance(metadata=tw.meta.ObjectMeta(name="mx"),
                                spec=m.NodeMaintenanceSpec(
                                    node_name="" if phase == "CREATE"
                                    else "worker-0"))
        if phase == "CREATE":
            return outcome(store.create, obj)
        store.create(obj)
        obj = store.get(m.NodeMaintenance, "mx")
        obj.spec.node_name = ""
        return outcome(store.update, obj)

    jax_out, port_out = run_both(scenario)
    assert jax_out == port_out
    assert port_out[0] == "raised"
