"""ProcFleet — supervisor for multi-process operator replica fleets (port
of ``tpu_composer/fleet/proc.py``).

Four shard replicas in one interpreter share one GIL. This module spawns N
FULL operator replicas instead — each a real OS process running the exact
command-line wiring (``python -m tpu_composer_torch --shards K``) — against
a shared wire-level store (tpu_composer_torch.sim.apiserver) and a served
fake fabric (tests/torch_fake_fabric.py, the REST pool dialect over the
port's pool, whose slices cover the NVIDIA H100), then gives the test or
harness process lifecycle verbs over them:

- ``spawn()`` / ``drain()`` (SIGTERM + wait) / ``kill()`` (SIGKILL, with a
  pre-kill /debug/traces snapshot so the victim's spans survive the -9) /
  ``restart()``;
- per-replica env/flag templating: every replica gets a stable
  ``--replica-id``, its own artifact directory ($TPUC_FLIGHT_FILE,
  $TPUC_TRACE_FILE, $TPUC_FLEET_FILE per pid) and captured stdout/stderr;
- health-port discovery: replicas bind ``127.0.0.1:0`` and report the real
  port through ``--port-file``, so /debug/fleet, /debug/goodput, /metrics
  and trace-merge work across real pids with zero port races;
- supervisor-side introspection: the apiserver and fabric pool live in
  THIS process, so tests can read lease ownership, in-flight intents and
  the pool's nonce-stamped event log directly (the zero-double-attach
  witness) while the replicas only ever see the wire.

The servers are in-process threads; only the operator replicas are real
processes. A replica imports no torch.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_composer_torch import GROUP, VERSION
from tpu_composer_torch.sim.apiserver import (
    FakeApiServer,
    core_node_doc,
    operator_resources,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class ReplicaProc:
    """One spawned operator replica: the process plus everything the
    supervisor knows about it."""

    name: str
    workdir: str
    proc: Optional[subprocess.Popen] = None
    generation: int = 0
    health_port: Optional[int] = None
    pid: Optional[int] = None
    artifacts: Dict[str, str] = field(default_factory=dict)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ProcFleet:
    """Spawn and drive N real-process operator replicas over one shared
    wire-level store + fabric. Use as a context manager or call close()."""

    def __init__(
        self,
        workdir: str,
        nodes: int = 8,
        chips_per_node: int = 4,
        shards: int = 8,
        expected_replicas: int = 2,
        lease_duration_s: float = 2.0,
        lease_renew_s: float = 0.25,
        namespace: str = "tpu-composer-system",
        workers: int = 8,
        pool_chips: Optional[Dict[str, int]] = None,
        apiserver_latency_s: float = 0.0,
        extra_env: Optional[Dict[str, str]] = None,
        extra_flags: Optional[List[str]] = None,
        netchaos: bool = False,
    ) -> None:
        from tpu_composer_torch.fabric.inmem import InMemoryPool

        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.shards = shards
        self.expected_replicas = expected_replicas
        self.lease_duration_s = lease_duration_s
        self.lease_renew_s = lease_renew_s
        self.namespace = namespace
        self.workers = workers
        self.extra_env = dict(extra_env or {})
        self.extra_flags = list(extra_flags or [])
        self.replicas: Dict[str, ReplicaProc] = {}
        self._lock = threading.RLock()
        self._seq = 0

        # Shared store: the sim apiserver, held in-process so assertions
        # can read etcd-state directly while replicas speak HTTP.
        self.apiserver = FakeApiServer(
            operator_resources(GROUP, VERSION, namespace)
        )
        self.apiserver.latency_s = apiserver_latency_s
        self.apiserver.start()
        self.cr_prefix = f"/apis/{GROUP}/{VERSION}/composabilityrequests"
        self.res_prefix = f"/apis/{GROUP}/{VERSION}/composableresources"
        self.lease_prefix = (
            "/apis/coordination.k8s.io/v1/namespaces/" + namespace + "/leases"
        )
        from tpu_composer_torch.runtime.kubestore import CHIP_RESOURCE

        for i in range(nodes):
            self.apiserver.put_object(
                "/api/v1/nodes",
                core_node_doc(f"node-{i:04d}", chips=chips_per_node,
                              chip_resource=CHIP_RESOURCE),
            )

        # Shared fabric: REST pool service over an in-process InMemoryPool.
        # Chips sized to the whole inventory unless the test says otherwise;
        # pool.poll_events / get_resources are the cross-process
        # double-attach witness (every attach event carries its intent
        # nonce).
        try:
            from tests.torch_fake_fabric import FakeFabricServer
        except ImportError:  # installed-package use: tests/ not on path
            sys.path.insert(0, os.path.join(_REPO_ROOT, "tests"))
            from torch_fake_fabric import FakeFabricServer  # type: ignore
        self.pool = InMemoryPool(
            chips=pool_chips or {"tpu-v4": nodes * chips_per_node}
        )
        self.fabric = FakeFabricServer(pool=self.pool)

        self.kubeconfig = self._write_kubeconfig(
            os.path.join(self.workdir, "kubeconfig.yaml"), self.apiserver.url
        )
        # Wire-fault mode: each replica's store traffic is routed through
        # its own TCP chaos proxy (sim/netchaos.py), so partitions, stalls
        # and corruption can target ONE replica while the others keep a
        # clean wire. Proxies are created lazily in spawn() (one per
        # replica name, reused across restarts so a healed replica comes
        # back through the same — possibly still partitioned — path).
        self.netchaos = netchaos
        self.proxies: Dict[str, Any] = {}

    def _write_kubeconfig(self, path: str, server_url: str) -> str:
        with open(path, "w") as f:
            f.write(
                "apiVersion: v1\nkind: Config\ncurrent-context: sim\n"
                "contexts:\n- name: sim\n  context:\n    cluster: sim\n"
                "clusters:\n- name: sim\n  cluster:\n"
                f"    server: {server_url}\n"
            )
        return path

    def proxy(self, name: str):
        """The ChaosProxy carrying replica ``name``'s store wire (netchaos
        mode only) — the handle tests script faults through."""
        if not self.netchaos:
            raise RuntimeError("ProcFleet(netchaos=True) required")
        proxy = self.proxies.get(name)
        if proxy is None:
            raise KeyError(f"no proxy for replica {name} (never spawned?)")
        return proxy

    # ------------------------------------------------------------------
    # lifecycle verbs
    # ------------------------------------------------------------------
    def spawn(
        self,
        name: Optional[str] = None,
        extra_env: Optional[Dict[str, str]] = None,
        extra_flags: Optional[List[str]] = None,
        wait_ready_s: float = 30.0,
    ) -> ReplicaProc:
        """Launch one full operator replica as a real OS process and wait
        for its health server (port-file discovery + /readyz)."""
        with self._lock:
            if name is None:
                name = f"proc-{self._seq}"
                self._seq += 1
            rep = self.replicas.get(name)
            if rep is not None and rep.alive():
                raise RuntimeError(f"replica {name} already running")
            if rep is None:
                rep = ReplicaProc(
                    name=name, workdir=os.path.join(self.workdir, name)
                )
                self.replicas[name] = rep
            rep.generation += 1

        kubeconfig = self.kubeconfig
        if self.netchaos:
            proxy = self.proxies.get(name)
            if proxy is None:
                from tpu_composer_torch.sim.netchaos import ChaosProxy

                host = urllib.parse.urlsplit(self.apiserver.url)
                proxy = ChaosProxy(
                    host.hostname or "127.0.0.1",
                    host.port or 80,
                    seed=len(self.proxies) + 1,
                )
                self.proxies[name] = proxy
            os.makedirs(rep.workdir, exist_ok=True)
            kubeconfig = self._write_kubeconfig(
                os.path.join(rep.workdir, "kubeconfig.yaml"), proxy.url
            )

        gen_dir = os.path.join(rep.workdir, f"g{rep.generation}")
        os.makedirs(gen_dir, exist_ok=True)
        artifacts = {
            "flight": os.path.join(gen_dir, "flight.json"),
            "trace": os.path.join(gen_dir, "trace.json"),
            "fleet": os.path.join(gen_dir, "fleet.json"),
            "port": os.path.join(gen_dir, "port.json"),
            "log": os.path.join(gen_dir, "log.txt"),
        }
        # A reused workdir (same fleet root across supervisor runs) leaves
        # a prior generation's port file at the same g<N> path; discovery
        # must only ever see the port written by THIS process.
        if os.path.exists(artifacts["port"]):
            os.unlink(artifacts["port"])
        env = dict(os.environ)
        env.update({
            "PYTHONUNBUFFERED": "1",
            "PYTHONPATH": _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", ""),
            # Fabric: the shared REST pool service.
            "CDI_PROVIDER_TYPE": "REST_CM",
            "FABRIC_ENDPOINT": self.fabric.url,
            "NODE_AGENT": "FAKE",
            # Fabric-side attribution: httpx stamps this on every fabric
            # verb (X-Tpuc-Replica), so the supervisor's mutation log can
            # prove WHICH replica mutated the pool — the fencing witness.
            "FABRIC_IDENTITY": name,
            "TPUC_NAMESPACE": self.namespace,
            # Per-replica black boxes: flight recorder, trace ring and
            # fleet view all land beside the log, per pid.
            "TPUC_FLIGHT_FILE": artifacts["flight"],
            "TPUC_TRACE_FILE": artifacts["trace"],
            "TPUC_FLEET_FILE": artifacts["fleet"],
        })
        env.update(self.extra_env)
        env.update(extra_env or {})
        argv = [
            sys.executable, "-m", "tpu_composer_torch",
            "--kubeconfig", kubeconfig,
            "--namespace", self.namespace,
            "--shards", str(self.shards),
            "--shard-replicas", str(self.expected_replicas),
            "--replica-id", name,
            "--lease-duration", str(self.lease_duration_s),
            "--lease-renew-period", str(self.lease_renew_s),
            "--health-probe-bind-address", "127.0.0.1:0",
            "--port-file", artifacts["port"],
            "--workers", str(self.workers),
        ]
        argv += self.extra_flags
        argv += list(extra_flags or [])
        log_f = open(artifacts["log"], "ab")
        try:
            proc = subprocess.Popen(
                argv, stdout=log_f, stderr=subprocess.STDOUT,
                cwd=gen_dir, env=env,
            )
        finally:
            log_f.close()
        rep.proc = proc
        rep.pid = proc.pid
        rep.health_port = None
        rep.artifacts = artifacts
        if wait_ready_s:
            self.wait_ready(name, timeout=wait_ready_s)
        return rep

    def wait_ready(self, name: str, timeout: float = 30.0) -> ReplicaProc:
        """Block until the replica's port file exists and /readyz answers."""
        rep = self.replicas[name]
        deadline = time.monotonic() + timeout
        port_file = rep.artifacts["port"]
        while time.monotonic() < deadline:
            if not rep.alive():
                raise RuntimeError(
                    f"replica {name} exited rc={rep.proc.returncode} during"
                    f" startup; log: {rep.artifacts['log']}\n"
                    + self.tail_log(name)
                )
            if os.path.exists(port_file):
                with open(port_file) as f:
                    doc = json.loads(f.read())
                rep.health_port = int(doc["health_port"])
                break
            time.sleep(0.05)
        else:
            raise TimeoutError(
                f"replica {name}: no port file within {timeout}s\n"
                + self.tail_log(name)
            )
        while time.monotonic() < deadline:
            try:
                self.debug(name, "/readyz", decode_json=False)
                return rep
            except (urllib.error.URLError, OSError):
                time.sleep(0.05)
        raise TimeoutError(f"replica {name}: /readyz never answered")

    def kill(self, name: str, snapshot_traces: bool = True) -> ReplicaProc:
        """kill -9. A SIGKILLed replica never runs its trace-dump atexit
        hooks, so (best-effort) snapshot its /debug/traces ring first —
        that file is the victim's half of the merged failover flow."""
        rep = self.replicas[name]
        if snapshot_traces and rep.alive() and rep.health_port:
            try:
                doc = self.debug(name, "/debug/traces", timeout=5.0)
                snap = os.path.join(
                    os.path.dirname(rep.artifacts["trace"]),
                    "trace.prekill.json",
                )
                with open(snap, "w") as f:
                    json.dump(doc, f)
                rep.artifacts["trace_prekill"] = snap
            except (urllib.error.URLError, OSError, ValueError):
                pass
        if rep.alive():
            os.kill(rep.proc.pid, signal.SIGKILL)
            rep.proc.wait(timeout=10)
        return rep

    def drain(self, name: str, timeout: float = 30.0) -> ReplicaProc:
        """SIGTERM and wait: the graceful path (lease release, dispatcher
        drain, artifact dumps all run). Escalates to SIGKILL on timeout."""
        rep = self.replicas[name]
        if rep.alive():
            rep.proc.send_signal(signal.SIGTERM)
            try:
                rep.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.kill(rep.proc.pid, signal.SIGKILL)
                rep.proc.wait(timeout=10)
        return rep

    def restart(self, name: str, wait_ready_s: float = 30.0) -> ReplicaProc:
        """Fresh process, same stable identity (new artifact generation)."""
        rep = self.replicas[name]
        if rep.alive():
            self.drain(name)
        return self.spawn(name, wait_ready_s=wait_ready_s)

    def stop_all(self) -> None:
        for name in list(self.replicas):
            if self.replicas[name].alive():
                self.drain(name)

    def close(self) -> None:
        self.stop_all()
        for proxy in self.proxies.values():
            proxy.stop()
        self.proxies.clear()
        try:
            self.fabric.close()
        finally:
            self.apiserver.stop()

    def __enter__(self) -> "ProcFleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------------
    # cross-pid introspection
    # ------------------------------------------------------------------
    def live(self) -> List[ReplicaProc]:
        return [r for r in self.replicas.values() if r.alive()]

    def debug(self, name: str, path: str, timeout: float = 10.0,
              decode_json: bool = True) -> Any:
        """GET a /debug, /metrics or probe path on one replica's discovered
        health port."""
        rep = self.replicas[name]
        if rep.health_port is None:
            raise RuntimeError(f"replica {name} has no discovered port")
        url = f"http://127.0.0.1:{rep.health_port}{path}"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read()
        if decode_json:
            try:
                return json.loads(body)
            except ValueError:
                return body.decode(errors="replace")
        return body.decode(errors="replace")

    def metric_total(self, name: str, metric: str) -> float:
        """Sum every sample of ``metric`` from one replica's Prometheus
        text (labels collapsed)."""
        text = self.debug(name, "/metrics", decode_json=False)
        total = 0.0
        for line in text.splitlines():
            if not line.startswith(metric):
                continue
            rest = line[len(metric):]
            if not rest or rest[0] not in "{ ":
                continue  # prefix match on a longer metric name
            try:
                total += float(line.rsplit(None, 1)[-1])
            except ValueError:
                pass
        return total

    def shard_owners(self) -> Dict[int, str]:
        """shard index -> holder identity, read straight from the shared
        store's Lease objects (supervisor-side; no replica involved)."""
        out: Dict[int, str] = {}
        with self.apiserver.state.lock:
            for (prefix, lname), obj in self.apiserver.state.objects.items():
                if prefix != self.lease_prefix or not lname.startswith("shard-"):
                    continue
                holder = (obj.get("spec") or {}).get("holderIdentity", "")
                try:
                    shard = int(lname.split(".", 1)[0][len("shard-"):])
                except ValueError:
                    continue
                if holder:
                    out[shard] = holder
        return out

    def in_flight_intents(self) -> Dict[str, int]:
        """replica identity -> count of CRs with a durable pending_op
        (status.pending_op) in shards that replica currently owns — the
        'replica owning the most in-flight intents' victim metric."""
        from tpu_composer_torch.runtime.shards import shard_for

        owners = self.shard_owners()
        counts: Dict[str, int] = {}
        with self.apiserver.state.lock:
            items = [
                (lname, obj)
                for (prefix, lname), obj in self.apiserver.state.objects.items()
                if prefix == self.res_prefix
            ]
        for lname, obj in items:
            if not (obj.get("status") or {}).get("pending_op"):
                continue
            owner = owners.get(shard_for(lname, self.shards))
            if owner:
                counts[owner] = counts.get(owner, 0) + 1
        return counts

    def tail_log(self, name: str, lines: int = 40) -> str:
        rep = self.replicas[name]
        try:
            with open(rep.artifacts["log"], "r", errors="replace") as f:
                return "".join(f.readlines()[-lines:])
        except OSError:
            return "<no log>"

    # ------------------------------------------------------------------
    # artifact collection
    # ------------------------------------------------------------------
    def trace_files(self) -> List[str]:
        """Every per-pid Chrome trace artifact written so far: graceful
        dumps (TPUC_TRACE_FILE) and pre-kill snapshots, across every
        replica and generation."""
        out: List[str] = []
        for rep in self.replicas.values():
            base = rep.workdir
            if not os.path.isdir(base):
                continue
            for gen in sorted(os.listdir(base)):
                for fname in ("trace.json", "trace.prekill.json"):
                    p = os.path.join(base, gen, fname)
                    if os.path.exists(p) and os.path.getsize(p) > 0:
                        out.append(p)
        return out

    def merged_trace(self) -> Dict[str, Any]:
        """One Chrome trace document stitching every replica's spans —
        real pids, stable process names, cross-pid flow arrows (the
        trace-merge subcommand's library path)."""
        from tpu_composer_torch.runtime import tracing

        paths = self.trace_files()
        if not paths:
            raise RuntimeError("no trace artifacts collected yet")
        return tracing.merge_files(paths)

    def artifact_index(self) -> Dict[str, Dict[str, str]]:
        return {name: dict(rep.artifacts) for name, rep in self.replicas.items()}
