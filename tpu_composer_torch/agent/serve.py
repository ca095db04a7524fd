"""Node-agent RPC service — the controller↔node transport (port of
``tpu_composer/agent/serve.py``).

The reference actuates nodes by `pods/exec` (SPDY) into privileged pods and
shelling nvidia-smi/modprobe (utils/gpus.go:1040-1067). Our node agent is a
small HTTP service running on each node (the DaemonSet in
deploy/node-agent.yaml) exposing the NodeAgent interface as JSON POSTs:

    POST /v1/<method>   {args...} -> {"result": ...} | {"error","kind"}
    GET  /healthz

The wire protocol is deliberately dumb — one POST per NodeAgent method, all
idempotent, no streaming — so the seam stays as testable as the in-process
interface (a dependency-injection seam, not exec interception).
``RemoteNodeAgent`` (remote.py) is the client side.

A CDI spec crosses the wire as ``spec_to_wire`` writes it: a TPU group's
exactly as the JAX package writes it, a GPU group's with its class and
its mounts besides (the driver libraries ``agent/cdi.py`` lists).

Run on a node: ``python -m tpu_composer_torch.agent.serve --bind 0.0.0.0:9444``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpu_composer_torch.agent import cdi as cdimod
from tpu_composer_torch.agent.nodeagent import (
    MAX_WATCH_S,
    AgentError,
    DeviceBusyError,
    LocalNodeAgent,
    NodeAgent,
)

# Methods exposed over the wire; each maps 1:1 onto NodeAgent.
_METHODS = frozenset(
    {
        "ensure_driver",
        "check_visible",
        "check_no_loads",
        "drain",
        "refresh_device_stack",
        "create_device_taint",
        "delete_device_taint",
        "has_device_taint",
        "wait_device_event",
    }
)


def spec_to_wire(spec: cdimod.CdiSpec) -> dict:
    out = {
        "name": spec.name,
        "device_nodes": list(spec.device_nodes),
        "env": dict(spec.env),
        "libtpu_host_path": spec.libtpu_host_path,
    }
    if spec.cdi_class != cdimod.CDI_CLASS:
        out["cdi_class"] = spec.cdi_class
    if spec.mounts:
        out["mounts"] = [list(m) for m in spec.mounts]
    return out


def spec_from_wire(d: dict) -> cdimod.CdiSpec:
    return cdimod.CdiSpec(
        name=d["name"],
        device_nodes=list(d.get("device_nodes", [])),
        env=dict(d.get("env", {})),
        libtpu_host_path=d.get("libtpu_host_path", cdimod.DEFAULT_LIBTPU_PATH),
        cdi_class=d.get("cdi_class", cdimod.CDI_CLASS),
        mounts=[(host, container) for host, container in d.get("mounts", [])],
    )


class AgentServer:
    """Serves one NodeAgent over HTTP (one instance per node)."""

    def __init__(self, agent: NodeAgent, bind: str = "127.0.0.1:0") -> None:
        self.agent = agent
        host, _, port = bind.rpartition(":")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                if not self.path.startswith("/v1/"):
                    return self._send(404, {"error": f"no route {self.path}"})
                method = self.path[len("/v1/"):]
                if method not in _METHODS:
                    return self._send(404, {"error": f"unknown method {method}"})
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    args = json.loads(self.rfile.read(length)) if length else {}
                except ValueError:
                    return self._send(400, {"error": "bad JSON body"})
                try:
                    result = server._call(method, args)
                except DeviceBusyError as e:
                    return self._send(409, {"error": str(e), "kind": "busy"})
                except AgentError as e:
                    return self._send(500, {"error": str(e), "kind": "agent"})
                self._send(200, {"result": result})

            def _send(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
        self._thread: Optional[threading.Thread] = None

    def _call(self, method: str, args: dict):
        node = args.get("node", "")
        if method == "ensure_driver":
            return self.agent.ensure_driver(node)
        if method == "check_visible":
            return self.agent.check_visible(
                node, list(args.get("device_ids", [])), group=args.get("group", "")
            )
        if method == "check_no_loads":
            return self.agent.check_no_loads(
                node, list(args.get("device_ids", [])), group=args.get("group", "")
            )
        if method == "drain":
            self.agent.drain(
                node,
                list(args.get("device_ids", [])),
                force=bool(args.get("force", False)),
                group=args.get("group", ""),
            )
            return True
        if method == "refresh_device_stack":
            spec = args.get("spec")
            self.agent.refresh_device_stack(
                node,
                spec=spec_from_wire(spec) if spec else None,
                remove_name=args.get("remove_name", ""),
            )
            return True
        if method == "create_device_taint":
            self.agent.create_device_taint(
                node, list(args.get("device_ids", [])), args.get("reason", "")
            )
            return True
        if method == "delete_device_taint":
            self.agent.delete_device_taint(node, list(args.get("device_ids", [])))
            return True
        if method == "has_device_taint":
            return self.agent.has_device_taint(node, args.get("device_id", ""))
        if method == "wait_device_event":
            # Long-poll: blocks this handler thread (ThreadingHTTPServer) up
            # to the capped timeout. Agents without a watch capability
            # (NodeAgent's default) answer False so callers degrade to
            # polling — the DeviceEventWatcher throttles that fast-False.
            try:
                timeout = min(max(0.0, float(args.get("timeout", 1.0))),
                              MAX_WATCH_S)
            except (TypeError, ValueError) as e:
                raise AgentError(f"bad wait_device_event timeout: {e}") from e
            return bool(self.agent.wait_device_event(node, timeout=timeout))
        raise AgentError(f"unhandled method {method}")  # pragma: no cover

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address
        return f"{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="node-agent", daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:  # pragma: no cover - CLI path
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def main(argv=None) -> int:  # pragma: no cover - CLI path
    p = argparse.ArgumentParser(prog="tpu-composer-node-agent")
    p.add_argument("--bind", default="0.0.0.0:9444")
    p.add_argument("--dev-dir", default="/dev")
    p.add_argument("--proc-dir", default="/host-proc")
    p.add_argument("--cdi-dir", default=cdimod.DEFAULT_CDI_DIR)
    p.add_argument("--state-dir", default="/var/run/tpu-composer")
    p.add_argument(
        "--device-plugin-dir",
        default=os.environ.get("DEVICE_PLUGIN_DIR", ""),
        help="kubelet device-plugin dir (e.g. /var/lib/kubelet/device-plugins);"
             " empty disables the device plugin",
    )
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    agent = LocalNodeAgent(
        dev_dir=args.dev_dir,
        proc_dir=args.proc_dir,
        cdi_dir=args.cdi_dir,
        state_dir=args.state_dir,
    )
    server = AgentServer(agent, bind=args.bind)
    logging.getLogger("node-agent").info(
        "serving on %s (native library %s)", server.address,
        agent._native.path if agent._native is not None else None)
    plugin = None
    if args.device_plugin_dir:
        # Composed chips become a schedulable extended resource straight from
        # this agent's CDI claim state (agent/plugin.py); the operator's
        # attach/detach RPCs land in refresh_device_stack, whose claims the
        # lister reads, so ListAndWatch pushes follow automatically.
        from tpu_composer_torch.agent.plugin import (
            TPUDevicePlugin,
            lister_from_agent,
        )

        plugin = TPUDevicePlugin(
            lister_from_agent(agent),
            args.device_plugin_dir,
            node_name=os.environ.get("NODE_NAME", ""),
        )
        plugin.start()
        try:
            plugin.register_with_kubelet()
        except Exception as e:  # kubelet may not be up yet; it re-dials plugins
            logging.getLogger("node-agent").warning(
                "kubelet registration failed (will rely on kubelet restart): %s", e
            )

    def handle_signal(signum, frame):
        # serve_forever runs on this thread: shutdown() must come from
        # another, or it waits on itself.
        threading.Thread(target=server._httpd.shutdown, name="agent-stop",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    server.serve_forever()
    server._httpd.server_close()
    if plugin is not None:
        plugin.stop()
    logging.getLogger("node-agent").info("stopped")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
