"""RemoteNodeAgent — client side of the node-agent RPC seam (port of
``tpu_composer/agent/remote.py``).

Implements the NodeAgent interface by routing each call to the target node's
agent service (serve.py), resolving endpoints from ``Node.spec.agent_endpoint``
in the store. This replaces the reference's controller→node transport
(pods/exec SPDY + chroot, utils/gpus.go:996-1067) with a typed HTTP seam.

Error mapping mirrors the server: 409/kind=busy → DeviceBusyError (the
open-fd drain guard), other agent failures → AgentError, transport failures →
AgentError (a dead agent reads the same as a dead node, which is what the
controllers' GC paths expect).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Callable, List, Optional

from tpu_composer_torch.agent import cdi as cdimod
from tpu_composer_torch.agent.nodeagent import (
    MAX_WATCH_S,
    AgentError,
    DeviceBusyError,
    NodeAgent,
)
from tpu_composer_torch.agent.serve import spec_to_wire


class RemoteNodeAgent(NodeAgent):
    def __init__(
        self,
        resolver: Callable[[str], str],
        timeout: float = 30.0,
    ) -> None:
        """``resolver(node) -> "host:port"`` of that node's agent service."""
        self._resolve = resolver
        self.timeout = timeout

    @classmethod
    def from_store(
        cls,
        store,
        timeout: float = 30.0,
        endpoint_template: str = "",
    ) -> "RemoteNodeAgent":
        """Resolve endpoints from ``Node.spec.agent_endpoint``, falling back
        to ``endpoint_template`` (e.g. ``{node}:9444``, the node-agent
        DaemonSet's hostPort) for nodes that never registered one —
        NODE_AGENT_ENDPOINT_TEMPLATE in deploy/manager.yaml."""
        from tpu_composer_torch.api.types import Node

        def resolver(node: str) -> str:
            obj = store.try_get(Node, node)
            if obj is not None and obj.spec.agent_endpoint:
                return obj.spec.agent_endpoint
            if endpoint_template:
                return endpoint_template.format(node=node)
            raise AgentError(f"node {node}: no agent endpoint registered")

        return cls(resolver, timeout=timeout)

    # ------------------------------------------------------------------
    def _call(self, node: str, method: str, _transport_timeout=None, **args):
        endpoint = self._resolve(node)
        url = f"http://{endpoint}/v1/{method}"
        body = json.dumps({"node": node, **args}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=_transport_timeout or self.timeout
            ) as resp:
                return json.loads(resp.read()).get("result")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except ValueError:
                payload = {}
            message = payload.get("error", f"HTTP {e.code}")
            if payload.get("kind") == "busy":
                raise DeviceBusyError(message) from e
            raise AgentError(f"{node} agent: {message}") from e
        except (urllib.error.URLError, OSError) as e:
            raise AgentError(f"{node} agent unreachable at {endpoint}: {e}") from e

    # -- NodeAgent interface -----------------------------------------------
    def ensure_driver(self, node: str) -> str:
        return self._call(node, "ensure_driver")

    def check_visible(self, node: str, device_ids: List[str], group: str = "") -> bool:
        return bool(
            self._call(node, "check_visible", device_ids=device_ids, group=group)
        )

    def check_no_loads(self, node: str, device_ids: List[str], group: str = "") -> bool:
        return bool(
            self._call(node, "check_no_loads", device_ids=device_ids, group=group)
        )

    def drain(self, node: str, device_ids: List[str], force: bool = False,
              group: str = "") -> None:
        self._call(node, "drain", device_ids=device_ids, force=force, group=group)

    def refresh_device_stack(
        self,
        node: str,
        spec: Optional[cdimod.CdiSpec] = None,
        remove_name: str = "",
    ) -> None:
        self._call(
            node,
            "refresh_device_stack",
            spec=spec_to_wire(spec) if spec is not None else None,
            remove_name=remove_name,
        )

    def create_device_taint(self, node: str, device_ids: List[str], reason: str) -> None:
        self._call(node, "create_device_taint", device_ids=device_ids, reason=reason)

    def delete_device_taint(self, node: str, device_ids: List[str]) -> None:
        self._call(node, "delete_device_taint", device_ids=device_ids)

    def has_device_taint(self, node: str, device_id: str) -> bool:
        return bool(self._call(node, "has_device_taint", device_id=device_id))

    def wait_device_event(self, node: str, timeout: float = 1.0) -> bool:
        """Long-poll the node's /dev watch. A per-node DeviceEventWatcher
        wraps this for event-driven reconciles in cluster mode. The timeout
        is clamped to the shared MAX_WATCH_S cap the server enforces — a
        larger request would silently become unwatched sleep on this side —
        and the transport timeout is padded to outlive the server-side
        wait."""
        timeout = min(max(0.0, timeout), MAX_WATCH_S)
        return bool(self._call(node, "wait_device_event", timeout=timeout,
                               _transport_timeout=timeout + 5.0))
