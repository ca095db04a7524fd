"""FakeNodeAgent — the injectable node world for tests and benches.

Replaces the reference's gomonkey SPDY-executor interception
(composableresource_controller_test.go:2702-2713) with a real implementation
of the NodeAgent interface. Optionally wired to an InMemoryPool so chip
visibility follows fabric attachment the way real hosts behave (a chip
enumerates as /dev/accelN only after the fabric programs the link), plus
explicit knobs for every failure mode the reference's canned-output tests
cover: missing driver, delayed visibility, stuck loads, taint state.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from tpu_composer_torch.agent.cdi import CdiSpec
from tpu_composer_torch.agent.nodeagent import (
    AgentError,
    DeviceBusyError,
    DriverType,
    NodeAgent,
)


class FakeNodeAgent(NodeAgent):
    def __init__(self, pool=None, fabric=None, fabric_ttl_s: float = 0.05) -> None:
        self._pool = pool  # InMemoryPool or None
        # Wire-mode visibility: when the pool lives in another process
        # (proc-mode fleet, REST provider), chip enumeration follows the
        # fabric's own attachment listing via provider.get_resources().
        # A short TTL cache keeps visibility polls from hammering the
        # fabric service during wide attach waves.
        self._fabric = fabric  # FabricProvider or None
        self._fabric_ttl_s = fabric_ttl_s
        self._fabric_cache: Optional[Dict[str, Set[str]]] = None
        self._fabric_cache_at = 0.0
        self._lock = threading.RLock()
        self._drivers: Dict[str, str] = {}  # node -> DriverType (default HOST)
        self._no_driver: Set[str] = set()
        self._visible: Dict[str, Set[str]] = {}  # node -> device ids (pool-less mode)
        self._visibility_delay: Dict[str, int] = {}  # node -> polls until visible
        self._loads: Dict[str, Set[str]] = {}  # node -> busy device ids
        self._taints: Dict[str, str] = {}  # device id -> reason
        self._published: Dict[str, Dict[str, CdiSpec]] = {}  # node -> name -> spec
        self.drain_calls: List[tuple] = []
        # Detach-path failure personas (the reference's Detaching-tree
        # canned failures, composableresource_controller_test.go):
        self._linger: Dict[str, int] = {}  # node -> polls chips keep enumerating
        self._load_check_fails: Dict[str, int] = {}  # node -> raising polls
        self._taint_cleanup_fails: Dict[str, int] = {}  # node -> raising calls

    # ------------------------------------------------------------------
    # NodeAgent interface
    # ------------------------------------------------------------------
    def ensure_driver(self, node: str) -> str:
        with self._lock:
            if node in self._no_driver:
                raise AgentError(f"no libtpu on {node}")
            return self._drivers.get(node, DriverType.HOST)

    def check_visible(self, node: str, device_ids: List[str], group: str = "") -> bool:
        with self._lock:
            if self._linger.get(node, 0) > 0 and device_ids:
                # Fabric already released the chips but the host's device
                # nodes haven't dropped yet ("ResourceSlice is still
                # visible", reference :5533) — detach must loop, not finish.
                self._linger[node] -= 1
                return True
            delay = self._visibility_delay.get(node, 0)
            if delay > 0:
                self._visibility_delay[node] = delay - 1
                return False
            if self._pool is not None:
                attached = set(self._pool.attached_to(node))
            elif self._fabric is not None:
                attached = self._fabric_attached().get(node, set())
            else:
                attached = self._visible.get(node, set())
            return bool(device_ids) and set(device_ids) <= attached

    def _fabric_attached(self) -> Dict[str, Set[str]]:
        """node -> attached device ids, via the wire provider (TTL-cached).
        Caller holds self._lock."""
        import time as _time

        now = _time.monotonic()
        if (
            self._fabric_cache is None
            or now - self._fabric_cache_at >= self._fabric_ttl_s
        ):
            try:
                listing = self._fabric.get_resources()
            except Exception:
                if self._fabric_cache is not None:
                    return self._fabric_cache  # stale beats a crashed poll
                raise
            out: Dict[str, Set[str]] = {}
            for d in listing:
                out.setdefault(d.node, set()).add(d.device_id)
            self._fabric_cache = out
            self._fabric_cache_at = now
        return self._fabric_cache

    def check_no_loads(self, node: str, device_ids: List[str], group: str = "") -> bool:
        with self._lock:
            if self._load_check_fails.get(node, 0) > 0:
                # The probe itself failing (nvidia-smi erroring in the
                # reference, :4303) is an AgentError, not "busy".
                self._load_check_fails[node] -= 1
                raise AgentError(f"load probe failed on {node}")
            busy = self._loads.get(node, set())
            return not (busy & set(device_ids))

    def drain(self, node: str, device_ids: List[str], force: bool = False, group: str = "") -> None:
        with self._lock:
            self.drain_calls.append((node, tuple(device_ids), force))
            busy = self._loads.get(node, set()) & set(device_ids)
            if busy and not force:
                raise DeviceBusyError(f"{node}: open handles on {sorted(busy)}")
            if force:
                self._loads.get(node, set()).difference_update(device_ids)
            self._visible.get(node, set()).difference_update(device_ids)

    def refresh_device_stack(self, node, spec: Optional[CdiSpec] = None, remove_name: str = ""):
        with self._lock:
            pubs = self._published.setdefault(node, {})
            if spec is not None:
                pubs[spec.name] = spec
            if remove_name:
                pubs.pop(remove_name, None)

    def create_device_taint(self, node, device_ids, reason):
        with self._lock:
            for d in device_ids:
                self._taints[d] = reason

    def delete_device_taint(self, node, device_ids):
        with self._lock:
            if self._taint_cleanup_fails.get(node, 0) > 0:
                self._taint_cleanup_fails[node] -= 1
                raise AgentError(f"taint cleanup failed on {node}")
            for d in device_ids:
                self._taints.pop(d, None)

    def has_device_taint(self, node, device_id) -> bool:
        with self._lock:
            return device_id in self._taints

    # ------------------------------------------------------------------
    # test knobs
    # ------------------------------------------------------------------
    def set_lingering(self, node: str, polls: int) -> None:
        """Chips keep enumerating for N visibility polls after detach."""
        with self._lock:
            self._linger[node] = polls

    def fail_load_check(self, node: str, times: int = 1) -> None:
        with self._lock:
            self._load_check_fails[node] = times

    def fail_taint_cleanup(self, node: str, times: int = 1) -> None:
        with self._lock:
            self._taint_cleanup_fails[node] = times

    def set_no_driver(self, node: str, missing: bool = True) -> None:
        with self._lock:
            if missing:
                self._no_driver.add(node)
            else:
                self._no_driver.discard(node)

    def set_driver_type(self, node: str, driver: str) -> None:
        with self._lock:
            self._drivers[node] = driver

    def set_visible(self, node: str, device_ids: List[str]) -> None:
        """Pool-less mode: mark chips as enumerating on the host."""
        with self._lock:
            self._visible.setdefault(node, set()).update(device_ids)

    def set_visibility_delay(self, node: str, polls: int) -> None:
        """Chip shows up only after N visibility checks (slow PCIe rescan)."""
        with self._lock:
            self._visibility_delay[node] = polls

    def add_load(self, node: str, device_id: str) -> None:
        with self._lock:
            self._loads.setdefault(node, set()).add(device_id)

    def clear_loads(self, node: str) -> None:
        with self._lock:
            self._loads.pop(node, None)

    def published(self, node: str) -> List[str]:
        with self._lock:
            return sorted(self._published.get(node, {}))

    def published_spec(self, node: str, name: str) -> Optional[CdiSpec]:
        with self._lock:
            return self._published.get(node, {}).get(name)

    def taints(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._taints)
