"""API types (port of ``tpu_composer/api/types.py``): only
:class:`SliceStatus` so far, the composed slice that the coordinate env
(``admission/coordinates.py``) is derived from. The other kinds,
``ComposabilityRequest`` and ``ComposableResource`` with their specs and
statuses, wait for the control plane's port."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class SliceStatus:
    """The composed-slice view used for coordinate injection: the
    allocator's authoritative record of a slice's hosts, in worker
    order."""

    name: str = ""
    topology: str = ""
    num_hosts: int = 0
    chips_per_host: int = 0
    worker_hostnames: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.name:
            d["name"] = self.name
        if self.topology:
            d["topology"] = self.topology
        if self.num_hosts:
            d["num_hosts"] = self.num_hosts
        if self.chips_per_host:
            d["chips_per_host"] = self.chips_per_host
        if self.worker_hostnames:
            d["worker_hostnames"] = list(self.worker_hostnames)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SliceStatus":
        return cls(
            name=d.get("name", ""),
            topology=d.get("topology", ""),
            num_hosts=int(d.get("num_hosts", 0)),
            chips_per_host=int(d.get("chips_per_host", 0)),
            worker_hostnames=list(d.get("worker_hostnames", [])),
        )
