"""Node/device plumbing (port of ``tpu_composer/agent/``): the node agent,
its fake, its native scan library, its RPC daemon and client, the device
event watchers, the kubelet device plugin, the device publisher and the
CDI spec.

The node agent owns per-chip device visibility (``/dev/accel*`` and
``/dev/vfio/*`` on a TPU host, ``/dev/nvidia<minor>`` on an NVIDIA host),
writes CDI specs, scans ``/proc`` for open device fds before drain, and
quarantines devices during detach. Two implementations share the NodeAgent
interface in process: LocalNodeAgent (real host operations, with the
native library of ``native/gpunode.cc`` built at first use by
``native.py``) and FakeNodeAgent (an in-memory world for tests); a third,
RemoteNodeAgent (``remote.py``), reaches a node's LocalNodeAgent over HTTP
(``serve.py``, ``python -m tpu_composer_torch.agent.serve``), whose daemon
can also serve the kubelet device plugin (``plugin.py``).
"""

from tpu_composer_torch.agent.nodeagent import (
    AgentError,
    DeviceBusyError,
    DriverType,
    LocalNodeAgent,
    NodeAgent,
)
from tpu_composer_torch.agent.fake import FakeNodeAgent
from tpu_composer_torch.agent.cdi import CdiSpec, generate_cdi_spec

__all__ = [
    "AgentError",
    "DeviceBusyError",
    "DriverType",
    "LocalNodeAgent",
    "NodeAgent",
    "FakeNodeAgent",
    "CdiSpec",
    "generate_cdi_spec",
]
