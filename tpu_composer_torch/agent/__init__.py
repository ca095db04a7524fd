"""Node/device plumbing (port of ``tpu_composer/agent/``): the node agent,
its fake, the device publisher and the CDI spec.

The node agent owns per-chip device visibility (``/dev/accel*`` and
``/dev/vfio/*`` on a TPU host, ``/dev/nvidia<minor>`` on an NVIDIA host),
writes CDI specs, scans ``/proc`` for open device fds before drain, and
quarantines devices during detach. Two implementations share the NodeAgent
interface: LocalNodeAgent (real host operations, pure Python) and
FakeNodeAgent (an in-memory world for tests). The native scan library, the
RPC agent and the kubelet plugin arrive with the edges sub-slice.
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
