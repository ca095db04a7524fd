"""CDI (Container Device Interface) spec generation for chip groups (port
of ``tpu_composer/agent/cdi.py``), TPU and NVIDIA GPU.

A composed chip group is published to container runtimes as a CDI spec,
one JSON document per group, exposing:

- the chips' device nodes: ``/dev/accel<N>`` (or vfio nodes) for TPU
  chips; for NVIDIA GPUs ``/dev/nvidia<k>`` for each GPU ordinal ``k``
  (the host's k-th GPU) plus NVIDIA's control nodes ``/dev/nvidiactl``,
  ``/dev/nvidia-uvm`` and ``/dev/nvidia-uvm-tools``;
- the user-space library the framework drives the chips through:
  ``libtpu.so`` for TPUs; for GPUs CUDA's ``libcuda.so.1`` and NVML,
  ``libnvidia-ml.so.1``;
- the coordinate env (``admission/coordinates.slice_env``) so the job
  sees its slice.

A GPU's device node is named by its minor number, and a minor is not an
ordinal: a host, or a container that sees some of its GPUs, may list
``/dev/nvidia0`` and ``/dev/nvidia3`` only. The spec built here names
ordinals; the node agent that publishes it (``agent/nodeagent.py``,
``LocalNodeAgent.refresh_device_stack``) rebases each ordinal onto the
minor of the host's GPU of that ordinal, from the driver's listing, so the
file a container runtime reads names the real nodes.

Spec layout follows the CDI 0.6 schema (cdi.k8s.io), so real container
runtimes (containerd/CRI-O with CDI enabled) can consume it unchanged.
TPU groups are devices of class ``tpu``, GPU groups of class ``gpu``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tpu_composer_torch.topology.slices import GPU_MODELS, is_gpu_model

CDI_VERSION = "0.6.0"
CDI_VENDOR = "tpu.composer.dev"
CDI_CLASS = "tpu"
CDI_CLASS_GPU = "gpu"
DEFAULT_CDI_DIR = "/var/run/cdi"
DEFAULT_LIBTPU_PATH = "/lib/libtpu.so"
#: NVIDIA's control nodes, which every CUDA process opens beside its GPUs'.
NVIDIA_CONTROL_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm",
                        "/dev/nvidia-uvm-tools")
#: CUDA's and NVML's user-space libraries, where an x86-64 host has them,
#: mounted at the same path.
NVIDIA_DRIVER_LIBS = ("/usr/lib/x86_64-linux-gnu/libcuda.so.1",
                      "/usr/lib/x86_64-linux-gnu/libnvidia-ml.so.1")
_MOUNT_OPTIONS = ["ro", "nosuid", "nodev", "bind"]


@dataclass
class CdiSpec:
    """One chip-group's CDI document. ``mounts`` are (host path,
    container path) pairs; without them the group mounts libtpu."""

    name: str  # device name within the vendor/class, e.g. "slice-req1-worker0"
    device_nodes: List[str]
    env: Dict[str, str] = field(default_factory=dict)
    libtpu_host_path: str = DEFAULT_LIBTPU_PATH
    cdi_class: str = CDI_CLASS
    mounts: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def qualified_name(self) -> str:
        return f"{CDI_VENDOR}/{self.cdi_class}={self.name}"

    def to_dict(self) -> Dict:
        mounts = self.mounts or [(self.libtpu_host_path, DEFAULT_LIBTPU_PATH)]
        return {
            "cdiVersion": CDI_VERSION,
            "kind": f"{CDI_VENDOR}/{self.cdi_class}",
            "devices": [
                {
                    "name": self.name,
                    "containerEdits": {
                        "deviceNodes": [{"path": p} for p in self.device_nodes],
                        "mounts": [
                            {
                                "hostPath": host,
                                "containerPath": container,
                                "options": list(_MOUNT_OPTIONS),
                            }
                            for host, container in mounts
                        ],
                        "env": [f"{k}={v}" for k, v in sorted(self.env.items())],
                    },
                }
            ],
        }


def generate_cdi_spec(
    slice_name: str,
    worker_id: int,
    chip_indices: List[int],
    env: Optional[Dict[str, str]] = None,
    use_vfio: bool = False,
    model: str = "",
) -> CdiSpec:
    """Build the spec for one worker's chip group.

    chip_indices are host-local chip indices (0..chips_per_host-1). For a
    GPU ``model`` they are GPU ordinals, named ``/dev/nvidia<ordinal>``
    for the node agent to rebase onto minors, and slice-local indices (as
    ``SliceShape.worker_chip_indices`` gives them) are taken modulo the
    host's GPU count; otherwise they are TPU accel indices, exposed through
    vfio device nodes with ``use_vfio`` (IOMMU passthrough hosts).
    """
    name = f"{slice_name}-worker{worker_id}" if slice_name else f"chips-{'-'.join(map(str, chip_indices))}"
    if is_gpu_model(model):
        if use_vfio:
            raise ValueError("vfio passthrough applies to TPU chips only")
        per_host = GPU_MODELS[model].chips_per_host
        # Ordinals, not minors: the publishing agent rebases them.
        nodes = [f"/dev/nvidia{i % per_host}" for i in chip_indices]
        nodes += list(NVIDIA_CONTROL_NODES)
        return CdiSpec(name=name, device_nodes=nodes, env=dict(env or {}),
                       cdi_class=CDI_CLASS_GPU,
                       mounts=[(p, p) for p in NVIDIA_DRIVER_LIBS])
    if use_vfio:
        nodes = ["/dev/vfio/vfio"] + [f"/dev/vfio/{i}" for i in chip_indices]
    else:
        nodes = [f"/dev/accel{i}" for i in chip_indices]
    return CdiSpec(name=name, device_nodes=nodes, env=dict(env or {}))


def _path(cdi_dir: str, cdi_class: str, name: str) -> str:
    return os.path.join(cdi_dir, f"{CDI_VENDOR}-{cdi_class}-{name}.json")


def spec_path(cdi_dir: str, spec: CdiSpec) -> str:
    return _path(cdi_dir, spec.cdi_class, spec.name)


def write_cdi_spec(cdi_dir: str, spec: CdiSpec) -> str:
    """Atomically write the spec document; returns its path."""
    os.makedirs(cdi_dir, exist_ok=True)
    path = spec_path(cdi_dir, spec)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(spec.to_dict(), f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def remove_cdi_spec(cdi_dir: str, name: str, cdi_class: str = CDI_CLASS
                    ) -> bool:
    try:
        os.remove(_path(cdi_dir, cdi_class, name))
        return True
    except FileNotFoundError:
        return False


def list_cdi_specs(cdi_dir: str, cdi_class: str = CDI_CLASS) -> List[str]:
    if not os.path.isdir(cdi_dir):
        return []
    prefix = f"{CDI_VENDOR}-{cdi_class}-"
    return sorted(
        fn[len(prefix):-len(".json")]
        for fn in os.listdir(cdi_dir)
        if fn.startswith(prefix) and fn.endswith(".json")
    )
