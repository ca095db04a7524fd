"""Coordinate injection, the mutating-admission side (port of
``tpu_composer/admission/coordinates.py``).

``slice_env`` derives a worker's coordinate env from
``ComposabilityRequest.status.slice``, the allocator's authoritative
record, so that injected coordinates never drift from the real
allocation; ``inject_pod_env`` applies them to a Pod manifest dict.

TPU models get exactly the JAX package's env, what ``jax.distributed``
and libtpu read on a multi-host slice:

  TPU_WORKER_ID             this host's index in the slice (worker order)
  TPU_WORKER_HOSTNAMES      comma-separated host list in worker order
  TPU_CHIPS_PER_HOST_BOUNDS per-dimension chip grid on one host, "x,y,z"
  TPU_HOST_BOUNDS           per-dimension host grid of the slice, "x,y,z"
  TPU_TOPOLOGY              slice shape, e.g. "2x2x4"
  TPU_SLICE_NAME            stable slice identity
  TPU_ACCELERATOR_MODEL     generation (tpu-v4, ...)

GPU models (``nvidia-h100-sxm``) get what a PyTorch job on a composed
host needs, under the names torch's launcher reads. ``torchrun`` takes
its defaults from ``PET_<OPTION>`` variables, so ``torchrun script.py``
with no arguments starts the host's share of the world; the worker
variables are those ``torchrun`` gives its workers and
``init_process_group``'s ``env://`` reads:

  MASTER_ADDR, PET_MASTER_ADDR  the rendezvous host: worker 0's
  MASTER_PORT, PET_MASTER_PORT  the rendezvous port
  WORLD_SIZE                    every GPU of the slice
  GROUP_RANK, PET_NODE_RANK     this host's index (worker order)
  PET_NNODES                    hosts in the slice
  LOCAL_WORLD_SIZE,             GPUs on each host (one process each)
  PET_NPROC_PER_NODE
  COMPOSER_SLICE_NAME, COMPOSER_TOPOLOGY, COMPOSER_ACCELERATOR_MODEL,
  COMPOSER_WORKER_HOSTNAMES     the slice's identity

``RANK`` and ``LOCAL_RANK`` differ between the processes of one host, so
one pod's env cannot hold them: each process derives them from its
local rank (``workload/coords.bootstrap_distributed``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from tpu_composer_torch.api.types import SliceStatus
from tpu_composer_torch.topology.slices import (
    TPU_MODELS,
    TopologyError,
    _parse_dims,
    is_gpu_model,
)

#: Pods opt in by carrying this label with the request name as value.
LABEL_INJECT = "tpu.composer.dev/composability-request"
#: Pod label naming which worker of the slice this pod is.
LABEL_WORKER_ID = "tpu.composer.dev/worker-id"
#: The rendezvous port, torchrun's own default.
DEFAULT_MASTER_PORT = 29500


def _bounds(slice_status: SliceStatus, model: str):
    """(chip-grid-per-host, host-grid) as 'x,y,z' strings.

    host bounds = slice dims / host tray dims, elementwise; when the model is
    unknown or the slice is sub-host, fall back to a linear layout.
    """
    try:
        dims = list(_parse_dims(slice_status.topology))
    except TopologyError:
        dims = []
    m = TPU_MODELS.get(model)

    def linear():
        chip = [max(1, slice_status.chips_per_host), 1, 1]
        host = [max(1, slice_status.num_hosts), 1, 1]
        return ",".join(map(str, chip)), ",".join(map(str, host))

    if (
        m is None
        or not dims
        or len(dims) != len(m.host_dims)
        or slice_status.chips_per_host < m.chips_per_host
    ):
        return linear()
    # Orient the host tray onto the slice dims: pair sorted tray factors with
    # sorted dims (solver dims are canonicalized ascending; a user-pinned
    # permutation still divides or we fall back to linear bounds).
    order = sorted(range(len(dims)), key=lambda i: dims[i])
    tray_sorted = sorted(m.host_dims)
    chip = [1] * len(dims)
    host = [1] * len(dims)
    for idx, t in zip(order, tray_sorted):
        d = dims[idx]
        if d % t != 0:
            return linear()
        chip[idx] = t
        host[idx] = d // t
    return ",".join(map(str, chip)), ",".join(map(str, host))


def _gpu_bounds(slice_status: SliceStatus) -> Tuple[int, int]:
    """(GPUs per node, nodes): the topology "<gpus per host>x<hosts>",
    or the status's own counts when the topology is not of that form."""
    try:
        dims = _parse_dims(slice_status.topology)
    except TopologyError:
        dims = ()
    if len(dims) == 2:
        return dims[0], dims[1]
    return max(1, slice_status.chips_per_host), max(1, slice_status.num_hosts)


def _gpu_env(slice_status: SliceStatus, worker_id: int, model: str,
             master_port: int) -> Dict[str, str]:
    per_node, nodes = _gpu_bounds(slice_status)
    hosts = slice_status.worker_hostnames
    master = hosts[0] if hosts else "localhost"
    return {
        "MASTER_ADDR": master,
        "MASTER_PORT": str(master_port),
        "WORLD_SIZE": str(per_node * nodes),
        "GROUP_RANK": str(worker_id),
        "LOCAL_WORLD_SIZE": str(per_node),
        "PET_MASTER_ADDR": master,
        "PET_MASTER_PORT": str(master_port),
        "PET_NNODES": str(nodes),
        "PET_NODE_RANK": str(worker_id),
        "PET_NPROC_PER_NODE": str(per_node),
        "COMPOSER_SLICE_NAME": slice_status.name,
        "COMPOSER_TOPOLOGY": slice_status.topology,
        "COMPOSER_ACCELERATOR_MODEL": model,
        "COMPOSER_WORKER_HOSTNAMES": ",".join(hosts),
    }


def slice_env(slice_status: SliceStatus, worker_id: int, model: str = "",
              master_port: int = DEFAULT_MASTER_PORT) -> Dict[str, str]:
    """The coordinate env of worker ``worker_id``: the GPU env for a GPU
    ``model``, else the TPU env (``master_port`` is then unused)."""
    if is_gpu_model(model):
        return _gpu_env(slice_status, worker_id, model, master_port)
    chip_bounds, host_bounds = _bounds(slice_status, model)
    env = {
        "TPU_WORKER_ID": str(worker_id),
        "TPU_WORKER_HOSTNAMES": ",".join(slice_status.worker_hostnames),
        "TPU_CHIPS_PER_HOST_BOUNDS": chip_bounds,
        "TPU_HOST_BOUNDS": host_bounds,
        "TPU_TOPOLOGY": slice_status.topology,
        "TPU_SLICE_NAME": slice_status.name,
    }
    if model:
        env["TPU_ACCELERATOR_MODEL"] = model
    return env


def inject_pod_env(pod: Dict, slice_status: SliceStatus, worker_id: int,
                   model: str = "",
                   master_port: int = DEFAULT_MASTER_PORT) -> Dict:
    """Mutate a Pod manifest (dict form): append the coordinate env to every
    container and pin the pod to its worker's host via nodeSelector. Returns
    the pod."""
    env = slice_env(slice_status, worker_id, model, master_port)
    spec = pod.setdefault("spec", {})
    for container in spec.setdefault("containers", []):
        existing = {e.get("name") for e in container.setdefault("env", [])}
        for k, v in sorted(env.items()):
            if k not in existing:
                container["env"].append({"name": k, "value": v})
    if 0 <= worker_id < len(slice_status.worker_hostnames):
        spec.setdefault("nodeSelector", {})[
            "kubernetes.io/hostname"
        ] = slice_status.worker_hostnames[worker_id]
    return pod
