"""Consume the injected coordinates (port of
``tpu_composer/workload/coords.py``).

The contract is what ``admission.coordinates.slice_env`` writes for a GPU
slice (and the CDI spec carries): a process on a composed host reads its
host's place in the slice from the env, derives its own rank from its
local rank, and joins ``torch.distributed``'s default process group.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from tpu_composer_torch.admission.coordinates import DEFAULT_MASTER_PORT
from tpu_composer_torch.device import DeviceLike, resolve_device

log = logging.getLogger("workload.coords")

#: The coordinator's port when the env names none: the port the slice's
#: env writes by default (torchrun's rendezvous port), where the JAX
#: package's is jax.distributed's coordinator port.
DEFAULT_COORDINATOR_PORT = DEFAULT_MASTER_PORT
#: How long a collective (the rendezvous included) may wait.
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class SliceCoords:
    worker_id: int
    worker_hostnames: List[str]
    chips_per_host: int
    topology: str
    slice_name: str
    model: str = ""
    master_port: int = DEFAULT_COORDINATOR_PORT

    @property
    def num_workers(self) -> int:
        return max(1, len(self.worker_hostnames))

    @property
    def num_chips(self) -> int:
        return self.chips_per_host * self.num_workers

    @property
    def coordinator_address(self) -> str:
        host = self.worker_hostnames[0] if self.worker_hostnames else "localhost"
        return f"{host}:{self.master_port}"

    def rank(self, local_rank: int) -> int:
        """The global rank of this host's process ``local_rank``."""
        if not 0 <= local_rank < max(1, self.chips_per_host):
            raise ValueError(f"local rank {local_rank} outside this host's"
                             f" {self.chips_per_host} GPUs")
        return self.worker_id * self.chips_per_host + local_rank

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "SliceCoords":
        e = os.environ if env is None else env
        hostnames = [h for h in e.get("COMPOSER_WORKER_HOSTNAMES", "").split(",")
                     if h]
        return cls(
            worker_id=int(e.get("GROUP_RANK", "0")),
            worker_hostnames=hostnames,
            chips_per_host=int(e.get("LOCAL_WORLD_SIZE", "0")),
            topology=e.get("COMPOSER_TOPOLOGY", ""),
            slice_name=e.get("COMPOSER_SLICE_NAME", ""),
            model=e.get("COMPOSER_ACCELERATOR_MODEL", ""),
            master_port=int(e.get("MASTER_PORT",
                                  str(DEFAULT_COORDINATOR_PORT))),
        )


def bootstrap_distributed(
    coords: Optional[SliceCoords] = None,
    env: Optional[Dict[str, str]] = None,
    local_rank: int = 0,
    device: DeviceLike = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> SliceCoords:
    """Join this process to the slice's default process group, rank
    ``worker_id * gpus_per_node + local_rank`` of all the slice's GPUs,
    through a TCP rendezvous at worker 0's host. NCCL on the card (after
    ``torch.cuda.set_device(local_rank)``), gloo when ``device`` is
    ``"cpu"``; every collective waits at most ``timeout_s``. Idempotent:
    a process already in a group is left as it is. Returns the coords.

    One difference from the JAX package: JAX does nothing for a
    one-host slice, since one process drives all of a host's chips. A
    torch job runs one process per GPU, so this does nothing only when
    the slice's world is one GPU.
    """
    coords = coords or SliceCoords.from_env(env)
    dev = resolve_device(device)
    if coords.num_chips <= 1 or dist.is_initialized():
        return coords
    rank = coords.rank(local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coords.coordinator_address}",
        world_size=coords.num_chips, rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )
    log.info("torch.distributed up: rank %d/%d (worker %d, local rank %d)"
             " via %s", rank, coords.num_chips, coords.worker_id, local_rank,
             coords.coordinator_address)
    return coords
