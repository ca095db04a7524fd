"""Workload-side integration: coordinate consumption, slice acceptance,
the staged probe, collective accounting and the resumable training loop.

The operator composes a slice and injects its coordinates
(``admission.coordinates``); this package is what a job calls to consume
them: bootstrap ``torch.distributed`` from the injected env, build the
mesh, and qualify the slice (allreduce bandwidth and a real sharded
train step) before the job trusts it.
"""

from tpu_composer_torch.workload.acceptance import qualify_slice
from tpu_composer_torch.workload.coords import SliceCoords, bootstrap_distributed

__all__ = ["SliceCoords", "bootstrap_distributed", "qualify_slice"]
