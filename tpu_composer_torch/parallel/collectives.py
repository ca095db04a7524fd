"""The allreduce bandwidth probe (port of
``tpu_composer/parallel/collectives.py``, the one-card subset).

``qualify_slice`` reads it. On one device there is no link to exercise
and the probe reports 0.0, as the JAX package does. NCCL bus bandwidth
over several cards comes with the multi-device slice; until then more
than one device raises rather than report a number that was not
measured.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_composer_torch.device import DeviceLike


def allreduce_bandwidth_gbps(devices: Optional[Sequence[DeviceLike]] = None,
                             size_mb: float = 64.0, iters: int = 10) -> float:
    """Allreduce bus bandwidth (GB/s, NCCL's busbw convention) over
    ``devices`` (default: every visible card, or the CPU when there is
    none). One device: 0.0."""
    if devices is None:
        n = max(torch.cuda.device_count(), 1)
    else:
        n = len(devices)
    if n < 2:
        return 0.0
    raise NotImplementedError(
        f"allreduce over {n} devices (NCCL busbw) comes with port slice 4")
