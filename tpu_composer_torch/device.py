"""Device resolution for the port's entry points.

Every function that creates tensors takes a ``device`` and routes it
through :func:`resolve_device`: the default is the card, and a missing
card is an error, never a silent move to the CPU. Everything else
follows the device of its inputs.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (pass ``"cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present;"
            " pass device='cpu' to run on the CPU"
        )
    return dev
