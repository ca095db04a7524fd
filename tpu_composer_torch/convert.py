"""JAX params and train states (as numpy) -> the port's trees.

``params_from_jax`` takes the JAX package's param pytree with every leaf
already a numpy array (dicts, lists, and ``(q, scale)`` pairs for int8
``QTensor`` leaves) and returns the same tree as torch tensors on
``device``. Float leaves are cast to ``config.dtype`` except the norms
(``ln*``) and quantization scales, which the JAX package keeps in fp32.

``train_state_from_jax`` carries a whole JAX train state across: its
params, and its optax AdamW state ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())`` as the port's ``{"count", "mu", "nu"}``,
so k JAX steps can be continued by the port's step k+1.

numpy has no bfloat16: a JAX bf16 array arrives as an ``ml_dtypes``
array that ``torch.from_numpy`` rejects, so callers upcast it to float32
first (exact for bf16) and this function casts back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.quant import QTensor


def params_from_jax(params_np: Any, config, device: DeviceLike = "cuda"):
    dev = resolve_device(device)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a)).to(dtype).to(dev)

    def leaf(name: str, a):
        if isinstance(a, tuple):  # a QTensor (q, scale) pair
            q, scale = a
            return QTensor(q=tensor(q, torch.int8),
                           scale=tensor(scale, torch.float32))
        if name.startswith("ln"):
            return tensor(a, torch.float32)
        return tensor(a, config.dtype)

    return {
        "embed": leaf("embed", params_np["embed"]),
        "layers": [{name: leaf(name, w) for name, w in layer.items()}
                   for layer in params_np["layers"]],
        "ln_f": leaf("ln_f", params_np["ln_f"]),
    }


def train_state_from_jax(state_np: Any, tc, device: DeviceLike = "cuda"):
    """``{"params", "opt"}`` of the JAX package's train step (leaves as
    numpy) -> the port's train state for ``tc`` (a ``TrainConfig``) on
    ``device``. ``mu`` and ``nu`` take their params' dtypes, as optax
    keeps them."""
    dev = resolve_device(device)
    count, mu, nu = state_np["opt"][0]  # ScaleByAdamState
    return {
        "params": params_from_jax(state_np["params"], tc.model, dev),
        "opt": {"count": torch.tensor(int(np.asarray(count)),
                                      dtype=torch.int32, device=dev),
                "mu": params_from_jax(mu, tc.model, dev),
                "nu": params_from_jax(nu, tc.model, dev)},
    }
