"""JAX params and train states (as numpy) -> the port's trees.

``params_from_jax`` takes the JAX package's param pytree with every leaf
already a numpy array (dicts, lists, and ``(q, scale)`` pairs for int8
``QTensor`` leaves) and returns the same tree as torch tensors on
``device``: a layer list, or the stacked layers ``{w: (L, ...)}`` of a
state built on a pipelined mesh. Each leaf keeps the dtype the JAX tree
holds it in: bf16 leaves stay bf16, and the leaves the JAX package keeps
in fp32 (the norms, the MoE router, quantization scales) stay fp32. The
rule is read from each leaf, never from its name.

numpy has no bfloat16 of its own: a JAX bf16 array arrives as an
``ml_dtypes`` bfloat16 array (``np.asarray`` of it), which is recognised
here by its dtype's name and crosses through float32 (exact for bf16).
A tree upcast to float32 beforehand has lost its dtypes: its embedding
then disagrees with ``config.dtype`` and the conversion refuses it.

``train_state_from_jax`` carries a whole JAX train state across: its
params, and its optax AdamW state ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())`` as the port's ``{"count", "mu", "nu"}``,
so k JAX steps can be continued by the port's step k+1.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.quant import QTensor


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor in the leaf's own dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot read
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_jax(params_np: Any, config, device: DeviceLike = "cuda"):
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, tuple):  # a QTensor (q, scale) pair
            q, scale = a
            return QTensor(q=_tensor(q, dev), scale=_tensor(scale, dev))
        return _tensor(a, dev)

    layers = params_np["layers"]
    out = {
        "embed": leaf(params_np["embed"]),
        # A pipelined JAX state stacks the layers: {w: (L, ...)}.
        "layers": ({name: leaf(w) for name, w in layers.items()}
                   if isinstance(layers, dict) else
                   [{name: leaf(w) for name, w in layer.items()}
                    for layer in layers]),
        "ln_f": leaf(params_np["ln_f"]),
    }
    embed = out["embed"]
    if not isinstance(embed, QTensor) and embed.dtype != config.dtype:
        raise ValueError(
            f"the embedding arrives as {embed.dtype} but the config says "
            f"{config.dtype}: pass the JAX tree's leaves in their own dtypes"
            " (np.asarray of a bf16 array, not an upcast copy)")
    return out


def train_state_from_jax(state_np: Any, tc, device: DeviceLike = "cuda"):
    """``{"params", "opt"}`` of the JAX package's train step (leaves as
    numpy) -> the port's train state for ``tc`` (a ``TrainConfig``) on
    ``device``. ``mu`` and ``nu`` keep their leaves' dtypes, which optax
    gives them from their params (fp32 for the norms and the router)."""
    dev = resolve_device(device)
    count, mu, nu = state_np["opt"][0]  # ScaleByAdamState
    return {
        "params": params_from_jax(state_np["params"], tc.model, dev),
        "opt": {"count": torch.tensor(int(np.asarray(count)),
                                      dtype=torch.int32, device=dev),
                "mu": params_from_jax(mu, tc.model, dev),
                "nu": params_from_jax(nu, tc.model, dev)},
    }
