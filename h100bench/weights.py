"""Seeded weights of the dense decoder LM family, made on the device.

The benchmark makes the weights and hands the same tensors to the program
and to the reference. The tree is ``{"embed": (V, D), "layers": [layer],
"ln_f": (D,)}``, each layer ``{ln1, wq (D, H, hd), wkv (D, 2, KV, hd),
wo (H, hd, D), ln2, w_gate, w_up, w_down}``: SwiGLU matrices (D, F),
(D, F), (F, D).
Matrices are N(0, ``initializer_range``) in the configuration's dtype,
norms ones in float32.

Each layer is one ``torch.randn`` call on the device from a generator
seeded by (seed, layer), and the embedding its own, so any layer can be made again alone and bit for bit the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.counts import Dims
from h100bench.traffic import torch_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: Dict) -> torch.dtype:
    return DTYPES[cfg.get("torch_dtype", "bfloat16")]


def layer_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of one layer's matrices, in the order they are drawn."""
    d = Dims(cfg)
    return [("wq", (d.d, d.h, d.hd)), ("wkv", (d.d, 2, d.kv, d.hd)),
            ("wo", (d.h, d.hd, d.d)), ("w_gate", (d.d, d.f)),
            ("w_up", (d.d, d.f)), ("w_down", (d.f, d.d))]


def _normal(n: int, gen: torch.Generator, device, dtype, std: float):
    return torch.randn(n, generator=gen, device=device, dtype=dtype).mul_(std)


def make_layer(cfg: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the run's weights."""
    d = Dims(cfg)
    std = float(cfg.get("initializer_range", 0.02))
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, "layer", str(i)))
    shapes = layer_shapes(cfg)
    flat = _normal(sum(math.prod(s) for _, s in shapes), gen, device,
                   dtype_of(cfg), std)
    layer: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in shapes:
        n = math.prod(shape)
        layer[key] = flat[at:at + n].view(shape)
        at += n
    ones = dict(dtype=torch.float32, device=device)
    layer["ln1"] = torch.ones(d.d, **ones)
    layer["ln2"] = torch.ones(d.d, **ones)
    return layer


def make_embed(cfg: Dict, seed: int, device) -> torch.Tensor:
    d = Dims(cfg)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, "embed"))
    return _normal(d.vocab * d.d, gen, device, dtype_of(cfg),
                   float(cfg.get("initializer_range", 0.02))).view(d.vocab, d.d)


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The whole tree."""
    d = Dims(cfg)
    return {"embed": make_embed(cfg, seed, device),
            "layers": [make_layer(cfg, seed, i, device)
                       for i in range(d.layers)],
            "ln_f": torch.ones(d.d, dtype=torch.float32, device=device)}
