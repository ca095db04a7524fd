"""Seeded weights of the sparse MoE decoder family (Mixtral), made on the
device.

The tree is the one the program's MoE layers take (and ``weights.py``'s
dense tree with each layer's FFN replaced): ``{"embed": (V, D), "layers":
[layer], "ln_f": (D,)}``, each layer ``{ln1, wq (D, H, hd), wkv (D, 2,
KV, hd), wo (H, hd, D), ln2, w_router (D, E) float32, w_gate (E, D, F),
w_up (E, D, F), w_down (E, F, D)}``. Matrices are N(0,
``initializer_range``): one ``torch.randn`` call on the device per layer
in the configuration's dtype for its matrices, then one in float32 for
its router, from a generator seeded by (seed, layer); the embedding is
``weights.make_embed``'s. Norms are ones in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.moe_counts import MoEDims
from h100bench.traffic import torch_seed
from h100bench.weights import _normal, dtype_of, make_embed


def layer_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of one layer's matrices, in the order they are drawn
    (the router is drawn after them, in float32)."""
    d = MoEDims(cfg)
    return [("wq", (d.d, d.h, d.hd)), ("wkv", (d.d, 2, d.kv, d.hd)),
            ("wo", (d.h, d.hd, d.d)), ("w_gate", (d.experts, d.d, d.f)),
            ("w_up", (d.experts, d.d, d.f)), ("w_down", (d.experts, d.f, d.d))]


def make_layer(cfg: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the run's weights."""
    d = MoEDims(cfg)
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
    layer["w_router"] = _normal(d.d * d.experts, gen, device, torch.float32,
                                std).view(d.d, d.experts)
    ones = dict(dtype=torch.float32, device=device)
    layer["ln1"] = torch.ones(d.d, **ones)
    layer["ln2"] = torch.ones(d.d, **ones)
    return layer


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The whole tree."""
    d = MoEDims(cfg)
    return {"embed": make_embed(cfg, seed, device),
            "layers": [make_layer(cfg, seed, i, device)
                       for i in range(d.layers)],
            "ln_f": torch.ones(d.d, dtype=torch.float32, device=device)}
