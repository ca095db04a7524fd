"""Seeded weights of the latent-attention MoE family (Moonlight-16B-A3B),
made on the device.

The tree is the one the program's MLA layers take (``models/mla.py``):
``{"embed": (V, D), "layers": [layer], "ln_f": (D,)}``, each layer
``{ln1, wq (D, H, nope + rope), wkva (D, rank + rope), kv_norm (rank,),
wkvb (rank, H, nope + v), wo (H, v, D), ln2}`` and its FFN: the leading
dense layers ``{w_gate (D, F), w_up (D, F), w_down (F, D)}``, the MoE
layers ``{w_gate (E, D, Fe), w_up (E, D, Fe), w_down (E, Fe, D),
shared_w_gate (D, S·Fe), shared_w_up, shared_w_down (S·Fe, D), w_router
(D, E) float32, e_score_correction_bias (E,) float32}``. Matrices are
N(0, ``initializer_range``): one ``torch.randn`` call on the device per
layer in the configuration's dtype for its matrices, then, in an MoE
layer, one in float32 for its router and one for its selection bias,
N(0, ``BIAS_STD``), from a generator seeded by (seed, layer); the
embedding is ``weights.make_embed``'s. Norms are ones in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from h100bench.mla_counts import MLADims
from h100bench.traffic import torch_seed
from h100bench.weights import _normal, dtype_of, make_embed

#: The selection bias's spread: large enough to move some of the router's
#: choices (its scores spread by about 0.2 at the published widths).
BIAS_STD = 0.05


def layer_shapes(cfg: Dict, i: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of layer ``i``'s matrices, in the order they are
    drawn."""
    d = MLADims(cfg)
    out = [("wq", (d.d, d.h, d.qk)), ("wkva", (d.d, d.latent)),
           ("wkvb", (d.rank, d.h, d.nope + d.v)), ("wo", (d.h, d.v, d.d))]
    if i < d.dense_layers:
        return out + [("w_gate", (d.d, d.f_dense)), ("w_up", (d.d, d.f_dense)),
                      ("w_down", (d.f_dense, d.d))]
    fs = d.shared * d.f
    return out + [("w_gate", (d.experts, d.d, d.f)),
                  ("w_up", (d.experts, d.d, d.f)),
                  ("w_down", (d.experts, d.f, d.d)),
                  ("shared_w_gate", (d.d, fs)), ("shared_w_up", (d.d, fs)),
                  ("shared_w_down", (fs, d.d))]


def make_layer(cfg: Dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the run's weights."""
    d = MLADims(cfg)
    std = float(cfg.get("initializer_range", 0.02))
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, "layer", str(i)))
    shapes = layer_shapes(cfg, i)
    flat = _normal(sum(math.prod(s) for _, s in shapes), gen, device,
                   dtype_of(cfg), std)
    layer: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in shapes:
        n = math.prod(shape)
        layer[key] = flat[at:at + n].view(shape)
        at += n
    if i >= d.dense_layers:
        layer["w_router"] = _normal(d.d * d.experts, gen, device,
                                    torch.float32, std).view(d.d, d.experts)
        layer["e_score_correction_bias"] = _normal(
            d.experts, gen, device, torch.float32, BIAS_STD)
    ones = dict(dtype=torch.float32, device=device)
    layer["ln1"] = torch.ones(d.d, **ones)
    layer["kv_norm"] = torch.ones(d.rank, **ones)
    layer["ln2"] = torch.ones(d.d, **ones)
    return layer


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The whole tree."""
    d = MLADims(cfg)
    return {"embed": make_embed(cfg, seed, device),
            "layers": [make_layer(cfg, seed, i, device)
                       for i in range(d.layers)],
            "ln_f": torch.ones(d.d, dtype=torch.float32, device=device)}
