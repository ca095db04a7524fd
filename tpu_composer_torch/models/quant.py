"""Weight-only int8 quantization for serving (port of
``tpu_composer/models/quant.py``).

Symmetric per-OUTPUT-channel: the scale covers every axis that survives
the weight's contraction, so ``einsum(x, q) * scale`` is exactly
``einsum(x, w_dequant)``. Quantized leaves are :class:`QTensor` pairs;
every weight-use site goes through :func:`resolve`, the identity for
plain tensors.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch


class QTensor(NamedTuple):
    """int8 values + fp32 scale broadcastable over the original shape."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


def quantize_weight(w: torch.Tensor, contract_axes: Tuple[int, ...]) -> QTensor:
    """Symmetric int8 over the contracted axes: scale has the weight's
    shape with contracted axes reduced to 1 (kept for broadcast)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=contract_axes, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def resolve(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Materialize a weight for compute: dequantize QTensors, pass
    tensors through."""
    if isinstance(w, QTensor):
        return (w.q.to(dtype) * w.scale.to(dtype)).to(dtype)
    return w


# Which axes each known weight contracts in its einsum (everything else is
# an output channel and keeps its own scale). Norms stay unquantized.
_CONTRACT_AXES = {
    "wqkv": (0,),      # bsd,dthk->tbshk
    "wq": (0,),        # bsd,dhk->bshk
    "wkv": (0,),       # bsd,dthk->tbshk
    "wo": (0, 1),      # bshk,hkd->bsd
    "embed": (1,),     # bsd,vd->bsv (and row-lookup, same per-row scale)
}
_DENSE_FFN = {"w_gate": (0,), "w_up": (0,), "w_down": (0,)}
_MOE_FFN = {"w_gate": (1,), "w_up": (1,), "w_down": (1,)}  # ebcd,edf->ebcf


def quantize_decode_params(params: Dict) -> Dict:
    """Quantize a model tree's matmul weights for decode, dense or MoE:
    expert stacks (E, ·, ·) get per-(expert, channel) scales; layer norms
    and MoE routers stay fp."""

    def q_layer(layer: Dict) -> Dict:
        out = {}
        for name, w in layer.items():
            if name in _CONTRACT_AXES:
                out[name] = quantize_weight(w, _CONTRACT_AXES[name])
            elif name in _DENSE_FFN:
                axes = _MOE_FFN[name] if w.dim() == 3 else _DENSE_FFN[name]
                out[name] = quantize_weight(w, axes)
            else:
                out[name] = w
        return out

    return {
        "embed": quantize_weight(params["embed"], _CONTRACT_AXES["embed"]),
        "layers": [q_layer(layer) for layer in params["layers"]],
        "ln_f": params["ln_f"],
    }


def embedding_lookup(embed: Any, tokens: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Row lookup that keeps a quantized embedding quantized: take the
    int8 rows and their per-row scales, multiply after the gather."""
    idx = tokens.long()
    if isinstance(embed, QTensor):
        rows = embed.q[idx].to(dtype)
        scales = embed.scale[:, 0][idx].to(dtype)
        return rows * scales[..., None]
    return embed[idx]
