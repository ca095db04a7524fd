"""Plain PyTorch reference of the dense decoder LM family: Mistral-7B as
its model card describes it.

Written from the published architecture, in float32 with TF32 off, with
no kernel, no cache and no batching: pre-RMSNorm blocks, rotary position
embedding in the rotate-half form with base ``rope_theta``, grouped-query
causal attention scaled by 1/sqrt(head_dim), a SwiGLU FFN
(silu(h·W_gate) * (h·W_up))·W_down. The output head is the embedding's transpose
(the configuration ties them). It reads the weights in the tree layout of
``h100bench/weights.py`` and imports nothing of the program.

:class:`Precision` rounds the operands of every weight matmul; the
reference itself runs ``"fp32"``. The control runs ``"fp8"``: both
operands rounded to float8 e4m3 (a per-row scale for activations, a
per-output-column scale for weights), the product accumulated in
float32, the next precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    @staticmethod
    def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (N, K) times w (K, M), both float32."""
        if self.kind == "fp8":
            return self._fp8(a, -1) @ self._fp8(w, 0)
        return a @ w


class Arch:
    """The widths the reference needs, from the configuration file."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg.get("num_key_value_heads") or self.h
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.layers = cfg["num_hidden_layers"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gamma


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q, k, v, a: Arch) -> torch.Tensor:
    """Causal grouped-query attention: q (S, H, hd), k/v (S, KV, hd)."""
    s = q.shape[0]
    g = a.h // a.kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(a.hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def swiglu(h, w_gate, w_up, w_down, prec: Precision):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up), w_down)


def block(x: torch.Tensor, layer: Dict, a: Arch, prec: Precision):
    """One decoder layer over one sequence x (S, D), float32."""
    s = x.shape[0]
    h = rms_norm(x, layer["ln1"], a.eps)
    q = prec.mm(h, layer["wq"].reshape(a.d, -1)).view(s, a.h, a.hd)
    kv = prec.mm(h, layer["wkv"].reshape(a.d, -1)).view(s, 2, a.kv, a.hd)
    k, v = kv[:, 0], kv[:, 1]
    o = attention(rope(q, a.theta), rope(k, a.theta), v, a)
    x = x + prec.mm(o.reshape(s, -1), layer["wo"].reshape(-1, a.d))
    h = rms_norm(x, layer["ln2"], a.eps)
    return x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"], prec)


def _f32(layer: Dict) -> Dict:
    return {k: v.float() for k, v in layer.items()}


def logits(cfg: Dict, weights: Dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], prec: Precision = Precision()
           ) -> List[torch.Tensor]:
    """For each token sequence (1-D, on the weights' device) the float32
    logits (len − start, V) of the positions from ``start`` on, each
    predicting the token after it. Layer by layer over all sequences, one
    layer's weights upcast at a time."""
    a = Arch(cfg)
    embed = weights["embed"].float()
    xs = [embed[t.long()] for t in seqs]
    with torch.no_grad():
        for layer in weights["layers"]:
            lw = _f32(layer)
            xs = [block(x, lw, a, prec) for x in xs]
            del lw
        return [prec.mm(rms_norm(x[s:], weights["ln_f"].float(), a.eps),
                        embed.t()) for x, s in zip(xs, starts)]
