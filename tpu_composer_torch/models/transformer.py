"""Flagship model: a decoder-only transformer LM on plain tensor trees
(port of ``tpu_composer/models/transformer.py``, forward half).

Params are a dict/list tree with the JAX package's keys and layouts:
``{embed (V, D), layers: [{ln1, wo (H, hd, D), ln2, w_gate, w_up, w_down,
wqkv (D, 3, H, hd) | wq (D, H, hd) + wkv (D, 2, KV, hd)}], ln_f}``.
RMSNorm and RoPE run in fp32; the tied output head keeps fp32
accumulation as its output dtype. ``attn_impl="flash"`` routes attention
through the flash kernel (``ops/attention.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.ops.attention import flash_attention, mha_reference


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    # Grouped-query attention: KV heads < query heads. None = MHA.
    n_kv_heads: Optional[int] = None
    d_ff: int = 1408
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "reference"  # reference | flash
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads {kv} must divide n_heads {self.n_heads}"
            )
        return kv


def init_params(config: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Dict:
    """Random params, N(0, 0.02) in fp32 cast to ``config.dtype``, drawn
    from a CPU ``torch.Generator`` seeded with ``seed`` (so the same seed
    gives the same weights on every device); norms are ones in fp32. MHA
    layers carry one fused ``wqkv``; GQA layers a split ``wq`` + ``wkv``."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02
        return w.to(c.dtype).to(dev)

    def ones():
        return torch.ones(c.d_model, dtype=torch.float32, device=dev)

    embed = dense(c.vocab_size, c.d_model)
    layers = []
    for _ in range(c.n_layers):
        layer = {
            "ln1": ones(),
            "wo": dense(c.n_heads, c.head_dim, c.d_model),
            "ln2": ones(),
            "w_gate": dense(c.d_model, c.d_ff),
            "w_up": dense(c.d_model, c.d_ff),
            "w_down": dense(c.d_ff, c.d_model),
        }
        if c.kv_heads == c.n_heads:
            layer["wqkv"] = dense(c.d_model, 3, c.n_heads, c.head_dim)
        else:
            layer["wq"] = dense(c.d_model, c.n_heads, c.head_dim)
            layer["wkv"] = dense(c.d_model, 2, c.kv_heads, c.head_dim)
        layers.append(layer)
    return {"embed": embed, "layers": layers, "ln_f": ones()}


def project_qkv(layer: Dict, h: torch.Tensor):
    """(B, S, D) normed activations -> q (B, S, H, hd), k/v (B, S, KV, hd)
    for both the fused-MHA and split-GQA layouts (weights may be int8
    QTensors, resolved at use)."""
    if "wqkv" in layer:
        qkv = torch.einsum("bsd,dthk->tbshk", h,
                           resolve(layer["wqkv"], h.dtype))
        return qkv[0], qkv[1], qkv[2]
    q = torch.einsum("bsd,dhk->bshk", h, resolve(layer["wq"], h.dtype))
    kv = torch.einsum("bsd,dthk->tbshk", h, resolve(layer["wkv"], h.dtype))
    return q, kv[0], kv[1]


def _rmsnorm(x, gamma, eps=1e-6):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * gamma).to(x.dtype)


def _rope(x, positions, theta: float):
    """Rotary embedding in fp32. x: (B, S, H, D), positions: (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _tied_logits(x, embed, dtype):
    """Tied output head (embed^T) with fp32 accumulation as the OUTPUT
    dtype: the operands are upcast, so a bf16 model's logits are never
    rounded to bf16 (the JAX package's preferred_element_type=float32)."""
    return torch.einsum("...d,vd->...v", x.float(),
                        resolve(embed, dtype).float())


AttnFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out


def _select_attn(config: ModelConfig, attn_fn: Optional[AttnFn]) -> AttnFn:
    if attn_fn is not None:
        return attn_fn
    if config.attn_impl == "flash":
        return flash_attention
    return mha_reference


def attention_block(layer: Dict, x: torch.Tensor, positions: torch.Tensor,
                    config: ModelConfig, attn: AttnFn) -> torch.Tensor:
    """Pre-RMSNorm causal attention with residual."""
    c = config
    h = _rmsnorm(x, layer["ln1"])
    q, k, v = project_qkv(layer, h)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    o = attn(q, k, v, causal=True)
    return x + torch.einsum("bshk,hkd->bsd", o.to(c.dtype),
                            resolve(layer["wo"], c.dtype))


def swiglu_ffn(h: torch.Tensor, layer: Dict, dtype) -> torch.Tensor:
    """Dense SwiGLU MLP (no residual): silu(h@w_gate) * (h@w_up) @ w_down."""
    gate = F.silu(torch.einsum(
        "bsd,df->bsf", h, resolve(layer["w_gate"], dtype)).float())
    up = torch.einsum("bsd,df->bsf", h,
                      resolve(layer["w_up"], dtype)).float()
    return torch.einsum("bsf,fd->bsd", (gate * up).to(dtype),
                        resolve(layer["w_down"], dtype))


def block_forward(layer: Dict, x: torch.Tensor, positions: torch.Tensor,
                  config: ModelConfig, attn: AttnFn) -> torch.Tensor:
    """One transformer block (attention + SwiGLU MLP, pre-RMSNorm)."""
    x = attention_block(layer, x, positions, config, attn)
    h = _rmsnorm(x, layer["ln2"])
    return x + swiglu_ffn(h, layer, config.dtype)


def forward(params: Dict, tokens: torch.Tensor, config: ModelConfig,
            attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Logits (B, S, vocab) in fp32 for tokens (B, S)."""
    c = config
    attn = _select_attn(c, attn_fn)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    for layer in params["layers"]:
        x = block_forward(layer, x, positions, c, attn)
    x = _rmsnorm(x, params["ln_f"])
    return _tied_logits(x, params["embed"], c.dtype)
