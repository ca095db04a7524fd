"""Flagship model: a decoder-only transformer LM on plain tensor trees
(port of ``tpu_composer/models/transformer.py``).

Params are a dict/list tree with the JAX package's keys and layouts:
``{embed (V, D), layers: [{ln1, wo (H, hd, D), ln2, w_gate, w_up, w_down,
wqkv (D, 3, H, hd) | wq (D, H, hd) + wkv (D, 2, KV, hd)}], ln_f}``.
RMSNorm and RoPE run in fp32; the tied output head keeps fp32
accumulation as its output dtype. ``attn_impl="flash"`` routes attention
through the flash kernels (``ops/attention.py``), forward and backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.ops.attention import flash_attention, mha_reference
from tpu_composer_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    enter_parallel,
    shard,
)


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


def param_specs(config: ModelConfig) -> Dict:
    """The JAX package's sharding layout as plain data: per leaf a tuple
    of mesh-axis names or ``None`` per array dim (``()`` = replicated).
    'tp' shards heads, the ffn width and the vocab rows of the
    embedding; the train step legalizes it (``parallel/train.py``)."""
    layer = {
        "ln1": (),
        "wo": ("tp", None, None),
        "ln2": (),
        "w_gate": (None, "tp"),
        "w_up": (None, "tp"),
        "w_down": ("tp", None),
    }
    if config.kv_heads == config.n_heads:
        layer["wqkv"] = (None, None, "tp", None)
    else:
        layer["wq"] = (None, "tp", None)
        layer["wkv"] = (None, None, "tp", None)
    return {
        "embed": ("tp", None),
        "layers": [dict(layer) for _ in range(config.n_layers)],
        "ln_f": (),
    }


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


class _TiedHead(torch.autograd.Function):
    """x (N, D) times embedᵀ (D, V) from the operands' own dtype into an
    fp32 output (``aten::mm.dtype``, the JAX package's
    ``preferred_element_type=float32``). The backward is JAX's
    transpose, which runs in fp32 (the fp32 cotangent times the upcast
    operand), each gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (g.mm(w.float()).to(x.dtype),
                g.t().mm(x.float()).to(w.dtype))


def _tied_logits(x, embed, dtype):
    """Tied output head (embed^T) with fp32 accumulation as the OUTPUT
    dtype, so a bf16 model's logits are never rounded to bf16. On the
    card the bf16 operands are multiplied as they are into an fp32
    output (:class:`_TiedHead`); the CPU has no kernel for that op, so
    there the operands are upcast (the same products, exact in fp32)."""
    w = resolve(embed, dtype)
    if x.is_cuda and x.dtype != torch.float32:
        out = _TiedHead.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return torch.einsum("...d,vd->...v", x.float(), w.float())


AttnFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out


def _select_attn(config: ModelConfig, attn_fn: Optional[AttnFn]) -> AttnFn:
    if attn_fn is not None:
        return attn_fn
    if config.attn_impl == "flash":
        return flash_attention
    return mha_reference


def attention_block(layer: Dict, x: torch.Tensor, positions: torch.Tensor,
                    config: ModelConfig, attn: AttnFn,
                    mesh=None) -> torch.Tensor:
    """Pre-RMSNorm causal attention with residual.

    With ``mesh`` and the heads of ``wo`` sharded over its 'tp' dim the
    block runs on this rank's heads: the normed activations enter the tp
    region (their cotangent is summed over tp), q (and k, v when ``wkv``
    is sharded with them) come from the local head columns, and the
    partial outputs of the local ``wo`` rows are summed over tp. Where tp
    does not divide the KV heads, ``wkv`` is replicated: k and v are then
    computed from the activations outside the region, and q is gathered
    to every head around the attention (its output sliced back), so each
    rank attends with the kv heads its queries use."""
    c = config
    h = _rmsnorm(x, layer["ln1"])
    if mesh is not None and layer["wo"].shape[0] == c.n_heads:
        mesh = None  # heads replicated: no tp region
    gather_q = False
    if mesh is None:
        q, k, v = project_qkv(layer, h)
    else:
        hp = enter_parallel(h, mesh, "tp")
        if "wqkv" in layer:
            q, k, v = project_qkv(layer, hp)
        else:
            gather_q = layer["wkv"].shape[2] == c.kv_heads
            q = torch.einsum("bsd,dhk->bshk", hp,
                             resolve(layer["wq"], hp.dtype))
            kv = torch.einsum("bsd,dthk->tbshk", h if gather_q else hp,
                              resolve(layer["wkv"], h.dtype))
            k, v = kv[0], kv[1]
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    if gather_q:
        q = all_gather(q, mesh, "tp", axis=2)
    o = attn(q, k, v, causal=True)
    if gather_q:
        o = shard(o, mesh, "tp", axis=2)
    out = torch.einsum("bshk,hkd->bsd", o.to(c.dtype),
                       resolve(layer["wo"], c.dtype))
    return x + all_reduce(out, mesh, "tp")


def swiglu_ffn(h: torch.Tensor, layer: Dict, dtype,
               mesh=None) -> torch.Tensor:
    """Dense SwiGLU MLP (no residual): silu(h@w_gate) * (h@w_up) @ w_down.
    With ``mesh`` the ffn width is sharded over its 'tp' dim: ``h``
    enters the tp region and the partial ``w_down`` products are summed
    over tp."""
    h = enter_parallel(h, mesh, "tp")
    gate = F.silu(torch.einsum(
        "bsd,df->bsf", h, resolve(layer["w_gate"], dtype)).float())
    up = torch.einsum("bsd,df->bsf", h,
                      resolve(layer["w_up"], dtype)).float()
    out = torch.einsum("bsf,fd->bsd", (gate * up).to(dtype),
                       resolve(layer["w_down"], dtype))
    return all_reduce(out, mesh, "tp")


def ffn_mesh(layer: Dict, config, mesh):
    """``mesh`` when this layer's ffn width is sharded (``w_down`` holds
    fewer rows than ``d_ff``), else None."""
    return mesh if layer["w_down"].shape[-2] < config.d_ff else None


def block_forward(layer: Dict, x: torch.Tensor, positions: torch.Tensor,
                  config: ModelConfig, attn: AttnFn,
                  mesh=None) -> torch.Tensor:
    """One transformer block (attention + SwiGLU MLP, pre-RMSNorm)."""
    x = attention_block(layer, x, positions, config, attn, mesh)
    h = _rmsnorm(x, layer["ln2"])
    return x + swiglu_ffn(h, layer, config.dtype,
                          ffn_mesh(layer, config, mesh))


def full_embedding(embed, config, mesh):
    """The whole embedding table. Its vocab rows may be sharded over
    'tp' (``param_specs``); the lookup and the tied head then read the
    table gathered over tp, once per step: the simplest exact route
    (the flagship's table is 8 MB in bf16). Both consumers run
    replicated, so every tp rank holds the same full cotangent, and the
    gather's backward keeps this rank's rows of it."""
    if embed.shape[0] < config.vocab_size:
        return all_gather(embed, mesh, "tp", axis=0)
    return embed


def forward(params: Dict, tokens: torch.Tensor, config: ModelConfig,
            attn_fn: Optional[AttnFn] = None, mesh=None) -> torch.Tensor:
    """Logits (B, S, vocab) in fp32 for tokens (B, S). ``mesh`` (a
    ``DeviceMesh``) is given when the params are this rank's shards
    (``parallel/train.py``): their local shapes say which are sharded
    over 'tp', and the blocks run the tp regions for those. Without it
    the forward is the single-device one."""
    c = config
    attn = _select_attn(c, attn_fn)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    embed = full_embedding(params["embed"], c, mesh)
    x = embedding_lookup(embed, tokens, c.dtype)
    for layer in params["layers"]:
        x = block_forward(layer, x, positions, c, attn, mesh)
    x = _rmsnorm(x, params["ln_f"])
    return _tied_logits(x, embed, c.dtype)


def loss_fn(params: Dict, tokens: torch.Tensor, config: ModelConfig,
            attn_fn: Optional[AttnFn] = None, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy on fp32 logits, the mean over B·(S−1)
    positions."""
    logits = forward(params, tokens, config, attn_fn, mesh)[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()
