"""Plain PyTorch reference of the latent-attention MoE family:
Moonlight-16B-A3B (DeepSeek-V3's block, ``q_lora_rank`` null) as its
``config.json`` and the DeepSeek-V3 report describe it.

Written from the published architecture, in float32 with TF32 off, with
no kernel, no cache and no batching. Each layer, with x normalised by
RMSNorm (``ln1``):

- attention (multi-head latent attention, expanded): q = x·W_q, per
  head ``qk_nope_head_dim`` + ``qk_rope_head_dim`` wide; [c_kv | k_pe] =
  x·W_kva; c_kv ← RMSNorm(c_kv) with its own weight; RoPE with base
  ``rope_theta`` on q's rope part and on the one k_pe all heads share;
  [k_nope_h | v_h] = c_kv·W_kvb_h; scores q_h·[k_nope_h | k_pe] times
  1/sqrt(nope + rope), causal softmax; out = concat_h(p·v_h)·W_o;
- FFN (``ln2``): the first ``first_k_dense_replace`` layers a SwiGLU of
  width ``intermediate_size``; the others route: logits h·W_router,
  scores s = sigmoid(logits), the ``num_experts_per_tok`` experts with the
  largest s + ``e_score_correction_bias`` (the bias moves selection
  only), gates the chosen s over their sum (``norm_topk_prob``) times
  ``routed_scaling_factor``; out = Σ gate·expert(h) + shared(h), every
  expert a SwiGLU of width ``moe_intermediate_size`` and the
  ``n_shared_experts`` shared ones one SwiGLU of their summed width.

It reads the weights in the tree layout of ``h100bench/mla_weights.py``
and imports nothing of the program. Departures from the source, each as
the configuration file states: the output head is the embedding's
transpose (the configuration ties them); RMSNorm adds ``rms_norm_eps``
as the file gives it; RoPE rotates halves (the first half of the rope
dims pairs with the second), where the source's modeling code first
permutes adjacent pairs into that layout: the same function of weights
whose rope columns are permuted alike. On the card the attention runs in
blocks of queries, so that it fits beside the weights.

A routing record (``routes``: per sequence the (layers, positions, k)
expert ids some run used; the dense layers' rows are not read) makes
each MoE layer use the recorded experts at each position, with gates from
the reference's own scores of those experts. Every (MoE layer, position)
then also gives a routing gap on the selection scores s + bias: the
reference's own k-th largest minus the smallest of the used experts',
clamped at 0, so 0 where the used experts are the reference's own
choice. Without a record it routes on its own.

:class:`Precision` (``decoder_lm.py``) rounds the operands of every
weight matmul, the router's included; the control runs ``"fp8"``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from h100bench.references.decoder_lm import (  # noqa: F401 (no_tf32: judge)
    Precision,
    no_tf32,
    rms_norm,
    rope,
    swiglu,
)

#: Queries per block of the attention's scores.
Q_BLOCK = 1024


class MLAArch:
    """The widths the reference needs, from the configuration file."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.layers = cfg["num_hidden_layers"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.rank = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope = cfg["qk_rope_head_dim"]
        self.v = cfg["v_head_dim"]
        self.dense_layers = cfg["first_k_dense_replace"]
        self.experts = cfg["n_routed_experts"]
        self.top_k = cfg["num_experts_per_tok"]
        self.scale = float(cfg["routed_scaling_factor"])


class Routed(NamedTuple):
    """One MoE layer's routing over one sequence of S positions."""

    experts: torch.Tensor  # (S, k) the experts used
    gates: torch.Tensor    # (S, k) float32
    gap: torch.Tensor      # (S,) routing gap (0: the reference's own pick)
    own: torch.Tensor      # (S,) bool: the used set is the reference's own


def route(logits: torch.Tensor, bias: torch.Tensor, a: MLAArch,
          given: Optional[torch.Tensor] = None) -> Routed:
    """Routing from router logits (S, E) float32, by the reference's own
    top-k of the selection scores or by the ``given`` (S, k) expert ids."""
    scores = torch.sigmoid(logits)
    select = scores + bias
    top = select.topk(a.top_k, dim=-1)
    experts = top.indices if given is None else given.long()
    gap = (top.values[:, -1]
           - select.gather(1, experts).min(-1).values).clamp_min(0)
    own = (experts.sort(-1).values == top.indices.sort(-1).values).all(-1)
    chosen = scores.gather(1, experts)
    return Routed(experts, chosen / chosen.sum(-1, keepdim=True) * a.scale,
                  gap, own)


def sparse_ffn(h: torch.Tensor, layer: Dict, a: MLAArch, prec: Precision,
               given: Optional[torch.Tensor] = None):
    """The MoE block over one sequence h (S, D) float32: (output (S, D),
    its :class:`Routed`)."""
    r = route(prec.mm(h, layer["w_router"]), layer["e_score_correction_bias"],
              a, given)
    out = swiglu(h, layer["shared_w_gate"], layer["shared_w_up"],
                 layer["shared_w_down"], prec)
    for e in range(a.experts):
        tok, k = (r.experts == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], layer["w_gate"][e], layer["w_up"][e],
                       layer["w_down"][e], prec)
            out.index_add_(0, tok, r.gates[tok, k, None] * y)
    return out, r


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention q, k (S, H, qk), v (S, H, v), scaled by
    1/sqrt(qk), in blocks of :data:`Q_BLOCK` queries."""
    s = q.shape[0]
    out = []
    for q0 in range(0, s, Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK]
        scores = torch.einsum("qhd,khd->hqk", qb, k) / math.sqrt(q.shape[-1])
        pos = torch.arange(q0, q0 + qb.shape[0], device=q.device)
        mask = pos[:, None] >= torch.arange(s, device=q.device)[None, :]
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v))
    return torch.cat(out)


def mla(x: torch.Tensor, layer: Dict, a: MLAArch, prec: Precision):
    """The attention residual's delta over one sequence x (S, D)."""
    s = x.shape[0]
    h = rms_norm(x, layer["ln1"], a.eps)
    q = prec.mm(h, layer["wq"].reshape(a.d, -1)).view(s, a.h, -1)
    kva = prec.mm(h, layer["wkva"])
    c_kv = rms_norm(kva[:, :a.rank], layer["kv_norm"], a.eps)
    k_pe = rope(kva[:, None, a.rank:], a.theta)
    kvb = prec.mm(c_kv, layer["wkvb"].reshape(a.rank, -1)).view(s, a.h, -1)
    q = torch.cat([q[..., :a.nope], rope(q[..., a.nope:], a.theta)], -1)
    k = torch.cat([kvb[..., :a.nope], k_pe.expand(s, a.h, a.rope)], -1)
    o = attention(q, k, kvb[..., a.nope:])
    return prec.mm(o.reshape(s, -1), layer["wo"].reshape(-1, a.d))


def block(x: torch.Tensor, layer: Dict, li: int, a: MLAArch,
          prec: Precision, given: Optional[torch.Tensor] = None):
    """Layer ``li`` over one sequence x (S, D), float32: (x, routing or
    None in a dense layer)."""
    x = x + mla(x, layer, a, prec)
    h = rms_norm(x, layer["ln2"], a.eps)
    if li < a.dense_layers:
        return x + swiglu(h, layer["w_gate"], layer["w_up"],
                          layer["w_down"], prec), None
    out, r = sparse_ffn(h, layer, a, prec, given)
    return x + out, r


class Read(NamedTuple):
    """What :func:`logits` gives, per sequence."""

    logits: List[torch.Tensor]   # (len − start, V) float32
    experts: List[torch.Tensor]  # (layers, len, k) the experts used (0
                                 # in the dense layers)
    gaps: List[torch.Tensor]     # (MoE layers, len) routing gaps
    own: List[torch.Tensor]      # (MoE layers, len) bool


def logits(cfg: Dict, weights: Dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], prec: Precision = Precision(),
           routes: Optional[Sequence[torch.Tensor]] = None) -> Read:
    """For each token sequence (1-D, on the weights' device) the float32
    logits of the positions from ``start`` on, each predicting the token
    after it, and each MoE layer's routing at every position. ``routes``:
    per sequence the (layers, len, k) experts to use. Layer by layer over
    all sequences, one layer's weights upcast at a time."""
    a = MLAArch(cfg)
    embed = weights["embed"].float()
    xs = [embed[t.long()] for t in seqs]
    used: List[List[Routed]] = [[] for _ in seqs]
    with torch.no_grad():
        for li, layer in enumerate(weights["layers"]):
            lw = {k: v.float() for k, v in layer.items()}
            for i, x in enumerate(xs):
                given = None if routes is None else routes[i][li]
                xs[i], r = block(x, lw, li, a, prec, given)
                if r is not None:
                    used[i].append(r)
            del lw
        out = [prec.mm(rms_norm(x[s:], weights["ln_f"].float(), a.eps),
                       embed.t()) for x, s in zip(xs, starts)]
    dense = [torch.zeros((a.dense_layers, len(t), a.top_k), dtype=torch.long,
                         device=embed.device) for t in seqs]
    return Read(out,
                [torch.cat([z, torch.stack([r.experts for r in u])])
                 for z, u in zip(dense, used)],
                [torch.stack([r.gap for r in u]) for u in used],
                [torch.stack([r.own for r in u]) for u in used])
