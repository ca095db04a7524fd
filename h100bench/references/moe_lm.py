"""Plain PyTorch reference of the sparse MoE decoder family: Mixtral-8x7B
as its model card and ``config.json`` describe it.

Written from the published architecture, in float32 with TF32 off, with
no kernel, no cache and no batching. Every layer is the dense family's
attention block (``decoder_lm.py``: pre-RMSNorm, rotate-half RoPE with
base ``rope_theta``, grouped-query causal attention) followed by a
sparse block: router logits h·W_router over the ``num_local_experts``
experts, a softmax, the ``num_experts_per_tok`` largest probabilities
renormalised over the chosen experts (Mixtral's softmax → top-k →
renormalise, which equals a softmax over the chosen experts' logits),
and each token's output the gate-weighted sum of its chosen SwiGLU
experts (silu(h·W_gate) * (h·W_up))·W_down. No token is dropped. It
reads the weights in the tree layout of ``h100bench/moe_weights.py`` and
imports nothing of the program.

Departures from the source, each as the configuration file states: the
output head is the embedding's transpose (the configuration ties them);
RMSNorm adds ``rms_norm_eps`` as the file gives it; the router is a
float32 matrix (the source's gate is a bfloat16 layer) and the gates stay
float32 (the source casts them to the hidden dtype).

A routing record (``routes``: per sequence the (layers, positions, k)
expert ids some run used) makes each layer use the recorded experts at
each position, with gates from the reference's own float32 router logits
over those experts. Every (layer, position) then also gives a routing
gap: the reference's own k-th largest router logit minus the smallest of
the used experts' logits, clamped at 0, so 0 where the used experts are
the reference's own choice. Without a record it routes on its own.

:class:`Precision` (``decoder_lm.py``) rounds the operands of every
weight matmul, the router's included; the control runs ``"fp8"``.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from h100bench.references.decoder_lm import (  # noqa: F401 (no_tf32: judge)
    Arch,
    Precision,
    attention,
    no_tf32,
    rms_norm,
    rope,
    swiglu,
)


class MoEArch(Arch):
    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        self.experts = cfg["num_local_experts"]
        self.top_k = cfg["num_experts_per_tok"]


class Routed(NamedTuple):
    """One layer's routing over one sequence of S positions."""

    experts: torch.Tensor  # (S, k) the experts used
    gates: torch.Tensor    # (S, k) float32, summing to 1
    gap: torch.Tensor      # (S,) routing gap (0: the reference's own pick)
    own: torch.Tensor      # (S,) bool: the used set is the reference's own


def route(logits: torch.Tensor, top_k: int,
          given: Optional[torch.Tensor] = None) -> Routed:
    """Routing from router logits (S, E) float32, by the reference's own
    top-k or by the ``given`` (S, k) expert ids."""
    top = logits.topk(top_k, dim=-1)
    experts = top.indices if given is None else given.long()
    chosen = logits.gather(1, experts)
    gap = (top.values[:, -1] - chosen.min(-1).values).clamp_min(0)
    own = (experts.sort(-1).values == top.indices.sort(-1).values).all(-1)
    return Routed(experts, torch.softmax(chosen, dim=-1), gap, own)


def sparse_ffn(h: torch.Tensor, layer: Dict, a: MoEArch, prec: Precision,
               given: Optional[torch.Tensor] = None):
    """The sparse block over one sequence h (S, D) float32: (output (S, D),
    its :class:`Routed`)."""
    r = route(prec.mm(h, layer["w_router"]), a.top_k, given)
    out = torch.zeros_like(h)
    for e in range(a.experts):
        tok, k = (r.experts == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], layer["w_gate"][e], layer["w_up"][e],
                       layer["w_down"][e], prec)
            out.index_add_(0, tok, r.gates[tok, k, None] * y)
    return out, r


def block(x: torch.Tensor, layer: Dict, a: MoEArch, prec: Precision,
          given: Optional[torch.Tensor] = None):
    """One decoder layer over one sequence x (S, D), float32: (x, routing)."""
    s = x.shape[0]
    h = rms_norm(x, layer["ln1"], a.eps)
    q = prec.mm(h, layer["wq"].reshape(a.d, -1)).view(s, a.h, a.hd)
    kv = prec.mm(h, layer["wkv"].reshape(a.d, -1)).view(s, 2, a.kv, a.hd)
    o = attention(rope(q, a.theta), rope(kv[:, 0], a.theta), kv[:, 1], a)
    x = x + prec.mm(o.reshape(s, -1), layer["wo"].reshape(-1, a.d))
    out, r = sparse_ffn(rms_norm(x, layer["ln2"], a.eps), layer, a, prec,
                        given)
    return x + out, r


class Read(NamedTuple):
    """What :func:`logits` gives, per sequence."""

    logits: List[torch.Tensor]   # (len − start, V) float32
    experts: List[torch.Tensor]  # (layers, len, k) the experts used
    gaps: List[torch.Tensor]     # (layers, len) routing gaps
    own: List[torch.Tensor]      # (layers, len) bool


def logits(cfg: Dict, weights: Dict, seqs: Sequence[torch.Tensor],
           starts: Sequence[int], prec: Precision = Precision(),
           routes: Optional[Sequence[torch.Tensor]] = None) -> Read:
    """For each token sequence (1-D, on the weights' device) the float32
    logits of the positions from ``start`` on, each predicting the token
    after it, and each layer's routing at every position. ``routes``: per
    sequence the (layers, len, k) experts to use. Layer by layer over all
    sequences, one layer's weights upcast at a time."""
    a = MoEArch(cfg)
    embed = weights["embed"].float()
    xs = [embed[t.long()] for t in seqs]
    used: List[List[Routed]] = [[] for _ in seqs]
    with torch.no_grad():
        for li, layer in enumerate(weights["layers"]):
            lw = {k: v.float() for k, v in layer.items()}
            for i, x in enumerate(xs):
                given = None if routes is None else routes[i][li]
                xs[i], r = block(x, lw, a, prec, given)
                used[i].append(r)
            del lw
        out = [prec.mm(rms_norm(x[s:], weights["ln_f"].float(), a.eps),
                       embed.t()) for x, s in zip(xs, starts)]
    return Read(out,
                [torch.stack([r.experts for r in u]) for u in used],
                [torch.stack([r.gap for r in u]) for u in used],
                [torch.stack([r.own for r in u]) for u in used])
