"""Mixture-of-Experts transformer (port of ``tpu_composer/models/moe.py``).

GShard/Switch-style top-k routing over a static capacity: each batch row
is one routing group, each expert holds ``capacity`` token slots per
row, and slots fill first come, first served in sequence order, every
k-th choice queueing behind all (k−1)-th choices. Tokens past an
expert's capacity are dropped: their FFN delta is zero and the residual
passes them through.

The JAX package builds one-hot (B, S, E, C) dispatch and combine
tensors and contracts them by einsum. The port routes by index instead:
each (token, choice) knows its (expert, slot) and each slot its
(token, choice), and both directions are gathers (:class:`_GatherRows`),
in the forward and in the backward, so no float is accumulated by a
scatter or an atomic and a token comes out the same bits every run. The
arithmetic is the reference's: router logits in fp32 (fp32 activations
times the fp32 router), expert inputs in the model dtype, the gate and
up products in fp32 before SiLU with their product cast back, and the
combine weights rounded to the model dtype before the top-k sum, which
runs in fp32 in choice order and is rounded once.
:func:`_top_k_routing` still returns the dense tensors, for the tests.

Layout (``param_specs``): expert stacks (E, D, F) with E over 'ep' and F
over 'tp'; attention and dense layers as ``models/transformer.py``; the
router (D, E) replicated, in fp32. Over a mesh the batch rows are
sharded over (dp, ep) and each rank routes its own rows (a row is a
routing group, so the capacity rule does not change); the dispatched
(E, B_local, C, D) expert inputs go to the experts' owners by an
all-to-all over 'ep' and come back the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.models.transformer import (
    AttnFn,
    ModelConfig,
    _rmsnorm,
    _select_attn,
    _tied_logits,
    attention_block,
    ffn_mesh,
    full_embedding,
    swiglu_ffn,
)
from tpu_composer_torch.parallel.collectives import (
    all_reduce,
    all_to_all,
    enter_parallel,
)


@dataclass(frozen=True)
class MoEConfig:
    """The MoE flagship. The dense fields mirror ModelConfig."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # grouped-query attention; None = MHA
    d_ff: int = 1408
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "reference"  # reference | flash
    rope_theta: float = 10000.0

    n_experts: int = 8
    top_k: int = 2  # 1 (Switch) or 2 (GShard)
    capacity_factor: float = 1.25
    moe_period: int = 2  # every moe_period-th layer is MoE (1 = all)
    router_aux_weight: float = 1e-2

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

    def is_moe_layer(self, i: int) -> bool:
        return i % self.moe_period == self.moe_period - 1

    def capacity(self, seq: int) -> int:
        """Per-expert token slots for one batch row (the routing group)."""
        cap = int(self.capacity_factor * seq * self.top_k / self.n_experts)
        return max(cap, self.top_k)

    def dense(self) -> ModelConfig:
        """The dense config with the same attention and embedding dims."""
        return ModelConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
            max_seq=self.max_seq, dtype=self.dtype, attn_impl=self.attn_impl,
            rope_theta=self.rope_theta,
        )


def init_params(config: MoEConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Dict:
    """Random params, N(0, 0.02) in fp32 cast to ``config.dtype``, from a
    CPU ``torch.Generator`` seeded with ``seed`` (the same weights on
    every device). Norms are ones in fp32 and the router stays fp32 (gating
    noise in bf16 degrades load balance). A layer draws its weights in the
    dense port's order, the router last."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02

    def dense(*shape):
        return normal(*shape).to(c.dtype).to(dev)

    def ones():
        return torch.ones(c.d_model, dtype=torch.float32, device=dev)

    embed = dense(c.vocab_size, c.d_model)
    layers = []
    for i in range(c.n_layers):
        stack = (c.n_experts,) if c.is_moe_layer(i) else ()
        layer = {
            "ln1": ones(),
            "wo": dense(c.n_heads, c.head_dim, c.d_model),
            "ln2": ones(),
            "w_gate": dense(*stack, c.d_model, c.d_ff),
            "w_up": dense(*stack, c.d_model, c.d_ff),
            "w_down": dense(*stack, c.d_ff, c.d_model),
        }
        if c.kv_heads == c.n_heads:
            layer["wqkv"] = dense(c.d_model, 3, c.n_heads, c.head_dim)
        else:
            layer["wq"] = dense(c.d_model, c.n_heads, c.head_dim)
            layer["wkv"] = dense(c.d_model, 2, c.kv_heads, c.head_dim)
        if c.is_moe_layer(i):
            layer["w_router"] = normal(c.d_model, c.n_experts).to(dev)
        layers.append(layer)
    return {"embed": embed, "layers": layers, "ln_f": ones()}


def param_specs(config: MoEConfig) -> Dict:
    """The JAX package's layout as plain data (per leaf a tuple of mesh
    axis names or None per dim): 'ep' shards the expert dim, 'tp' heads
    and the ffn width; the train step legalizes it."""
    c = config
    layers = []
    for i in range(c.n_layers):
        layer = {"ln1": (), "wo": ("tp", None, None), "ln2": ()}
        if c.kv_heads == c.n_heads:
            layer["wqkv"] = (None, None, "tp", None)
        else:
            layer["wq"] = (None, "tp", None)
            layer["wkv"] = (None, None, "tp", None)
        if c.is_moe_layer(i):
            layer.update(w_router=(), w_gate=("ep", None, "tp"),
                         w_up=("ep", None, "tp"), w_down=("ep", "tp", None))
        else:
            layer.update(w_gate=(None, "tp"), w_up=(None, "tp"),
                         w_down=("tp", None))
        layers.append(layer)
    return {"embed": ("tp", None), "layers": layers, "ln_f": ()}


def _route(logits: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing by index. logits (B, S, E) fp32 -> (expert (B, S, K)
    int64, slot (B, S, K) int64: the place in the expert's queue, −1 when
    the token is dropped, gate (B, S, K) fp32 normalised over the K
    choices, the Switch load-balancing aux loss).

    The reference's ops in its order: softmax as exp(x − max) / Σ; the
    first maximum wins a tie (``torch.argmax`` documents it, as
    ``jnp.argmax`` does); a chosen expert is masked by multiplying its
    probability by (1 − mask); the k-th choices' queue positions count
    every earlier claim, each row on its own."""
    b, s, e = logits.shape
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    masked = probs
    experts, gates, masks = [], [], []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        mask = F.one_hot(idx, e).to(torch.float32)
        experts.append(idx)
        gates.append((probs * mask).sum(dim=-1))
        masks.append(mask)
        masked = masked * (1.0 - mask)
    denom = sum(gates) + 1e-9
    claimed = torch.zeros((b, 1, e), dtype=torch.float32,
                          device=logits.device)
    slots = []
    for mask in masks:
        pos = torch.cumsum(mask, dim=1) - mask + claimed
        claimed = claimed + mask.sum(dim=1, keepdim=True)
        queue = (pos * mask).sum(dim=-1)  # the chosen expert's position
        slots.append(torch.where(queue < capacity, queue.long(), -1))
    frac = masks[0].mean(dim=1)  # (B, E) fraction routed (top-1)
    pmass = probs.mean(dim=1)    # (B, E) mean router probability
    aux = e * (frac * pmass).sum(dim=-1).mean()
    return (torch.stack(experts, -1), torch.stack(slots, -1),
            torch.stack([g / denom for g in gates], -1), aux)


def _top_k_routing(logits: torch.Tensor, top_k: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's dense tensors from router logits (B, S, E) fp32:
    (dispatch (B, S, E, C) 0/1 fp32, combine (B, S, E, C) fp32, aux).
    A dropped token has no slot: its rows are zero (where
    ``jax.nn.one_hot`` gives a zero row for an index past C)."""
    b, s, e = logits.shape
    experts, slots, gates, aux = _route(logits, top_k, capacity)
    dispatch = torch.zeros((b, s, e, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    for k in range(top_k):
        kept = (slots[..., k] >= 0).to(torch.float32)
        hit = (F.one_hot(experts[..., k], e).to(torch.float32)[..., None]
               * F.one_hot(slots[..., k].clamp_min(0), capacity).to(
                   torch.float32)[:, :, None, :]
               * kept[..., None, None])
        dispatch = dispatch + hit
        combine = combine + gates[..., k, None, None] * hit
    return dispatch, combine, aux


def _take_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """src (N, D) rows at ``index`` (any shape, −1 = a zero row)."""
    rows = src[index.clamp_min(0)]
    return torch.where((index >= 0)[..., None], rows,
                       torch.zeros((), dtype=src.dtype, device=src.device))


class _GatherRows(torch.autograd.Function):
    """out[i] = src[index[i]] (zero where index[i] < 0). The backward is a
    gather too: grad_src[j] = Σ_m grad_out[inverse[j, m]] over the
    out-rows that read row j, summed in the order of m. Routing gives
    every slot at most one (token, choice) and every (token, choice) at
    most one slot, so the two maps are each other's inverse."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _take_rows(src, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        parts = _take_rows(grad.contiguous(), inverse)
        total = parts[:, 0]
        for m in range(1, parts.shape[1]):
            total = total + parts[:, m]
        return total, None, None


def _moe_ffn(x: torch.Tensor, layer: Dict, config: MoEConfig,
             capacity: Optional[int] = None, mesh=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux). SwiGLU experts. ``capacity``
    overrides the capacity-factor rule (the decode path passes the
    drop-free capacity S: top-k picks distinct experts per token, so S
    slots never overflow). With ``mesh``, the local expert stacks say
    what is sharded: experts over 'ep' (their inputs cross by
    all-to-all) and the expert width over 'tp' (a tp region as in the
    dense FFN)."""
    c = config
    b, s, d = x.shape
    e, k = c.n_experts, c.top_k
    cap = capacity if capacity is not None else c.capacity(s)
    ep_mesh = mesh if layer["w_gate"].shape[0] < e else None
    tp_mesh = ffn_mesh(layer, c, mesh)
    logits = torch.einsum("bsd,de->bse", x.float(), layer["w_router"].float())
    experts, slots, gates, aux = _route(logits, k, cap)

    # Slot ids in the (E, B, C) layout of the expert inputs; -1 = dropped.
    n_slots = e * b * cap
    row = torch.arange(b, device=x.device)[:, None, None]
    tok_slot = torch.where(slots >= 0, (experts * b + row) * cap + slots,
                           -1).reshape(b * s, k)
    # The inverse map, slot -> (token, choice) id, by an integer scatter:
    # real slots are distinct, dropped choices all land in one spare cell.
    choice = torch.arange(b * s * k, device=x.device)
    slot_src = torch.full((n_slots + 1,), -1, dtype=torch.long,
                          device=x.device).scatter_(
        0, torch.where(tok_slot >= 0, tok_slot, n_slots).reshape(-1),
        choice)[:n_slots]
    slot_tok = torch.where(slot_src >= 0, slot_src // k, -1)

    xin = _GatherRows.apply(x.reshape(b * s, d), slot_tok, tok_slot)
    # (E, B, C, D) -> (E/ep, ep·B, C, D): expert chunk j to ep rank j.
    xin = all_to_all(xin.reshape(e, b, cap, d), ep_mesh, "ep", 0, 1)
    e_local = xin.shape[0]
    xin = enter_parallel(xin.reshape(e_local, -1, d), tp_mesh, "tp")
    h_gate = F.silu(torch.bmm(xin, resolve(layer["w_gate"], c.dtype)).float())
    h_up = torch.bmm(xin, resolve(layer["w_up"], c.dtype)).float()
    xout = torch.bmm((h_gate * h_up).to(c.dtype),
                     resolve(layer["w_down"], c.dtype))
    xout = all_reduce(xout, tp_mesh, "tp").reshape(e_local, -1, cap, d)
    # And back: (E/ep, ep·B, C, D) -> (E, B, C, D).
    xout = all_to_all(xout, ep_mesh, "ep", 1, 0)
    picked = _GatherRows.apply(xout.reshape(n_slots, d),
                               tok_slot.reshape(-1), slot_src[:, None])
    picked = picked.reshape(b * s, k, d).float()
    weight = torch.where(slots >= 0, gates, 0.0).to(c.dtype).float()
    weight = weight.reshape(b * s, k, 1)
    out = weight[:, 0] * picked[:, 0]
    for j in range(1, k):
        out = out + weight[:, j] * picked[:, j]
    return out.to(c.dtype).reshape(b, s, d), aux


def ffn_delta(h: torch.Tensor, layer: Dict, layer_idx: int, config,
              drop_free: bool = False,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN residual with the MoE-or-dense branch in one place
    (``forward`` and the cached decode paths call it): expert dispatch on
    MoE layers, SwiGLU otherwise. Returns (delta, aux).

    ``drop_free=True`` sizes the capacity at S, so routing never drops a
    token: the decode-chunk semantic (a T-token chunk computes what T
    single steps would, which speculative verify relies on)."""
    c = config
    if isinstance(c, MoEConfig) and c.is_moe_layer(layer_idx):
        return _moe_ffn(h, layer, c,
                        capacity=h.shape[1] if drop_free else None,
                        mesh=mesh)
    return (swiglu_ffn(h, layer, c.dtype, ffn_mesh(layer, c, mesh)),
            torch.zeros((), dtype=torch.float32, device=h.device))


def forward(params: Dict, tokens: torch.Tensor, config: MoEConfig,
            attn_fn: Optional[AttnFn] = None, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V) fp32, the aux loss averaged over MoE layers).
    ``mesh`` as in ``transformer.forward``; the aux loss is then the mean
    over this rank's rows (the train step averages equal shards)."""
    c = config
    attn = _select_attn(c, attn_fn)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    embed = full_embedding(params["embed"], c, mesh)
    x = embedding_lookup(embed, tokens, c.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, layer in enumerate(params["layers"]):
        x = attention_block(layer, x, positions, c, attn, mesh)
        delta, aux = ffn_delta(_rmsnorm(x, layer["ln2"]), layer, i, c,
                               mesh=mesh)
        x = x + delta
        aux_total = aux_total + aux
    x = _rmsnorm(x, params["ln_f"])
    n_moe = sum(1 for i in range(c.n_layers) if c.is_moe_layer(i))
    return _tied_logits(x, embed, c.dtype), aux_total / max(n_moe, 1)


def loss_fn(params: Dict, tokens: torch.Tensor, config: MoEConfig,
            attn_fn: Optional[AttnFn] = None, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy on fp32 logits plus
    ``router_aux_weight`` × the load-balancing aux."""
    logits, aux = forward(params, tokens, config, attn_fn, mesh)
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean() + config.router_aux_weight * aux
