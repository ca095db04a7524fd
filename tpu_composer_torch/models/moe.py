"""Mixture-of-Experts transformer (port of ``tpu_composer/models/moe.py``).

GShard/Switch-style top-k routing over a static capacity: each batch row
is one routing group, each expert holds ``capacity`` token slots per
row, and slots fill first come, first served in sequence order, every
k-th choice queueing behind all (k−1)-th choices. Tokens past an
expert's capacity are dropped: their FFN delta is zero and the residual
passes them through. A DROPLESS config (``capacity_factor=None``, as
Mixtral routes) gives every expert as many slots as the row has tokens,
in every path, so no token is ever dropped and a token's routing never
depends on the others in its row (pads included).

The JAX package builds one-hot (B, S, E, C) dispatch and combine
tensors and contracts them by einsum. The port routes by index instead:
each (token, choice) knows its (expert, slot) and each slot its
(token, choice), and both directions are gathers (:class:`_GatherRows`),
in the forward and in the backward, so no float is accumulated by a
scatter or an atomic and a token comes out the same bits every run. The
arithmetic is the reference's: router logits in fp32 (fp32 activations
times the fp32 router), expert inputs in the model dtype, the gate and
up products in fp32 before SiLU with their product cast back
(``ops/swiglu.swiglu``, one kernel on the card in bf16), and the
combine weights rounded to the model dtype before the top-k sum, which
runs in fp32 in choice order and is rounded once.
:func:`_top_k_routing` still returns the dense tensors, for the tests.

Two paths compute the experts, and :func:`_grouped_reason` picks one per
call. The GROUPED path (:func:`_grouped_ffn`) runs where no token can be
dropped (a dropless config, or a call that passes ``drop_free``:
capacity ≥ S), with no mesh, on bf16 contiguous CUDA operands outside
autograd: the serving engines' admissions and decode steps on the card.
It routes as the other path does but asks for no queue slots, groups
the routed (token, choice) pairs by expert and runs each expert's
products over its own rows only, through the hand-written kernels of
``csrc/moe_grouped.cu`` (``ops/moe_grouped``); it never builds the
(E, B, C) layout. Every other call (training, the CPU, a capacity-routed
forward, the ep/tp mesh) lays the expert inputs out as (E, B, C), each
expert computing every slot of every row, as below. The two differ only
in the order of the sums inside the products.

Layout (``param_specs``): expert stacks (E, D, F) with E over 'ep' and F
over 'tp'; attention and dense layers as ``models/transformer.py``; the
router (D, E) replicated, in fp32. Over a mesh the batch rows are
sharded over (dp, ep) and each rank routes its own rows (a row is a
routing group, so the capacity rule does not change); the dispatched
(E, B_local, C, D) expert inputs go to the experts' owners by an
all-to-all over 'ep' and come back the same way.

A config may instead route as DeepSeek-V3 does (``scoring_func=
"sigmoid"``, :func:`_route_sigmoid`): sigmoid scores, a per-layer
selection bias (``e_score_correction_bias``, (E,) fp32, in the layer's
tree), gates normalised over the chosen and scaled; its MoE layers may
follow leading dense ones and add shared experts (``shared_w_gate``,
``shared_w_up``, ``shared_w_down``: one SwiGLU every token takes), and
its experts may be narrower than the dense FFN.

While a ``runtime/tracing`` tree is the thread's (a serving engine's
step), each MoE layer records its spans in it: ``moe.route`` (arg
``score``, ``softmax`` or ``sigmoid``), ``moe.dispatch``, ``moe.experts``
(args ``rows``, the rows the expert products compute: E × B × C, or
B × S × k on the grouped path; ``real``, the B × S × k (token, choice)
pairs routed, both from shapes; ``fused``, 1 where SwiGLU's step ran the
kernel ``csrc/swiglu.cu``, else 0; ``grouped``, 1 on the grouped path,
else 0), ``moe.combine`` and, with shared experts, ``moe.shared`` (on
the grouped path before ``moe.combine``, which adds it). They time the
host's issue of each phase, not the device's work.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

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
from tpu_composer_torch.ops import moe_grouped
from tpu_composer_torch.ops.swiglu import swiglu, swiglu_cuda
from tpu_composer_torch.parallel.collectives import (
    all_reduce,
    all_to_all,
    enter_parallel,
)
from tpu_composer_torch.runtime import tracing


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
    capacity_factor: Optional[float] = 1.25  # None = dropless
    moe_period: int = 2  # every moe_period-th layer is MoE (1 = all)
    router_aux_weight: float = 1e-2
    # DeepSeek-V3's block (its config.json keys): the first
    # ``first_k_dense_replace`` layers are dense, the experts are as wide
    # as their weights say (not necessarily d_ff) beside
    # ``n_shared_experts`` shared ones that every token takes (one SwiGLU
    # of their summed width), and ``scoring_func="sigmoid"`` routes as
    # :func:`_route_sigmoid` does, the gates scaled by
    # ``routed_scaling_factor``. The defaults are Mixtral's block.
    first_k_dense_replace: int = 0
    n_shared_experts: int = 0
    scoring_func: str = "softmax"  # softmax | sigmoid
    routed_scaling_factor: float = 1.0

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
        return (i >= self.first_k_dense_replace
                and i % self.moe_period == self.moe_period - 1)

    @property
    def dropless(self) -> bool:
        return self.capacity_factor is None

    def capacity(self, seq: int) -> int:
        """Per-expert token slots for one batch row (the routing group):
        ``seq`` when dropless, which no expert can overflow (a token's
        top-k experts are distinct)."""
        if self.dropless:
            return seq
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


def _route(logits: torch.Tensor, top_k: int, capacity: Optional[int]):
    """Top-k routing by index. logits (B, S, E) fp32 -> (expert (B, S, K)
    int64, slot (B, S, K) int64: the place in the expert's queue, −1 when
    the token is dropped, or None where ``capacity`` is None (the grouped
    path needs no slots), gate (B, S, K) fp32 normalised over the K
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
    frac = masks[0].mean(dim=1)  # (B, E) fraction routed (top-1)
    pmass = probs.mean(dim=1)    # (B, E) mean router probability
    aux = e * (frac * pmass).sum(dim=-1).mean()
    slots = None if capacity is None else _queue_slots(masks, capacity)
    return (torch.stack(experts, -1), slots,
            torch.stack([g / denom for g in gates], -1), aux)


def _queue_slots(masks, capacity: int) -> torch.Tensor:
    """Each choice's place in its expert's queue, (B, S, K) int64, −1
    past ``capacity``, from the choices' one-hot masks (B, S, E) fp32 in
    choice order: the k-th choices queue behind every earlier claim,
    each row on its own."""
    b, _, e = masks[0].shape
    claimed = torch.zeros((b, 1, e), dtype=torch.float32,
                          device=masks[0].device)
    slots = []
    for mask in masks:
        pos = torch.cumsum(mask, dim=1) - mask + claimed
        claimed = claimed + mask.sum(dim=1, keepdim=True)
        queue = (pos * mask).sum(dim=-1)  # the chosen expert's position
        slots.append(torch.where(queue < capacity, queue.long(), -1))
    return torch.stack(slots, -1)


def _route_sigmoid(logits: torch.Tensor, bias: torch.Tensor, top_k: int,
                   capacity: Optional[int], scale: float):
    """DeepSeek-V3's routing (``noaux_tc`` with one group), by index, in
    :func:`_route`'s outputs: scores s = sigmoid(logits) (B, S, E) fp32;
    the top-k of s + ``bias`` (E,) fp32 are chosen, the bias moving
    selection only; the gates are the chosen s over their sum, times
    ``scale``. No aux loss (the bias replaces it)."""
    e = logits.shape[-1]
    scores = torch.sigmoid(logits)
    experts = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    chosen = scores.gather(-1, experts)
    gates = chosen / chosen.sum(dim=-1, keepdim=True) * scale
    slots = None
    if capacity is not None:
        masks = [F.one_hot(experts[..., j], e).to(torch.float32)
                 for j in range(top_k)]
        slots = _queue_slots(masks, capacity)
    return (experts, slots, gates,
            torch.zeros((), dtype=torch.float32, device=logits.device))


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


class _Phases:
    """The MoE layer's phases as spans of the thread's tracing tree, if
    one is open: ``next(name)`` ends the running phase and begins
    ``name``; ``end()`` ends the last."""

    __slots__ = ("tree",)

    def __init__(self, **args):
        self.tree = tracing.current_tree()
        if self.tree is not None:
            self.tree.begin("moe.route", **args)

    def next(self, name: str, **args) -> None:
        if self.tree is not None:
            self.tree.end()
            self.tree.begin(name, **args)

    def note(self, **args) -> None:
        """Add ``args`` to the running phase's span."""
        if self.tree is not None:
            self.tree.note(**args)

    def end(self) -> None:
        if self.tree is not None:
            self.tree.end()


def _moe_ffn(x: torch.Tensor, layer: Dict, config: MoEConfig,
             capacity: Optional[int] = None, mesh=None,
             record: Optional[Callable[[torch.Tensor], None]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux). SwiGLU experts. ``capacity``
    overrides the config's rule (the decode path passes the drop-free
    capacity S: top-k picks distinct experts per token, so S slots never
    overflow). With ``mesh``, the local expert stacks say what is
    sharded: experts over 'ep' (their inputs cross by all-to-all) and
    the expert width over 'tp' (a tp region as in the dense FFN).
    ``record`` is handed the (B, S, k) expert ids that dispatch reads."""
    c = config
    b, s, d = x.shape
    e, k = c.n_experts, c.top_k
    cap = capacity if capacity is not None else c.capacity(s)
    grouped = _grouped_reason(x, layer, cap, mesh) is None
    phases = _Phases(score=c.scoring_func)
    logits = torch.einsum("bsd,de->bse", x.float(), layer["w_router"].float())
    route_cap = None if grouped else cap
    if c.scoring_func == "sigmoid":
        experts, slots, gates, aux = _route_sigmoid(
            logits, layer["e_score_correction_bias"], k, route_cap,
            c.routed_scaling_factor)
    else:
        experts, slots, gates, aux = _route(logits, k, route_cap)
    if record is not None:
        record(experts)
    if grouped:
        return _grouped_ffn(x, layer, c, experts, gates, phases), aux
    ep_mesh = mesh if layer["w_gate"].shape[0] < e else None
    tp_mesh = ffn_mesh(layer, c, mesh)
    phases.next("moe.dispatch")

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
    phases.next("moe.experts", rows=n_slots, real=b * s * k, grouped=0)
    h_gate = torch.bmm(xin, resolve(layer["w_gate"], c.dtype))
    h_up = torch.bmm(xin, resolve(layer["w_up"], c.dtype))
    launched = swiglu_cuda.launches
    h = swiglu(h_gate, h_up)
    phases.note(fused=swiglu_cuda.launches - launched)
    xout = torch.bmm(h, resolve(layer["w_down"], c.dtype))
    phases.next("moe.combine")
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
    if c.n_shared_experts:
        # The shared experts as one SwiGLU, added in fp32 before the one
        # rounding of the layer's output.
        phases.next("moe.shared")
        shared = {n: layer["shared_" + n] for n in ("w_gate", "w_up",
                                                    "w_down")}
        out = out + swiglu_ffn(x, shared, c.dtype).float().reshape(b * s, d)
    phases.end()
    return out.to(c.dtype).reshape(b, s, d), aux


def _grouped_reason(x: torch.Tensor, layer: Dict, capacity: int, mesh
                    ) -> Optional[str]:
    """Why :func:`_moe_ffn` runs the (E, B, C) path on this call
    (``"capacity"``: fewer slots than the row has tokens, so one can be
    dropped; ``"mesh"``; or what ``ops/moe_grouped.kernel_reason`` finds
    against the operands: autograd, dtype, layout, device, shape), or
    None where it runs :func:`_grouped_ffn`."""
    if capacity < x.shape[1]:
        return "capacity"
    if mesh is not None:
        return "mesh"
    return moe_grouped.kernel_reason(x, layer["w_gate"], layer["w_up"],
                                     layer["w_down"])


def _grouped_ffn(x: torch.Tensor, layer: Dict, config: MoEConfig,
                 experts: torch.Tensor, gates: torch.Tensor,
                 phases: _Phases) -> torch.Tensor:
    """The experts over the routed (token, choice) pairs alone: x (B, S, D)
    and the routing's (B, S, k) ids and gates -> the layer's output
    (B, S, D). The pairs are grouped by expert, each expert's gate/up
    (with SwiGLU's step) and down products run over its own rows, and the
    combine sums each token's k rows with the shared experts' output
    (``ops/moe_grouped``: the kernels on the card, their twins on the
    CPU). Nothing is dropped and no (E, B, C) tensor is built."""
    c = config
    b, s, d = x.shape
    t, k = b * s, c.top_k
    phases.next("moe.dispatch")
    offsets, tok, row = moe_grouped.group(
        experts.reshape(t, k).contiguous(), c.n_experts)
    phases.next("moe.experts", rows=t * k, real=t * k, fused=0, grouped=1)
    h = moe_grouped.gate_up(x.reshape(t, d), tok, layer["w_gate"],
                            layer["w_up"], offsets)
    y = moe_grouped.down(h, layer["w_down"], offsets)
    shared = None
    if c.n_shared_experts:
        phases.next("moe.shared")
        shared = swiglu_ffn(x, {n: layer["shared_" + n] for n in (
            "w_gate", "w_up", "w_down")}, c.dtype).reshape(t, d)
    phases.next("moe.combine")
    out = moe_grouped.combine(y, row, gates.reshape(t, k).contiguous(),
                              shared)
    phases.end()
    return out.reshape(b, s, d)


#: Writes a MoE layer's expert ids: ``record(layer_idx, experts (B, S, k))``.
RouteRecord = Callable[[int, torch.Tensor], None]


def ffn_delta(h: torch.Tensor, layer: Dict, layer_idx: int, config,
              drop_free: bool = False, mesh=None,
              record: Optional[RouteRecord] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN residual with the MoE-or-dense branch in one place
    (``forward`` and the cached decode paths call it): expert dispatch on
    MoE layers, SwiGLU otherwise. Returns (delta, aux).

    ``drop_free=True`` sizes the capacity at S, so routing never drops a
    token: the decode-chunk semantic (a T-token chunk computes what T
    single steps would, which speculative verify relies on); a dropless
    config routes so everywhere. ``record`` receives each MoE layer's
    expert ids."""
    c = config
    if isinstance(c, MoEConfig) and c.is_moe_layer(layer_idx):
        return _moe_ffn(h, layer, c,
                        capacity=h.shape[1] if drop_free else None,
                        mesh=mesh,
                        record=None if record is None
                        else functools.partial(record, layer_idx))
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
