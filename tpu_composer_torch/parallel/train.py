"""The training step on one card (port of ``tpu_composer/parallel/train.py``,
the single-device subset), for the dense and MoE models.

``make_train_step(tc)`` returns ``step(state, tokens) -> (state,
{"loss", "grad_norm"})``: forward and loss through autograd (the flash
path runs K1 with lse, then B3 and B4), then AdamW written out in
optax's order, so a state carried over from the JAX package steps the
same way (``convert.train_state_from_jax``). The state is
``{"params": tree, "opt": {"count", "mu", "nu"}}`` with ``mu`` and ``nu``
shaped and typed like the params.

What needs more than one device waits for the multi-device slice:
``sp_impl``/``sp_inner`` other than their defaults and
``pipeline_microbatches > 0`` raise ``NotImplementedError`` (the latter a
``ValueError`` for MoE, as in the JAX package, whose pipeline takes the
dense model only). The 'ep' mesh axis waits with them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from tpu_composer_torch.device import DeviceLike
from tpu_composer_torch.models import moe as moe_mod
from tpu_composer_torch.models import transformer as dense_mod
from tpu_composer_torch.models.moe import MoEConfig
from tpu_composer_torch.models.transformer import ModelConfig

_SP_IMPLS = ("ring", "zigzag", "ulysses")
_SP_INNERS = ("einsum", "flash")

# optax.adamw's defaults (b1, b2, eps; eps_root 0, no mask).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class TrainConfig:
    model: Union[ModelConfig, MoEConfig] = ModelConfig()
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    # Sequence parallelism applies when a mesh's sp axis is > 1: never on
    # one card, so this flag changes nothing here.
    use_ring_attention: bool = True
    sp_impl: str = "ring"  # ring | zigzag | ulysses (multi-device only)
    sp_inner: str = "einsum"  # einsum | flash (multi-device only)
    pipeline_microbatches: int = 0  # GPipe needs a 'pp' axis > 1
    # Split the global batch into this many sequential microbatches per
    # optimizer update; the accumulated gradient is exactly the
    # full-batch gradient (equal microbatch sizes, fp32 accumulators).
    grad_accum_steps: int = 1

    @property
    def is_moe(self) -> bool:
        return isinstance(self.model, MoEConfig)

    def _model_mod(self):
        return moe_mod if self.is_moe else dense_mod


def check_single_card(tc: TrainConfig) -> None:
    """Refuse the fields that need more than one device, never ignore
    them; unknown values raise ``ValueError`` as in the JAX package."""
    if tc.sp_impl not in _SP_IMPLS:
        raise ValueError(
            f"unknown sp_impl {tc.sp_impl!r} (want one of {sorted(_SP_IMPLS)})")
    if tc.sp_inner not in _SP_INNERS:
        raise ValueError(f"unknown sp_inner {tc.sp_inner!r} (einsum|flash)")
    if tc.sp_impl != "ring" or tc.sp_inner != "einsum":
        raise NotImplementedError(
            f"sp_impl={tc.sp_impl!r}, sp_inner={tc.sp_inner!r} need sequence"
            " parallelism over several devices: port slice 4")
    if tc.pipeline_microbatches > 0 and tc.is_moe:
        raise ValueError(
            "pipeline parallelism currently supports the dense model only")
    if tc.pipeline_microbatches > 0:
        raise NotImplementedError(
            "pipeline_microbatches > 0 needs a pipeline over several devices:"
            " port slice 4")
    if tc.grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {tc.grad_accum_steps}")


def tree_leaves(tree) -> List[Any]:
    """Leaves of a dict/list tree in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def init_opt_state(params) -> Dict:
    """optax ``scale_by_adam`` init: count 0 (int32), mu and nu zeros like
    the params (their dtypes too)."""
    device = params["embed"].device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def make_train_state(tc: TrainConfig, seed: int = 0,
                     device: DeviceLike = "cuda") -> Dict:
    """``{"params", "opt"}``: the model's params from ``seed``
    (``transformer.init_params`` or ``moe.init_params``) and a fresh
    AdamW state."""
    check_single_card(tc)
    params = tc._model_mod().init_params(tc.model, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params)}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: √(Σ over leaves of Σ g²), here in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 opt: Dict, lr: float, weight_decay: float) -> None:
    """One ``optax.adamw(lr, weight_decay=wd)`` step (optax 0.2.6), in
    place on ``params`` and on ``opt`` (its ``mu``/``nu`` leaves are given
    in the order of ``params``). Per leaf, in the param dtype:

        mu = (1 − b1)·g + b1·mu;   nu = (1 − b2)·g² + b2·nu
        u = (mu / (1 − b1^t)) / (√(nu / (1 − b2^t)) + eps)
        u = u + wd·p;   u = −lr·u;   p = (p + u) in p's dtype

    with t the step count after the increment and the bias corrections
    computed in fp32, then cast to the moment's dtype. Every op rounds to
    the leaf's dtype, and so do the scalar constants: JAX gives a Python
    float the array's dtype, so a bf16 leaf steps with b1 = 0.8984375 and
    b2 = 0.99609375, and this update matches optax's bit for bit. Decay
    applies to every leaf, norms included (no mask).
    ``torch.optim.AdamW`` decays first and rounds elsewhere, so bf16 runs
    would drift from the JAX package's.

    The constants are 0-d CPU tensors: a device op takes them as kernel
    scalars, so the update queues no host-to-device copy and never makes
    the host wait for the device."""
    opt["count"] += 1
    t = opt["count"].float()
    bc1 = 1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** t
    consts: Dict[torch.dtype, Tuple[torch.Tensor, ...]] = {}
    mus, nus = tree_leaves(opt["mu"]), tree_leaves(opt["nu"])
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if p.dtype not in consts:
            consts[p.dtype] = tuple(
                torch.tensor(x, dtype=p.dtype)
                for x in (1 - ADAM_B1, ADAM_B1, 1 - ADAM_B2, ADAM_B2,
                          ADAM_EPS, weight_decay, -lr))
        c1, b1, c2, b2, eps, wd, neg_lr = consts[p.dtype]
        mu.copy_(c1 * g + b1 * mu)
        nu.copy_(c2 * g ** 2 + b2 * nu)
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype))
                                       + eps)
        u = u + wd * p
        u = neg_lr * u
        p.copy_((p + u).to(p.dtype))


def make_train_step(tc: TrainConfig) -> Callable:
    """``step(state, tokens) -> (state, {"loss", "grad_norm"})`` for tokens
    (B, S) on the params' device. The metrics are 0-d fp32 tensors on the
    card: reading them is a host sync, left to the caller. The state is
    updated in place and returned (JAX donates it, ``train.py:398``)."""
    check_single_card(tc)
    cfg = tc.model
    loss_fn = tc._model_mod().loss_fn
    accum = tc.grad_accum_steps

    def value_and_grad(params, tokens) -> Tuple[torch.Tensor, List]:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, tokens, cfg)
        return loss.detach(), list(torch.autograd.grad(loss,
                                                       tree_leaves(live)))

    def grads_of(params, tokens):
        if accum == 1:
            return value_and_grad(params, tokens)
        if tokens.shape[0] % accum:
            raise ValueError(
                f"global batch {tokens.shape[0]} not divisible by "
                f"grad_accum_steps {accum}")
        micro = tokens.reshape(accum, tokens.shape[0] // accum,
                               tokens.shape[1])
        leaves = tree_leaves(params)
        # fp32 accumulators whatever the param dtype: bf16 sums would
        # round every microbatch and break the exact-equivalence contract.
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grad_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for mtok in micro:
            loss, grads = value_and_grad(params, mtok)
            loss_sum += loss.float()
            for s, g in zip(grad_sum, grads):
                s += g.float()
        # The mean of equal-size microbatch means is the full-batch mean.
        inv = 1.0 / accum
        return loss_sum * inv, [(s * inv).to(p.dtype)
                                for s, p in zip(grad_sum, leaves)]

    def step(state: Dict, tokens: torch.Tensor):
        loss, grads = grads_of(state["params"], tokens)
        with torch.no_grad():
            adamw_update(tree_leaves(state["params"]), grads, state["opt"],
                         tc.learning_rate, tc.weight_decay)
            grad_norm = global_norm(grads)
        return state, {"loss": loss.float(), "grad_norm": grad_norm}

    return step
