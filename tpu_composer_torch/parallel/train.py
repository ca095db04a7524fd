"""The training step, on one card or over a device mesh (port of
``tpu_composer/parallel/train.py``), for the dense and MoE models.

``make_train_step(tc, mesh=None)`` returns ``step(state, tokens) ->
(state, {"loss", "grad_norm"})``: forward and loss through autograd (the
flash path runs K1 with lse, then B3 and B4), then AdamW written out in
optax's order, so a state carried over from the JAX package steps the
same way (``convert.train_state_from_jax``). The state is
``{"params": tree, "opt": {"count", "mu", "nu"}}`` with ``mu`` and ``nu``
shaped and typed like the params.

Over a mesh (``parallel/mesh.py``: dims dp, ep, pp, sp, tp) each rank
holds the local shards of ``param_specs``, legalized as the JAX package
does, and calls its collectives explicitly where GSPMD would insert
them:

- the batch rows are sharded over dp (and over (dp, ep) for MoE when
  ep > 1): ``step`` takes the global batch and keeps this rank's rows;
- outside attention the sequence is replicated over sp, so the loss's
  next-token shift needs no other shard; attention slices the sequence
  over sp and runs ring, zigzag or Ulysses attention with the einsum or
  the flash inner (``_sp_attn_fn``);
- tp and ep run as regions inside the model (``models/transformer.py``,
  ``models/moe.py``);
- each gradient is summed over the data axes it is not sharded over and
  divided by the number of data shards (the loss is the mean of equal
  shards); the grad norm is read over all shards; AdamW then runs on
  the local shards, elementwise, so sharding changes none of its bits.

``pipeline_microbatches > 0`` (GPipe over 'pp') raises
``NotImplementedError``: it comes with port slice 4b, with the reshard
of a live state onto another mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models import moe as moe_mod
from tpu_composer_torch.models import transformer as dense_mod
from tpu_composer_torch.models.moe import MoEConfig
from tpu_composer_torch.models.transformer import ModelConfig
from tpu_composer_torch.ops.attention import flash_attention
from tpu_composer_torch.parallel import collectives as coll
from tpu_composer_torch.parallel.mesh import axis_index, axis_size
from tpu_composer_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_zigzag,
)
from tpu_composer_torch.parallel.ulysses import ulysses_attention

# Sequence-parallel attention strategies: the ring (contiguous layout),
# the zigzag ring (balanced causal work) and all-to-all Ulysses.
_SP_IMPLS = {
    "ring": ring_attention,
    "zigzag": ring_attention_zigzag,
    "ulysses": ulysses_attention,
}
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
    # Sequence parallelism applies when the mesh's sp axis is > 1; False
    # attends over the replicated sequence instead.
    use_ring_attention: bool = True
    sp_impl: str = "ring"  # ring | zigzag | ulysses
    # The attention of each sp block: "einsum" or "flash" (K1 with lse,
    # B3 and B4).
    sp_inner: str = "einsum"
    pipeline_microbatches: int = 0  # GPipe over 'pp': port slice 4b
    # Split the global batch into this many sequential microbatches per
    # optimizer update; the accumulated gradient is exactly the
    # full-batch gradient (equal microbatch sizes, fp32 accumulators).
    grad_accum_steps: int = 1

    @property
    def is_moe(self) -> bool:
        return isinstance(self.model, MoEConfig)

    def _model_mod(self):
        return moe_mod if self.is_moe else dense_mod


def check_config(tc: TrainConfig, mesh: Optional[DeviceMesh] = None) -> None:
    """The JAX step's validation: unknown ``sp_impl``/``sp_inner`` and the
    flash inner under pipelining raise ``ValueError``, MoE under
    pipelining too. Pipelining itself is not ported yet and raises
    ``NotImplementedError``, never ignored."""
    if tc.sp_impl not in _SP_IMPLS:
        raise ValueError(
            f"unknown sp_impl {tc.sp_impl!r} (want one of {sorted(_SP_IMPLS)})")
    if tc.sp_inner not in _SP_INNERS:
        raise ValueError(f"unknown sp_inner {tc.sp_inner!r} (einsum|flash)")
    if tc.grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {tc.grad_accum_steps}")
    if tc.pipeline_microbatches > 0:
        if tc.is_moe:
            raise ValueError(
                "pipeline parallelism currently supports the dense model only")
        if tc.sp_inner == "flash" and axis_size(mesh, "pp") > 1:
            raise ValueError(
                "sp_inner='flash' is not supported with pipeline parallelism")
        raise NotImplementedError(
            "pipeline_microbatches > 0 needs GPipe over a 'pp' mesh axis:"
            " port slice 4b (pipeline and reshard)")


def tree_leaves(tree) -> List[Any]:
    """Leaves of a dict/list tree in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """The tree shaped like ``like`` whose leaves, in ``tree_leaves``
    order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {key: build(t[key]) for key in sorted(t)}
            return {key: out[key] for key in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


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


def legalize_spec(spec: Tuple, shape, mesh: Optional[DeviceMesh]) -> Tuple:
    """``spec`` (one mesh-axis name or None per dim, ``()`` replicated)
    with every axis that does not divide its dim dropped (replicated), as
    ``_legalize_spec`` does it: MQA's single kv head under tp = 2 is
    replicated, not refused."""
    dims = []
    for i in range(len(shape)):
        ax = spec[i] if i < len(spec) else None
        size = axis_size(mesh, ax) if ax is not None else 1
        dims.append(ax if size > 1 and shape[i] % size == 0 else None)
    return tuple(dims)


def tree_leaves_specs(specs) -> List[Tuple]:
    """The leaves of a spec tree (whose leaves are tuples) in
    ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [x for key in sorted(specs)
                for x in tree_leaves_specs(specs[key])]
    if isinstance(specs, list):
        return [x for item in specs for x in tree_leaves_specs(item)]
    return [specs]


def leaf_specs(tc: TrainConfig, mesh: Optional[DeviceMesh]) -> List[Tuple]:
    """The legalized spec of every param leaf, in ``tree_leaves`` order,
    from the full shapes (read off params built on the meta device)."""
    mod = tc._model_mod()
    shapes = [p.shape for p in tree_leaves(
        mod.init_params(tc.model, seed=0, device="meta"))]
    specs = tree_leaves_specs(mod.param_specs(tc.model))
    return [legalize_spec(sp, shape, mesh) for sp, shape in zip(specs, shapes)]


def _local(x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = x.chunk(axis_size(mesh, ax), dim=dim)[axis_index(mesh, ax)]
    return x.contiguous()


def _with_specs(fn: Callable, tree, specs, *rest):
    """``fn(leaf, spec, *rest_leaves)`` over ``tree``, beside the spec tree
    of ``param_specs`` (whose tuple leaves are specs, not containers)."""
    if isinstance(tree, dict):
        return {key: _with_specs(fn, tree[key], specs[key],
                                 *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, list):
        return [_with_specs(fn, *items)
                for items in zip(tree, specs, *rest)]
    return fn(tree, specs, *rest)


def shard_params(tc: TrainConfig, params, mesh: Optional[DeviceMesh]):
    """This rank's shards of the full tree ``params`` on ``mesh``."""
    return _with_specs(
        lambda p, sp: _local(p, legalize_spec(sp, p.shape, mesh), mesh),
        params, tc._model_mod().param_specs(tc.model))


def gather_params(tc: TrainConfig, local, mesh: Optional[DeviceMesh]):
    """The full tree from every rank's shards ``local``, the inverse of
    :func:`shard_params`: a collective, which every rank calls."""
    mod = tc._model_mod()

    def full(p, spec, like):
        for dim, ax in enumerate(legalize_spec(spec, like.shape, mesh)):
            if ax is not None:
                p = coll.all_gather(p.detach(), mesh, ax, axis=dim)
        return p

    return _with_specs(full, local, mod.param_specs(tc.model),
                       mod.init_params(tc.model, seed=0, device="meta"))


def shard_state(tc: TrainConfig, state: Dict, mesh: Optional[DeviceMesh],
                device: DeviceLike = "cuda") -> Dict:
    """This rank's shards of a full train state (params, mu and nu alike;
    the step count is replicated), on ``device``."""
    dev = resolve_device(device)
    opt = state["opt"]
    return tree_map(lambda t: t.to(dev), {
        "params": shard_params(tc, state["params"], mesh),
        "opt": {"count": opt["count"],
                "mu": shard_params(tc, opt["mu"], mesh),
                "nu": shard_params(tc, opt["nu"], mesh)}})


def gather_state(tc: TrainConfig, state: Dict,
                 mesh: Optional[DeviceMesh]) -> Dict:
    """The full train state from every rank's shards (a collective)."""
    opt = state["opt"]
    return {"params": gather_params(tc, state["params"], mesh),
            "opt": {"count": opt["count"],
                    "mu": gather_params(tc, opt["mu"], mesh),
                    "nu": gather_params(tc, opt["nu"], mesh)}}


def make_train_state(tc: TrainConfig, seed: int = 0,
                     device: DeviceLike = "cuda",
                     mesh: Optional[DeviceMesh] = None) -> Dict:
    """``{"params", "opt"}``: the model's params from ``seed``
    (``transformer.init_params`` or ``moe.init_params``; the same weights
    on every device) and a fresh AdamW state. With ``mesh``, this rank's
    shards of them."""
    check_config(tc, mesh)
    dev = resolve_device(device)
    mod = tc._model_mod()
    if mesh is None:
        params = mod.init_params(tc.model, seed=seed, device=dev)
    else:
        full = mod.init_params(tc.model, seed=seed, device="cpu")
        params = tree_map(lambda p: p.to(dev),
                          shard_params(tc, full, mesh))
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


def _n_shards(spec: Tuple, mesh: DeviceMesh) -> int:
    """The number of distinct shards of a leaf under the legalized
    ``spec``."""
    n = 1
    for ax in spec:
        if ax is not None:
            n *= axis_size(mesh, ax)
    return n


def data_axes(tc: TrainConfig, mesh: Optional[DeviceMesh]) -> Tuple[str, ...]:
    """The mesh dims the batch rows are sharded over: dp, and ep too for
    MoE when ep > 1 (ep doubles as a data axis for the non-expert
    params)."""
    if tc.is_moe and axis_size(mesh, "ep") > 1:
        return ("dp", "ep")
    return ("dp",)


def data_shards(tc: TrainConfig, mesh: Optional[DeviceMesh]) -> int:
    """The number of batch shards: the product of :func:`data_axes`."""
    n = 1
    for ax in data_axes(tc, mesh):
        n *= axis_size(mesh, ax)
    return n


def data_index(tc: TrainConfig, mesh: Optional[DeviceMesh]) -> int:
    """Which of the :func:`data_shards` row blocks this rank holds
    (``P(batch_axes, None)``: dp outermost)."""
    idx = 0
    for ax in data_axes(tc, mesh):
        idx = idx * axis_size(mesh, ax) + axis_index(mesh, ax)
    return idx


def local_batch(tc: TrainConfig, tokens: torch.Tensor,
                mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """This rank's rows of the global batch."""
    n = data_shards(tc, mesh)
    if n == 1:
        return tokens
    if tokens.shape[0] % n:
        raise ValueError(
            f"global batch {tokens.shape[0]} must be divisible by the mesh's"
            f" data-axis product {n}")
    return tokens.chunk(n, dim=0)[data_index(tc, mesh)]


def _sp_attn_fn(mesh: DeviceMesh, impl: str, inner: str,
                n_heads: int) -> Callable:
    """Sequence-parallel attention over 'sp' for q/k/v (B, S, H_local,
    D) that hold the whole (replicated) sequence: each rank slices its
    chunk of the sequence (the slice's backward gathers the cotangents),
    runs ``impl`` with the einsum or the flash inner, and gathers the
    output back to the whole sequence (its backward keeps this rank's
    chunk).

    The head axis: q, k and v arrive with the heads the tp layout gave
    them. Ulysses splits those heads over sp, so when tp-sharded heads
    are not divisible by sp (the JAX package's rule with the flash
    inner) the heads are gathered over tp around the region and the
    output sliced back."""
    sp_fn = _SP_IMPLS[impl]
    if impl == "ulysses":
        kw = {"attn_fn": flash_attention} if inner == "flash" else {}
    else:
        kw = {"inner": inner}
    sp = axis_size(mesh, "sp")

    def attn(q, k, v, causal=True):
        if not causal:
            raise ValueError("the sequence-parallel path is causal-only")
        gather = (impl == "ulysses" and q.shape[2] < n_heads
                  and (q.shape[2] % sp or k.shape[2] % sp))
        if gather:
            q, k, v = (coll.all_gather(t, mesh, "tp", axis=2)
                       for t in (q, k, v))
        q, k, v = (coll.shard(t, mesh, "sp", axis=1) for t in (q, k, v))
        o = sp_fn(q, k, v, mesh, "sp", causal=True, **kw)
        o = coll.all_gather(o, mesh, "sp", axis=1)
        return coll.shard(o, mesh, "tp", axis=2) if gather else o

    return attn


def make_grad_fn(tc: TrainConfig,
                 mesh: Optional[DeviceMesh] = None) -> Callable:
    """``grads(params, tokens) -> (loss, grads, grad_norm)`` for the
    global batch ``tokens``: the train step without its update. ``grads``
    are this rank's, in ``tree_leaves`` order, already reduced over the
    mesh (the gradient of the global mean loss); ``loss`` and
    ``grad_norm`` are the global ones, the same on every rank."""
    check_config(tc, mesh)
    cfg = tc.model
    mod = tc._model_mod()
    accum = tc.grad_accum_steps
    attn_fn = None
    if mesh is not None and tc.use_ring_attention \
            and axis_size(mesh, "sp") > 1:
        attn_fn = _sp_attn_fn(mesh, tc.sp_impl, tc.sp_inner, cfg.n_heads)
    shards, axes = data_shards(tc, mesh), data_axes(tc, mesh)
    if mesh is not None:
        specs = leaf_specs(tc, mesh)
        # A leaf's share of the world's sum of squares: 1 over its copies
        # (the ranks that hold the same shard).
        weights = [_n_shards(spec, mesh) / mesh.size()
                   for spec in specs]

    def loss_fn(params, tokens):
        if mesh is None:
            return mod.loss_fn(params, tokens, cfg)
        return mod.loss_fn(params, tokens, cfg, attn_fn, mesh)

    def value_and_grad(params, tokens) -> Tuple[torch.Tensor, List]:
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = loss_fn(live, tokens)
        return loss.detach(), list(torch.autograd.grad(loss,
                                                       tree_leaves(live)))

    def grads_of(params, tokens):
        if tokens.shape[0] % accum:
            raise ValueError(
                f"global batch {tokens.shape[0]} not divisible by "
                f"grad_accum_steps {accum}")
        tokens = local_batch(tc, tokens, mesh)
        if accum == 1:
            return value_and_grad(params, tokens)
        if tokens.shape[0] % accum:
            raise ValueError(
                f"local batch {tokens.shape[0]} not divisible by "
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

    def reduce(loss, grads):
        """The mean over the data shards of the loss and of each
        gradient (summed over the data axes it is not sharded over, one
        flat buffer per set of axes and dtype), and the norm of the whole
        gradient over every shard."""
        groups: Dict[Tuple, List[torch.Tensor]] = {}
        for g, spec in zip(grads, specs):
            over = tuple(ax for ax in axes if ax not in spec)
            groups.setdefault((over, g.dtype), []).append(g)
        for (over, _), gs in groups.items():
            flat = torch.cat([g.reshape(-1) for g in gs])
            coll.sum_over_(flat, mesh, over)
            for g, part in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(part.view_as(g))
        loss = loss.float().clone()
        coll.sum_over_(loss, mesh, axes)
        if shards > 1:
            inv = 1.0 / shards
            loss.mul_(inv)
            for g in grads:
                g.mul_(inv)
        sq = sum(g.float().square().sum() * w
                 for g, w in zip(grads, weights))
        return loss, torch.sqrt(coll.sum_over_world(sq))

    def grad_fn(params, tokens):
        loss, grads = grads_of(params, tokens)
        with torch.no_grad():
            if mesh is None:
                return loss.float(), grads, global_norm(grads)
            loss, grad_norm = reduce(loss, grads)
        return loss, grads, grad_norm

    return grad_fn


def make_train_step(tc: TrainConfig,
                    mesh: Optional[DeviceMesh] = None) -> Callable:
    """``step(state, tokens) -> (state, {"loss", "grad_norm"})`` for the
    global batch ``tokens`` (B, S) on the params' device; over a mesh
    each rank keeps its rows (:func:`local_batch`) and ``state`` holds
    its shards. The metrics are 0-d fp32 tensors on the device, the same
    on every rank: reading them is a host sync, left to the caller. The
    state is updated in place and returned (JAX donates it,
    ``train.py:398``)."""
    grad_fn = make_grad_fn(tc, mesh)

    def step(state: Dict, tokens: torch.Tensor):
        loss, grads, grad_norm = grad_fn(state["params"], tokens)
        with torch.no_grad():
            adamw_update(tree_leaves(state["params"]), grads, state["opt"],
                         tc.learning_rate, tc.weight_decay)
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step
