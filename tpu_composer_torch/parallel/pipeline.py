"""Pipeline parallelism: the GPipe microbatch schedule over the 'pp' mesh
dim (port of ``tpu_composer/parallel/pipeline.py``).

The transformer's blocks are stacked (:func:`stack_layers`: one tensor
per weight with a leading layer dim) and that dim is sharded over 'pp',
so each rank holds n_layers/pp whole layers: its stage. Other dims keep
their layout (tp-sharded heads and ffn width run their tp regions inside
the stage, ``models/transformer.py``).

Schedule: plain GPipe. M microbatches flow through P stages over M+P-1
ticks; stage s applies its layers to microbatch t − s at tick t and
hands the result to stage s+1 (:func:`collectives.ppermute`). Each rank
is its own process, so unlike the JAX package, which computes every
stage on every tick and discards the bubble's garbage, a rank here
computes only on its M live ticks: P − 1 ticks a step fewer, so
(P − 1) × layers-per-stage fewer launches of each flash kernel a step.
Stage s sends at tick t exactly when 0 ≤ t − s < M, and stage s+1
receives then, so every send meets its receive. A rank that neither
sends nor receives at a tick skips the handoff; under NCCL the 'pp'
group first runs one collective of every stage
(:func:`collectives.open_group`), which torch requires before such
partial batched sends.

The backward runs the reverse schedule because autograd runs ready
nodes in reverse creation order and every rank creates its handoffs in
tick order, and because every handoff reaches the loss: a handoff's
received tensor is the next tick's input; what a rank receives while
idle (its first microbatch) is requested with the microbatches' own
input as a stand-in (a zero cotangent flows back to it), so the node
lies on a path to the params; and what a handoff returns to a rank that
only sends is tied to the result (:func:`collectives.tie`), so the
reverse hop its peer waits in runs.

The last stage's outputs reach every stage through a sum over 'pp' of
the outputs and zeros (the JAX package's masked ``psum``); its backward
passes the cotangent through, so the last stage gets it once. The
embedding lookup runs on every rank, replicated over 'pp', but only
stage 0 consumes it: its cotangent is summed over 'pp'
(:func:`collectives.enter_parallel`), so the embedding's gradient is
the tied head's part (every rank) plus the lookup's part (stage 0's),
the same on every stage.

No reference analog, as in the JAX package: pipeline parallelism is
first-class here per the build spec.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.models.transformer import (
    AttnFn,
    ModelConfig,
    _rmsnorm,
    _select_attn,
    _tied_logits,
    block_forward,
    full_embedding,
)
from tpu_composer_torch.parallel import collectives as coll
from tpu_composer_torch.parallel.mesh import axis_index, axis_size

# stage_fn(stage_params, x) -> x: applies this rank's layers; the stage
# params carry a leading layers-per-stage dim.
StageFn = Callable[[Dict, torch.Tensor], torch.Tensor]


def stack_layers(layers: List[Dict]) -> Dict:
    """[{w: (..)}, ...] -> {w: (L, ..)}: the stage dim the mesh shards."""
    return {name: torch.stack([layer[name] for layer in layers])
            for name in layers[0]}


def stacked_layer_specs(layer_spec: Dict,
                        mesh: Optional[DeviceMesh] = None) -> Dict:
    """One layer's spec tree (tuples of mesh-dim names) with the stage
    dim prepended. With ``mesh``, the dims the mesh lacks are dropped
    (replicated), so tp-aware specs serve a pp-only mesh too."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())

    def adapt(spec):
        return ("pp", *(d if mesh is None or d is None or d in names
                             else None for d in spec))

    return {name: adapt(spec) for name, spec in layer_spec.items()}


def transformer_stage_fn(config: ModelConfig,
                         attn_fn: Optional[AttnFn] = None,
                         seq_axis: Optional[str] = None,
                         mesh: Optional[DeviceMesh] = None) -> StageFn:
    """Stage = the dense transformer block over the stacked layers, in
    order. ``mesh`` carries the tp regions of tp-sharded layers. With
    ``seq_axis``, the sequence (dim 1 of x) is this rank's shard along
    that mesh dim: RoPE positions are offset to the shard's global range
    and ``attn_fn`` must be a raw collective attention (ring or Ulysses)
    over the same dim."""
    attn = _select_attn(config, attn_fn)

    def stage(stacked: Dict, x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[0], x.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        if seq_axis is not None:
            positions = positions + axis_index(mesh, seq_axis) * s
        names = list(stacked)
        for weights in zip(*(stacked[n].unbind(0) for n in names)):
            x = block_forward(dict(zip(names, weights)), x, positions,
                              config, attn, mesh)
        return x

    return stage


def _pipeline_local(stage_fn: StageFn, mesh: DeviceMesh, stacked: Dict,
                    xm: torch.Tensor) -> torch.Tensor:
    """This rank's GPipe loop. ``xm``: (M, mb, ...) microbatches, the same
    on every stage; returns the same shape with every microbatch through
    every stage (the last stage's outputs, on every stage)."""
    n_stages = axis_size(mesh, "pp")
    idx = axis_index(mesh, "pp")
    n_micro = xm.shape[0]
    # The first ticks' handoffs name stages 0 and 1 alone.
    coll.open_group(mesh, "pp")
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    loose = []  # handoff outputs that no stage reads
    buf = None
    for t in range(n_micro + n_stages - 1):
        y = None
        if 0 <= t - idx < n_micro:
            y = stage_fn(stacked, xm[t] if idx == 0 else buf)
            if idx == n_stages - 1:
                outs[t - idx] = y
        senders = [s for s in range(n_stages - 1) if 0 <= t - s < n_micro]
        sends, receives = idx in senders, idx - 1 in senders
        if not (sends or receives):
            continue
        got = coll.ppermute(y if sends else xm[0], mesh, "pp",
                            [(s, s + 1) for s in senders])
        if receives:
            buf = got
        else:
            loose.append(got)
    if idx == n_stages - 1:
        mine = torch.stack(outs)
    else:
        mine = torch.zeros_like(xm)
    out = coll.all_reduce(mine, mesh, "pp")
    return coll.tie(out, *loose) if loose else out


def pipeline_apply(stage_fn: StageFn, stacked: Dict, x: torch.Tensor,
                   mesh: Optional[DeviceMesh], n_microbatches: int,
                   seq_axis: Optional[str] = None) -> torch.Tensor:
    """Run this rank's rows ``x`` (B, S, ...) through the pipelined stack.
    ``stacked`` holds this rank's stage (its layer dim sharded over
    'pp'). With ``seq_axis``, the sequence (dim 1) is sharded
    over it around the stack and gathered back after, and ``stage_fn``
    runs the collectives over it (:func:`transformer_stage_fn`); the
    stage's params then get their gradient summed over it, as JAX's
    ``shard_map`` transposes an input replicated over a manual axis."""
    n_stages = axis_size(mesh, "pp")
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by {n_microbatches} microbatches")
    if seq_axis is not None:
        x = coll.shard(x, mesh, seq_axis, axis=1)
        # Each rank of seq_axis applies the stage to its part of the
        # sequence: the stage's gradients are summed over it.
        stacked = {name: coll.enter_parallel(w, mesh, seq_axis)
                   for name, w in stacked.items()}
    if n_stages > 1:
        # Stage 0 alone consumes the input, replicated over the stages.
        x = coll.enter_parallel(x, mesh, "pp")
        # Interleave, so that every microbatch holds an equal share of
        # the rows.
        mb = batch // n_microbatches
        xm = x.reshape(mb, n_microbatches, *x.shape[1:]).transpose(0, 1)
        ym = _pipeline_local(stage_fn, mesh, stacked, xm)
        y = ym.transpose(0, 1).reshape(x.shape)
    else:
        # pp = 1: no pipeline, the whole stack applies directly.
        y = stage_fn(stacked, x)
    if seq_axis is not None:
        y = coll.all_gather(y, mesh, seq_axis, axis=1)
    return y


def pipelined_forward(params: Dict, tokens: torch.Tensor,
                      config: ModelConfig, mesh: Optional[DeviceMesh],
                      n_microbatches: int,
                      attn_fn: Optional[AttnFn] = None,
                      seq_axis: Optional[str] = None) -> torch.Tensor:
    """Dense-transformer logits (B, S, vocab), fp32, for this rank's rows
    ``tokens``, the block stack pipelined over 'pp'.

    The embedding (a plain row gather), the final norm and the tied head
    run replicated over pp; ``params["layers"]`` is this rank's stage of
    the stacked tree (:func:`stack_layers`). A vocab-sharded embedding
    is gathered over tp for the lookup and the head, as ``forward`` does.
    ``seq_axis``/``attn_fn``: sequence parallelism inside the stages
    (``attn_fn`` is then a raw ring or Ulysses attention over it)."""
    c = config
    embed = full_embedding(params["embed"], c, mesh)
    x = embed[tokens.long()]
    x = pipeline_apply(
        transformer_stage_fn(c, attn_fn, seq_axis, mesh), params["layers"],
        x, mesh, n_microbatches, seq_axis)
    x = _rmsnorm(x, params["ln_f"])
    return _tied_logits(x, embed, c.dtype)


def pipelined_loss_fn(params: Dict, tokens: torch.Tensor,
                      config: ModelConfig, mesh: Optional[DeviceMesh],
                      n_microbatches: int,
                      attn_fn: Optional[AttnFn] = None,
                      seq_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross-entropy of :func:`pipelined_forward`, the mean over
    B·(S−1) positions."""
    logits = pipelined_forward(params, tokens, config, mesh, n_microbatches,
                               attn_fn, seq_axis)[:, :-1]
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()
