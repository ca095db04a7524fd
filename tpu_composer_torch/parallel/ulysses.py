"""Ulysses sequence parallelism: two all-to-alls over a mesh dim (port of
``tpu_composer/parallel/ulysses.py``).

One ``all_to_all`` re-shards Q/K/V from sequence-sharded (B, S/n, H, D)
to head-sharded (B, S, H/n, D); each rank runs full-sequence attention
over its heads with any local attention (the reference, or
``flash_attention``: K1 with lse, B3 and B4 on the gathered sequence);
a second ``all_to_all`` restores sequence sharding.
"""

from __future__ import annotations

from typing import Callable, Optional

from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.ops.attention import mha_reference, repeat_kv
from tpu_composer_torch.parallel.collectives import all_to_all
from tpu_composer_torch.parallel.mesh import axis_size


def ulysses_attention(q, k, v, mesh: Optional[DeviceMesh], dim: str = "sp",
                      causal: bool = False,
                      attn_fn: Optional[Callable] = None):
    """All-to-all sequence-parallel attention. Local shapes (B, S/n, H,
    D); the global sequence is the shards in rank order along ``dim``.
    The head count must be divisible by n. Grouped K/V heads stay grouped
    through the all-to-all when n divides them; otherwise they are
    repeated up to H first. n = 1 calls the local attention."""
    attn = attn_fn or mha_reference
    n = axis_size(mesh, dim)
    if n == 1:
        return attn(q, k, v, causal=causal)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"n_heads {h} not divisible by sp={n}")
    if k.shape[2] % n:
        k, v = repeat_kv(q, k, v)

    # (B, S/n, H, D) -> (B, S, H/n, D): scatter heads, gather sequence.
    def fwd(x):
        return all_to_all(x, mesh, dim, split_axis=2, concat_axis=1)

    og = attn(fwd(q), fwd(k), fwd(v), causal=causal)
    # (B, S, H/n, D) -> (B, S/n, H, D): gather heads, scatter sequence.
    return all_to_all(og, mesh, dim, split_axis=1, concat_axis=2)
