"""Paged (block-table) KV cache for serving (port of
``tpu_composer/models/paged.py``).

K/V live in a shared pool of fixed-size blocks (``(n_layers, num_blocks,
block_size, KV, Dh)``); each row owns an ordered table of block ids and
appends into its last block, claiming a new one from the free stack only
when it crosses a block boundary. Reads go through the gather path
(``_paged_read`` + ``decode._cached_attention``) or, with
``attn_impl="kernel"`` on single-token steps, through the paged decode
kernel (``ops/paged_attention.py``), which walks the table itself.

Every pool operation keeps the JAX package's contract: it computes the
new bookkeeping on the device and returns ``ok`` as a 0-dim bool tensor,
and where ``ok`` is False the bookkeeping it returns equals the cache's
own. Nothing here reads the device back: a caller that branches on
``ok`` reads it once, as a ``pool_ok`` sync or with its tokens.
How the port differs from the JAX functions it mirrors, and why:

- In-place pool writes. K/V (and int8 scales) are written into the pool
  tensors in place: the cache returned by a prefill or decode step shares
  its pools with the one passed in. The small bookkeeping tensors
  (tables, lengths, free stack, refcounts) are replaced, never mutated.
- A sink block in place of ``mode="drop"``, which torch's scatter lacks.
  Every pool has one block past ``num_blocks`` (``cache.sink``) that no
  free stack holds and no read sees: the writes of idle rows and of a
  refused operation go there. An idle slot's stale table may name a live
  row's block, so it is masked, never clamped.
- Tables stay int32 (the kernel reads them); indices become int64 only
  for torch's advanced indexing.

An MLA config (``models/mla.py``) keeps one LATENT pool: ``k_pool``
holds each position's entry ``[RMSNorm(c_kv) | RoPE(k_pe)]``,
``(n_layers, num_blocks + 1, block_size, kv_lora_rank + rope width)``
in the model dtype, and ``v_pool`` is None (values are the entries'
first ``kv_lora_rank`` dims). The tables, the sink and the ``ok``
contract are the same. A prefill writes the entries and attends in the
expanded form through ``flash_attention`` (K1 at 192/128 on the card);
a decode step reads them in the absorbed form through
``mla_decode_attention`` (``ops/mla_decode.py``): the latent decode
kernel K3 on the card, its plain twin on the CPU, whatever
``attn_impl`` says. Such a pool is never int8, and decodes one token a
step (no chunks).

Routing records (``routes``): a serving engine may pass a
``(slots, n_layers, positions + 1, top_k)`` uint8 buffer, and the MoE
layers of a prefill or a decode step then write, on the device, the
experts each row's token took at each position they computed (the ids
dispatch read); idle rows write into the spare last position.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.decode import (
    AnyConfig,
    _cached_attention,
    _ffn_delta,
    _last_real,
    _project_qkv,
    pads_route,
    quantize_kv,
)
from tpu_composer_torch.models import mla
from tpu_composer_torch.models.mla import MLAConfig
from tpu_composer_torch.models.moe import RouteRecord
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.models.transformer import (
    _rmsnorm,
    _select_attn,
    _tied_logits,
)
from tpu_composer_torch.ops.mla_decode import mla_decode_attention
from tpu_composer_torch.ops.paged_attention import paged_decode_attention
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.tracing import host_sync

ATTN_IMPLS = ("gather", "kernel")


class PagedKVCache(NamedTuple):
    """Shared block pool + per-row block tables.

    - ``k_pool``/``v_pool``: (L, N + 1, Bs, KV, Dh): N blocks, then the
      sink. A latent pool (MLA): ``k_pool`` (L, N + 1, Bs, entry width),
      ``v_pool`` None.
    - ``block_tables``: (B, MB) int32; slot ``j`` holds the row's
      positions ``[j*Bs, (j+1)*Bs)``. Unassigned slots keep stale ids:
      reads mask by ``length``, never by table content.
    - ``length``: (B,) int32 valid positions per row.
    - ``n_blocks``: (B,) int32 blocks owned per row.
    - ``free``: (N,) int32 stack of free ids; ``free[:free_top]`` are free.
    - ``free_top``: () int32.
    - ``refcount``: (N,) int32 owners per block (a shared-prefix block
      counts each attached row plus its registry handle).
    - ``k_scale``/``v_scale``: (L, N + 1, Bs, KV) fp32 when the pool is
      int8.
    """

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    block_tables: torch.Tensor
    length: torch.Tensor
    n_blocks: torch.Tensor
    free: torch.Tensor
    free_top: torch.Tensor
    refcount: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def capacity_per_row(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def sink(self) -> int:
        """The pool's last block, which no free stack holds and no table
        reads: where writes that must not land go."""
        return self.k_pool.shape[1] - 1


def init_paged_cache(config: AnyConfig, batch: int, num_blocks: int,
                     block_size: int = 16,
                     blocks_per_row: Optional[int] = None,
                     quant: bool = False,
                     device: DeviceLike = "cuda") -> PagedKVCache:
    """Empty pool of ``num_blocks`` blocks and the sink past them.
    ``blocks_per_row`` bounds one row's table (default: the whole pool).
    ``quant=True`` stores the pool int8 with per-(position, head) fp32
    scales."""
    c = config
    dev = resolve_device(device)
    mb = blocks_per_row or num_blocks
    shape = (c.n_layers, num_blocks + 1, block_size, c.kv_heads, c.head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    common = dict(
        block_tables=torch.zeros((batch, mb), **i32),
        length=torch.zeros(batch, **i32),
        n_blocks=torch.zeros(batch, **i32),
        free=torch.arange(num_blocks, **i32),
        free_top=torch.tensor(num_blocks, **i32),
        refcount=torch.zeros(num_blocks, **i32),
    )
    if isinstance(c, MLAConfig):
        if quant:
            raise ValueError("an MLA config's latent pool has no int8 form")
        return PagedKVCache(k_pool=torch.zeros(
            shape[:3] + (c.latent_dim,), dtype=c.dtype, device=dev),
            v_pool=None, **common)
    if not quant:
        return PagedKVCache(
            k_pool=torch.zeros(shape, dtype=c.dtype, device=dev),
            v_pool=torch.zeros(shape, dtype=c.dtype, device=dev),
            **common,
        )
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_pool=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        **common,
    )


def _blocks_needed(tokens, block_size: int):
    return -(-tokens // block_size)  # ceil


def upload(device: torch.device, *arrays):
    """Host arrays (NumPy, lists, numbers) as tensors on ``device``, one
    per array (the tensor itself for one): each a copy of host memory the
    host waits for, so each counts as one ``upload`` sync."""
    out = host_sync("upload", _as_tensors, device, arrays, count=len(arrays))
    return out[0] if len(arrays) == 1 else out


def _as_tensors(device, arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _on(cache: PagedKVCache, x, dtype=torch.int32) -> torch.Tensor:
    dev = cache.free.device
    if isinstance(x, torch.Tensor) and x.device == dev:
        return x.to(dtype)
    return upload(dev, x).to(dtype)


def _pop_blocks(cache: PagedKVCache, flat_want: torch.Tensor):
    """THE free-stack pop: for every True in ``flat_want`` take one block
    off the top of the stack. Returns (popped ids aligned with flat_want,
    total popped as a 0-dim tensor, a new refcount with the popped blocks
    at 1). Callers check ``total <= free_top`` before using any of it."""
    n = cache.free.shape[0]
    total = flat_want.sum()
    rank = torch.cumsum(flat_want.to(torch.int32), 0) - 1
    pop_idx = (cache.free_top - 1 - rank).clamp(0, n - 1)
    popped = cache.free[pop_idx.long()]
    # A mask over blocks via index_add (unwanted entries add 0), so no
    # data-dependent shape forces a host sync.
    hits = torch.zeros_like(cache.refcount).index_add_(
        0, popped.long(), flat_want.to(torch.int32))
    refcount = torch.where(hits > 0, 1, cache.refcount)
    return popped, total, refcount


def admit(cache: PagedKVCache, row_mask, n_tokens
          ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Assign ``ceil(n_tokens/Bs)`` fresh blocks to each masked row and
    reset its length to 0; ``row_mask`` and ``n_tokens`` (B,) are host
    arrays or device tensors. Returns ``(cache, ok)``: ``ok`` is False
    where the pool or a row's table cannot cover the request, and the
    bookkeeping is then the cache's own. Masked rows must be empty
    (released)."""
    row_mask = _on(cache, row_mask, torch.bool)
    n_tokens = _on(cache, n_tokens)
    mb = cache.block_tables.shape[1]
    want_rows = torch.where(
        row_mask, _blocks_needed(n_tokens, cache.block_size), 0
    ).to(torch.int32)
    slot = torch.arange(mb, device=row_mask.device)[None, :]
    flat = (slot < want_rows[:, None]).reshape(-1)
    claimed, ok = _claim_on_device(cache, flat, (want_rows <= mb).all())
    rows = row_mask & ok
    return claimed._replace(
        length=torch.where(rows, 0, cache.length),
        n_blocks=torch.where(rows, want_rows, cache.n_blocks),
    ), ok


def _free_blocks(cache: PagedKVCache, ids, drop_mask) -> PagedKVCache:
    """Decrement ``refcount`` for every id where ``drop_mask`` and push the
    blocks that reach ZERO onto the free stack, each exactly once even if
    several owners dropped it in this call."""
    n = cache.refcount.shape[0]
    drops = torch.zeros_like(cache.refcount).index_add_(
        0, ids.long(), drop_mask.to(torch.int32))
    rc = cache.refcount - drops
    freed = (drops > 0) & (rc == 0) & (cache.refcount > 0)
    push_idx = cache.free_top + torch.cumsum(freed.to(torch.int32), 0) - 1
    # Blocks not pushed scatter to a spare slot n that is cut off after.
    push_idx = torch.where(freed & (push_idx < n), push_idx, n).long()
    free = torch.cat([cache.free, cache.free.new_zeros(1)]).scatter_(
        0, push_idx, torch.arange(n, dtype=torch.int32, device=rc.device))
    return cache._replace(
        refcount=rc, free=free[:n],
        free_top=(cache.free_top + freed.sum()).to(torch.int32),
    )


def release(cache: PagedKVCache, row_mask) -> PagedKVCache:
    """Drop the masked rows' ownership of their blocks and zero the rows;
    blocks whose refcount reaches zero return to the free stack. Pool
    data is left as-is (reads mask by length)."""
    mb = cache.block_tables.shape[1]
    row_mask = _on(cache, row_mask, torch.bool)
    slot = torch.arange(mb, device=row_mask.device)[None, :]
    used = (slot < cache.n_blocks[:, None]) & row_mask[:, None]
    cache = _free_blocks(cache, cache.block_tables.reshape(-1),
                         used.reshape(-1))
    return cache._replace(
        length=torch.where(row_mask, 0, cache.length),
        n_blocks=torch.where(row_mask, 0, cache.n_blocks),
    )


def _active_rows(cache: PagedKVCache, active) -> torch.Tensor:
    """The rows that own blocks, of ``active`` (every row where None)."""
    owned = cache.n_blocks > 0
    return owned if active is None else _on(cache, active, torch.bool) & owned


def _extend_for_write(cache: PagedKVCache, t: int, active=None
                      ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Claim blocks so every active row that owns blocks can append ``t``
    tokens at its current length. Returns (cache, ok): rows past their
    table capacity or an exhausted pool make ``ok`` False, and the
    bookkeeping is then the cache's own."""
    active = _active_rows(cache, active)
    mb = cache.block_tables.shape[1]
    need_total = torch.where(
        active, _blocks_needed(cache.length + t, cache.block_size), 0
    ).to(torch.int32)
    slot = torch.arange(mb, device=active.device)[None, :]
    flat = ((slot >= cache.n_blocks[:, None])
            & (slot < need_total[:, None])).reshape(-1)
    cache, ok = _claim_on_device(cache, flat, (need_total <= mb).all())
    return cache._replace(
        n_blocks=torch.where(ok, torch.maximum(cache.n_blocks, need_total),
                             cache.n_blocks),
    ), ok


def _claim_on_device(cache: PagedKVCache, flat: torch.Tensor, fits
                     ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Pop a block into every table slot where ``flat`` (the tables,
    row-major) is True: (cache with the new tables, free stack top and
    refcounts, ok). ``ok`` is a 0-dim bool tensor, False where the pool
    runs short or ``fits`` (a bool or a 0-dim bool tensor) is False, and
    the three are then selected back to the cache's own values."""
    popped, total, refcount = _pop_blocks(cache, flat)
    ok = (total <= cache.free_top) & fits
    tables = torch.where(flat & ok, popped, cache.block_tables.reshape(-1))
    return cache._replace(
        block_tables=tables.reshape(cache.block_tables.shape),
        free_top=torch.where(ok, cache.free_top - total,
                             cache.free_top).to(torch.int32),
        refcount=torch.where(ok, refcount, cache.refcount),
    ), ok


def attach_prefix(cache: PagedKVCache, slot: int, prefix_blocks,
                  prefix_len: int, extra_tokens: int
                  ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Admit one row that STARTS with a shared prefix: its table opens
    with ``prefix_blocks`` (refcount +1 each; the row never writes them)
    followed by fresh blocks for ``extra_tokens``. Returns (cache, ok),
    all-or-nothing like admit. ``prefix_len`` must equal
    ``len(prefix_blocks) * block_size``."""
    b, mb = cache.block_tables.shape
    prefix_blocks = _on(cache, prefix_blocks)
    k = prefix_blocks.shape[0]
    if prefix_len != k * cache.block_size:
        raise ValueError(
            f"prefix_len {prefix_len} must equal len(prefix_blocks) x "
            f"block_size ({k} x {cache.block_size})"
        )
    if k > mb:
        raise ValueError(
            f"prefix spans {k} blocks but the row table holds {mb}")
    need_total = -(-(prefix_len + extra_tokens) // cache.block_size)
    dev = prefix_blocks.device
    slots_idx = torch.arange(mb, device=dev)
    row = torch.arange(b, device=dev) == slot
    want = (slots_idx >= k) & (slots_idx < need_total)
    claimed, ok = _claim_on_device(
        cache, (row[:, None] & want).reshape(-1), need_total <= mb)
    row = row & ok
    padded = torch.cat([prefix_blocks, prefix_blocks.new_zeros(mb - k)])
    return claimed._replace(
        block_tables=torch.where(row[:, None] & (slots_idx < k), padded,
                                 claimed.block_tables),
        length=torch.where(row, prefix_len, cache.length),
        n_blocks=torch.where(row, need_total, cache.n_blocks),
        refcount=claimed.refcount.index_add(
            0, prefix_blocks.long(), ok.to(torch.int32).expand(k)),
    ), ok


def detach_row_keep_blocks(cache: PagedKVCache, slot: int):
    """Zero a row WITHOUT dropping its block ownership: returns (cache,
    block_ids (MB,), n_blocks) so a prefix registry can hold the
    refcounts until it drops them via drop_blocks."""
    row = (torch.arange(cache.length.shape[0], device=cache.length.device)
           == slot)
    return cache._replace(
        length=torch.where(row, 0, cache.length),
        n_blocks=torch.where(row, 0, cache.n_blocks),
    ), cache.block_tables[slot].clone(), cache.n_blocks[slot].clone()


def drop_blocks(cache: PagedKVCache, block_ids, count) -> PagedKVCache:
    """Drop one ownership count from ``block_ids[:count]``; blocks reaching
    refcount zero return to the free stack."""
    block_ids = _on(cache, block_ids)
    idx = torch.arange(block_ids.shape[0], device=block_ids.device)
    return _free_blocks(cache, block_ids, idx < _on(cache, count))


def _write_index(cache: PagedKVCache, tables, pos, t: int, active):
    """Pool coordinates (block ids, offsets) of every (row, token) write
    at positions ``pos..pos+t`` of the rows of ``tables``. Rows where
    ``active`` is False write into the sink: their stale tables may name
    other rows' blocks."""
    mb = tables.shape[1]
    abs_pos = pos.long()[:, None] + torch.arange(t, device=pos.device)[None, :]
    blk_slot = (abs_pos // cache.block_size).clamp(0, mb - 1)
    blk = torch.gather(tables, 1, blk_slot).long()
    blk = torch.where(active[:, None], blk, cache.sink)
    return blk.reshape(-1), (abs_pos % cache.block_size).reshape(-1)


def _paged_write(pool_layer, index, new):
    """Write ``new`` (B, T, ...) into the pool layer in place at the
    coordinates ``_write_index`` gave. Blocks are row-owned, so outside
    the sink, which nothing reads, the (block, offset) pairs are distinct
    and the order is irrelevant."""
    blk, off = index
    pool_layer[blk, off] = new.reshape((-1,) + new.shape[2:]).to(
        pool_layer.dtype)


def _paged_read(pool_layer, tables):
    """Gather a row-contiguous view (B, MB*Bs, ...) for value pools
    (..., KV, Dh) and scale pools (..., KV) alike — the reference read."""
    b, mb = tables.shape
    g = pool_layer[tables.reshape(-1).long()]  # (B*MB, Bs, ...)
    return g.reshape((b, mb * g.shape[1]) + g.shape[2:])


def _route_writer(routes: Optional[torch.Tensor], rows: torch.Tensor,
                  positions: torch.Tensor, active=None
                  ) -> Optional[RouteRecord]:
    """Where the MoE layers write the experts of rows ``rows`` (R,) at
    ``positions`` (R, T): ``routes[rows, layer, positions]``; rows not
    ``active`` write into the spare last position."""
    if routes is None:
        return None
    pos = positions.long()
    if active is not None:
        pos = torch.where(active[:, None], pos, routes.shape[2] - 1)
    rows = rows.long()[:, None]

    def write(li: int, experts: torch.Tensor) -> None:
        routes[:, li][rows, pos] = experts.to(routes.dtype)

    return write


def _write_kv_layer(cache: PagedKVCache, li: int, index, k, v):
    """Write one layer's new K/V (B, T, KV, Dh) into the pools —
    quantizing on the way when the pool is int8 — unless ``index`` is
    None (a refused step writes nothing). Returns this layer's (values,
    values, scales, scales) views for the read path."""
    if not cache.quantized:
        if index is not None:
            _paged_write(cache.k_pool[li], index, k)
            _paged_write(cache.v_pool[li], index, v)
        return cache.k_pool[li], cache.v_pool[li], None, None
    if index is not None:
        for vals, scales, new in ((cache.k_pool, cache.k_scale, k),
                                  (cache.v_pool, cache.v_scale, v)):
            nq, ns = quantize_kv(new)
            _paged_write(vals[li], index, nq)
            _paged_write(scales[li], index, ns)
    return (cache.k_pool[li], cache.v_pool[li], cache.k_scale[li],
            cache.v_scale[li])


def paged_prefill(params: Dict, tokens: torch.Tensor, config: AnyConfig,
                  cache: PagedKVCache, prompt_lens=None):
    """Admit EVERY row and run the prompt: paged_prefill_rows over all
    slots. Returns (last-real-position logits (B, vocab), cache, ok)."""
    b = tokens.shape[0]
    return paged_prefill_rows(params, tokens, config, cache,
                              slot_ids=torch.arange(b, device=tokens.device),
                              prompt_lens=prompt_lens)


def paged_prefill_rows(params: Dict, tokens: torch.Tensor,
                       config: AnyConfig, cache: PagedKVCache, slot_ids,
                       prompt_lens=None, routes=None):
    """Admit ``R`` requests (tokens (R, S)) into the named, currently
    released batch slots of a live cache and prefill them; every other
    slot is untouched. ``slot_ids`` and ``prompt_lens`` (R,) are host
    sequences or device tensors. Returns (last-position logits (R,
    vocab), cache, ok); ``ok`` False = the pool could not cover the
    admission, the bookkeeping is the cache's own and the K/V went into
    the sink. Ragged rows allocate by the padded length (dense and
    dropless MoE models only: capacity routing would let pads affect real
    tokens). MoE layers route with the config's capacity rule, as
    ``decode.prefill`` does. ``routes``: the engine's routing record,
    written at the rows' positions 0..S−1."""
    c = config
    _check_prefill(c, cache, tokens.shape[1], ragged=prompt_lens is not None)
    r, s_p = tokens.shape
    dev = tokens.device
    slot_ids = _on(cache, slot_ids, torch.long)
    hit = (torch.arange(cache.block_tables.shape[0], device=dev)[:, None]
           == slot_ids[None, :])  # (B, R)
    row = hit.any(dim=1)
    cache, ok = admit(cache, row, row.to(torch.int32) * s_p)
    index = _write_index(cache, cache.block_tables.index_select(0, slot_ids),
                         torch.zeros(r, dtype=torch.int32, device=dev), s_p,
                         ok.expand(r))
    positions = torch.arange(s_p, dtype=torch.int32, device=dev).expand(r, s_p)
    record = _route_writer(routes, slot_ids, positions)
    x = _prefill_forward(params, tokens, positions, c, cache, index, record)
    if prompt_lens is not None:
        prompt_lens = _on(cache, prompt_lens)
    logits = _tied_logits(_last_real(x, prompt_lens), params["embed"], c.dtype)
    lens = (hit * (s_p if prompt_lens is None else prompt_lens)).sum(dim=1)
    return logits, cache._replace(length=torch.where(
        row & ok, lens.to(torch.int32), cache.length)), ok


def _check_prefill(c: AnyConfig, cache: PagedKVCache, s_p: int,
                   ragged: bool) -> None:
    if pads_route(c) and ragged:
        raise ValueError("ragged prompts are dense-only (or dropless MoE;"
                         " see decode.prefill)")
    if s_p > cache.capacity_per_row:
        raise ValueError(
            f"prompt length {s_p} exceeds the per-row table capacity "
            f"{cache.capacity_per_row}"
        )


def _prefill_forward(params: Dict, tokens: torch.Tensor,
                     positions: torch.Tensor, c: AnyConfig,
                     cache: PagedKVCache, index, record) -> torch.Tensor:
    """The prompts' forward (R, S): each layer's K/V written into the
    pools at ``index`` (None: nowhere), causal attention over the prompt
    alone. Returns the final-normed hidden states (R, S, D)."""
    attn = _select_attn(c, None)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    if isinstance(c, MLAConfig):
        return _mla_prefill_forward(params, x, positions, c, cache, index,
                                    record, attn)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, x, positions, c)
        _write_kv_layer(cache, li, index, k, v)
        o = attn(q, k, v, causal=True).to(c.dtype)
        x = x + torch.einsum("bshk,hkd->bsd", o, resolve(layer["wo"], c.dtype))
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c,
                           record=record)
    return _rmsnorm(x, params["ln_f"])


def _mla_prefill_forward(params: Dict, x: torch.Tensor,
                         positions: torch.Tensor, c: MLAConfig,
                         cache: PagedKVCache, index, record, attn
                         ) -> torch.Tensor:
    """:func:`_prefill_forward` of an MLA config from the embeddings x:
    each layer's latent entries written into the pool at ``index``, then
    the expanded causal attention over the prompt."""
    for li, layer in enumerate(params["layers"]):
        q_nope, q_pe, latent = mla.project(layer, x, positions, c)
        if index is not None:
            _paged_write(cache.k_pool[li], index, latent)
        o = mla.expanded_attention(layer, q_nope, q_pe, latent, c, attn)
        x = mla.out_proj(layer, x, o, c)
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c,
                           record=record)
    return _rmsnorm(x, params["ln_f"])


def _mla_decode_forward(params: Dict, x: torch.Tensor,
                        positions: torch.Tensor, c: MLAConfig,
                        cache: PagedKVCache, index, lengths: torch.Tensor,
                        record) -> torch.Tensor:
    """One decode step of an MLA config from the embeddings x (B, 1, D):
    each layer's new entry written at ``index``, then the absorbed read
    of the row's ``lengths`` entries (K3 on the card, its twin on the
    CPU). Returns the hidden states before the final norm."""
    scale = c.qk_head_dim ** -0.5
    # The spans' key count, read on the host only where the lengths are
    # there: on the card a decode step is a CUDA graph and records none.
    keys = (int(lengths.sum()) if tracing.current_tree() is not None
            and not lengths.is_cuda else None)
    for li, layer in enumerate(params["layers"]):
        q_nope, q_pe, latent = mla.project(layer, x, positions, c)
        _paged_write(cache.k_pool[li], index, latent)
        q = mla.absorb_query(layer, q_nope, q_pe, c)[:, 0]
        with mla.attend("absorb", keys):
            o_lat = mla_decode_attention(q, cache.k_pool[li],
                                         cache.block_tables, lengths, scale,
                                         c.kv_lora_rank)
        o = mla.absorbed_output(layer, o_lat, c)[:, None]
        x = mla.out_proj(layer, x, o, c)
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c,
                           drop_free=True, record=record)
    return x


def paged_decode_chunk(params: Dict, cache: PagedKVCache,
                       tokens: torch.Tensor, config: AnyConfig,
                       attn_impl: str = "gather", active=None, routes=None):
    """T tokens (B, T) in -> (per-position logits (B, T, vocab), cache,
    ok): token i attends the cache plus chunk tokens 0..i. T=1 is a decode
    step; T>1 is chunked prefill.

    ``ok`` False: the pool could not supply a block some row needed; the
    bookkeeping comes back as it was (no length advance), the K/V went
    into the sink and the logits are meaningless. ``active`` (B,) masks
    rows: idle slots compute garbage logits, write into the sink and never
    advance. ``attn_impl="kernel"`` reads through the paged decode kernel
    on T=1 steps; chunks read through the gather path. An MLA config
    reads through its own dispatcher, whatever ``attn_impl``. MoE layers route
    drop-free, each row its own group, so idle rows never displace live
    ones. ``routes``: the engine's routing record (B = its slots), written
    at the active rows' positions."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    c = config
    b, t = tokens.shape
    mla_step = isinstance(c, MLAConfig)
    if mla_step and t != 1:
        raise ValueError("an MLA config decodes one token a step: chunked"
                         " prefill and speculative chunks are not supported")
    active = _active_rows(cache, active)
    cache, ok = _extend_for_write(cache, t, active)
    active = active & ok
    use_kernel = attn_impl == "kernel" and t == 1
    pos = cache.length
    positions = pos[:, None] + torch.arange(
        t, dtype=torch.int32, device=tokens.device)[None, :]
    tables = cache.block_tables
    index = _write_index(cache, tables, pos, t, active)
    record = _route_writer(routes, torch.arange(b, device=tokens.device),
                           positions, active)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    if mla_step:
        # Idle rows read no entry: their stale tables are never walked.
        x = _mla_decode_forward(params, x, positions, c, cache, index,
                                torch.where(active, pos + 1, 0), record)
    else:
        for li, layer in enumerate(params["layers"]):
            q, k, v = _project_qkv(layer, x, positions, c)
            kp, vp, ksp, vsp = _write_kv_layer(cache, li, index, k, v)
            if use_kernel:
                o = paged_decode_attention(q[:, 0], kp, vp, tables, pos + 1,
                                           k_scale=ksp, v_scale=vsp)[:, None]
            else:
                o = _cached_attention(
                    q, _paged_read(kp, tables), _paged_read(vp, tables),
                    pos + t, c, q_positions=positions,
                    k_scale=None if ksp is None else _paged_read(ksp, tables),
                    v_scale=None if vsp is None else _paged_read(vsp, tables),
                )
            x = x + torch.einsum("bshk,hkd->bsd", o, resolve(layer["wo"], c.dtype))
            x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c,
                               drop_free=True, record=record)
    x = _rmsnorm(x, params["ln_f"])
    logits = _tied_logits(x, params["embed"], c.dtype)
    return logits, cache._replace(length=torch.where(active, pos + t, pos)), ok


def paged_decode_step(params: Dict, cache: PagedKVCache,
                      token: torch.Tensor, config: AnyConfig,
                      attn_impl: str = "gather", active=None, routes=None):
    """One token (B,) in -> (next-token logits (B, vocab), cache, ok);
    ``routes`` as in :func:`paged_decode_chunk`."""
    logits, cache, ok = paged_decode_chunk(
        params, cache, token[:, None], config, attn_impl=attn_impl,
        active=active, routes=routes)
    return logits[:, 0], cache, ok


def paged_generate(params: Dict, prompt: torch.Tensor, config: AnyConfig,
                   max_new_tokens: int, num_blocks: int,
                   block_size: int = 16, prompt_lens=None,
                   attn_impl: str = "gather",
                   kv_quant: bool = False) -> torch.Tensor:
    """Greedy generation over a fresh pool on the prompt's device — the
    parity surface against decode.generate. Returns (B, max_new_tokens)."""
    c = config
    b, s_p = prompt.shape
    per_row = -(-(s_p + max_new_tokens) // block_size)
    worst = b * per_row
    if worst > num_blocks:
        raise ValueError(
            f"pool of {num_blocks} blocks cannot cover the worst case "
            f"{worst} (= {b} rows x ceil(({s_p}+{max_new_tokens})"
            f"/{block_size}))"
        )
    cache = init_paged_cache(c, b, num_blocks, block_size,
                             blocks_per_row=per_row, quant=kv_quant,
                             device=prompt.device)
    # The pool covers the worst case, so every ok is True and none is read.
    logits, cache, _ok = paged_prefill(params, prompt, c, cache,
                                       prompt_lens=prompt_lens)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache, _ok = paged_decode_step(params, cache, token, c,
                                               attn_impl=attn_impl)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)
