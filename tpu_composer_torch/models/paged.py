"""Paged (block-table) KV cache for serving (port of
``tpu_composer/models/paged.py``).

K/V live in a shared pool of fixed-size blocks (``(n_layers, num_blocks,
block_size, KV, Dh)``); each row owns an ordered table of block ids and
appends into its last block, claiming a new one from the free stack only
when it crosses a block boundary. Reads go through the gather path
(``_paged_read`` + ``decode._cached_attention``) or, with
``attn_impl="kernel"`` on single-token steps, through the paged decode
kernel (``ops/paged_attention.py``), which walks the table itself.

How the port differs from the JAX functions it mirrors, and why:

- All-or-nothing updates. JAX computes the new cache and selects it or
  the old one by ``ok``. Here ``ok`` is decided on the host FIRST and
  returned as a Python bool; a refused admit / extend / attach returns
  the cache it was given, untouched. Nothing is ever half-applied.
- In-place pool writes. K/V (and int8 scales) are written into the pool
  tensors in place: the cache returned by a prefill or decode step shares
  its pools with the one passed in. The small bookkeeping tensors
  (tables, lengths, free stack, refcounts) are replaced, never mutated.
- No ``mode="drop"`` scatter in torch. Writes for inactive rows are
  removed by selecting the active rows' coordinates first: an idle
  slot's stale table may name a live row's block, so it is masked out,
  never clamped.
- Tables stay int32 (the kernel reads them); indices become int64 only
  for torch's advanced indexing.
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
    quantize_kv,
)
from tpu_composer_torch.models.moe import MoEConfig
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.models.transformer import (
    _rmsnorm,
    _select_attn,
    _tied_logits,
)
from tpu_composer_torch.ops.paged_attention import paged_decode_attention

ATTN_IMPLS = ("gather", "kernel")


class PagedKVCache(NamedTuple):
    """Shared block pool + per-row block tables.

    - ``k_pool``/``v_pool``: (L, N, Bs, KV, Dh).
    - ``block_tables``: (B, MB) int32; slot ``j`` holds the row's
      positions ``[j*Bs, (j+1)*Bs)``. Unassigned slots keep stale ids:
      reads mask by ``length``, never by table content.
    - ``length``: (B,) int32 valid positions per row.
    - ``n_blocks``: (B,) int32 blocks owned per row.
    - ``free``: (N,) int32 stack of free ids; ``free[:free_top]`` are free.
    - ``free_top``: () int32.
    - ``refcount``: (N,) int32 owners per block (a shared-prefix block
      counts each attached row plus its registry handle).
    - ``k_scale``/``v_scale``: (L, N, Bs, KV) fp32 when the pool is int8.
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


def init_paged_cache(config: AnyConfig, batch: int, num_blocks: int,
                     block_size: int = 16,
                     blocks_per_row: Optional[int] = None,
                     quant: bool = False,
                     device: DeviceLike = "cuda") -> PagedKVCache:
    """Empty pool. ``blocks_per_row`` bounds one row's table (default: the
    whole pool). ``quant=True`` stores the pool int8 with per-(position,
    head) fp32 scales."""
    c = config
    dev = resolve_device(device)
    mb = blocks_per_row or num_blocks
    shape = (c.n_layers, num_blocks, block_size, c.kv_heads, c.head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    common = dict(
        block_tables=torch.zeros((batch, mb), **i32),
        length=torch.zeros(batch, **i32),
        n_blocks=torch.zeros(batch, **i32),
        free=torch.arange(num_blocks, **i32),
        free_top=torch.tensor(num_blocks, **i32),
        refcount=torch.zeros(num_blocks, **i32),
    )
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


def _on(cache: PagedKVCache, x, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(x, device=cache.free.device).to(dtype)


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
          ) -> Tuple[PagedKVCache, bool]:
    """Assign ``ceil(n_tokens/Bs)`` fresh blocks to each masked row and
    reset its length to 0. Returns ``(cache, ok)``; when the pool or a
    row's table cannot cover the request, ``ok`` is False and the cache is
    returned unchanged. Masked rows must be empty (released)."""
    b, mb = cache.block_tables.shape
    row_mask = _on(cache, row_mask, torch.bool)
    n_tokens = _on(cache, n_tokens)
    want_rows = torch.where(
        row_mask, _blocks_needed(n_tokens, cache.block_size), 0
    ).to(torch.int32)
    slot = torch.arange(mb, device=row_mask.device)[None, :]
    flat = (slot < want_rows[:, None]).reshape(-1)
    popped, total, refcount = _pop_blocks(cache, flat)
    ok = bool((total <= cache.free_top) & (want_rows <= mb).all())
    if not ok:
        return cache, False
    tables = torch.where(flat, popped, cache.block_tables.reshape(-1))
    return cache._replace(
        block_tables=tables.reshape(b, mb),
        length=torch.where(row_mask, 0, cache.length),
        n_blocks=torch.where(row_mask, want_rows, cache.n_blocks),
        free_top=(cache.free_top - total).to(torch.int32),
        refcount=refcount,
    ), True


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


def _extend_for_write(cache: PagedKVCache, t: int, active=None
                      ) -> Tuple[PagedKVCache, bool]:
    """Claim blocks so every active row can append ``t`` tokens at its
    current length. Returns (cache, ok); rows past their table capacity or
    an exhausted pool make ``ok`` False with the cache unchanged."""
    b, mb = cache.block_tables.shape
    owned = cache.n_blocks > 0
    active = owned if active is None else _on(cache, active, torch.bool) & owned
    need_total = torch.where(
        active, _blocks_needed(cache.length + t, cache.block_size), 0
    ).to(torch.int32)
    slot = torch.arange(mb, device=active.device)[None, :]
    flat = ((slot >= cache.n_blocks[:, None])
            & (slot < need_total[:, None])).reshape(-1)
    popped, total, refcount = _pop_blocks(cache, flat)
    ok = bool((total <= cache.free_top) & (need_total <= mb).all())
    if not ok:
        return cache, False
    tables = torch.where(flat, popped, cache.block_tables.reshape(-1))
    return cache._replace(
        block_tables=tables.reshape(b, mb),
        n_blocks=torch.maximum(cache.n_blocks, need_total),
        free_top=(cache.free_top - total).to(torch.int32),
        refcount=refcount,
    ), True


def attach_prefix(cache: PagedKVCache, slot: int, prefix_blocks,
                  prefix_len: int, extra_tokens: int
                  ) -> Tuple[PagedKVCache, bool]:
    """Admit one row that STARTS with a shared prefix: its table opens
    with ``prefix_blocks`` (refcount +1 each; the row never writes them)
    followed by fresh blocks for ``extra_tokens``. All-or-nothing like
    admit. ``prefix_len`` must equal ``len(prefix_blocks) * block_size``."""
    mb = cache.block_tables.shape[1]
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
    slots_idx = torch.arange(mb, device=prefix_blocks.device)
    want = (slots_idx >= k) & (slots_idx < need_total)
    popped, fresh, rc = _pop_blocks(cache, want)
    if need_total > mb or not bool(fresh <= cache.free_top):
        return cache, False
    rc.index_add_(0, prefix_blocks.long(), torch.ones_like(prefix_blocks))
    padded = torch.cat([prefix_blocks, prefix_blocks.new_zeros(mb - k)])
    row_table = torch.where(slots_idx < k, padded,
                            torch.where(want, popped,
                                        cache.block_tables[slot]))
    tables = cache.block_tables.clone()
    tables[slot] = row_table
    length = cache.length.clone()
    length[slot] = prefix_len
    n_blocks = cache.n_blocks.clone()
    n_blocks[slot] = need_total
    return cache._replace(
        block_tables=tables, length=length, n_blocks=n_blocks,
        free_top=(cache.free_top - fresh).to(torch.int32), refcount=rc,
    ), True


def detach_row_keep_blocks(cache: PagedKVCache, slot: int):
    """Zero a row WITHOUT dropping its block ownership: returns (cache,
    block_ids (MB,), n_blocks) so a prefix registry can hold the
    refcounts until it drops them via drop_blocks."""
    ids = cache.block_tables[slot].clone()
    n = cache.n_blocks[slot].clone()
    length = cache.length.clone()
    length[slot] = 0
    n_blocks = cache.n_blocks.clone()
    n_blocks[slot] = 0
    return cache._replace(length=length, n_blocks=n_blocks), ids, n


def drop_blocks(cache: PagedKVCache, block_ids, count) -> PagedKVCache:
    """Drop one ownership count from ``block_ids[:count]``; blocks reaching
    refcount zero return to the free stack."""
    block_ids = _on(cache, block_ids)
    idx = torch.arange(block_ids.shape[0], device=block_ids.device)
    return _free_blocks(cache, block_ids, idx < _on(cache, count))


def _write_index(tables, pos, t: int, block_size: int, active=None):
    """Pool coordinates (block ids, offsets) of every (row, token) write
    at positions ``pos..pos+t``, plus the rows they come from. Rows where
    ``active`` is False are left out entirely (one host sync to find
    them): their stale tables may name other rows' blocks."""
    b, mb = tables.shape
    abs_pos = pos.long()[:, None] + torch.arange(t, device=pos.device)[None, :]
    blk_slot = (abs_pos // block_size).clamp(0, mb - 1)
    blk = torch.gather(tables, 1, blk_slot).long()
    off = abs_pos % block_size
    if active is None:
        return blk.reshape(-1), off.reshape(-1), None
    rows = active.nonzero()[:, 0]
    return blk[rows].reshape(-1), off[rows].reshape(-1), rows


def _paged_write(pool_layer, index, new):
    """Write ``new`` (B, T, ...) into the pool layer in place at the
    coordinates ``_write_index`` gave. Blocks are row-owned, so the
    (block, offset) pairs are distinct and the order is irrelevant."""
    blk, off, rows = index
    src = new if rows is None else new[rows]
    pool_layer[blk, off] = src.reshape((-1,) + new.shape[2:]).to(
        pool_layer.dtype)


def _paged_read(pool_layer, tables):
    """Gather a row-contiguous view (B, MB*Bs, ...) for value pools
    (..., KV, Dh) and scale pools (..., KV) alike — the reference read."""
    b, mb = tables.shape
    g = pool_layer[tables.reshape(-1).long()]  # (B*MB, Bs, ...)
    return g.reshape((b, mb * g.shape[1]) + g.shape[2:])


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
                              slot_ids=list(range(b)),
                              prompt_lens=prompt_lens)


def paged_prefill_rows(params: Dict, tokens: torch.Tensor,
                       config: AnyConfig, cache: PagedKVCache, slot_ids,
                       prompt_lens=None):
    """Admit ``R`` requests (tokens (R, S)) into the named, currently
    released batch slots of a live cache and prefill them; every other
    slot is untouched. Returns (last-position logits (R, vocab), cache,
    ok); ``ok`` False = the pool could not cover the admission and the
    cache is unchanged. Ragged rows allocate by the padded length (dense
    models only: MoE routing would let pads affect real tokens). MoE
    layers route with the training forward's capacity rule, as
    ``decode.prefill`` does."""
    c = config
    if isinstance(c, MoEConfig) and prompt_lens is not None:
        raise ValueError("ragged prompts are dense-only (see decode.prefill)")
    attn = _select_attn(c, None)
    r, s_p = tokens.shape
    b = cache.block_tables.shape[0]
    if s_p > cache.capacity_per_row:
        raise ValueError(
            f"prompt length {s_p} exceeds the per-row table capacity "
            f"{cache.capacity_per_row}"
        )
    slot_ids = _on(cache, slot_ids, torch.long)
    mask = torch.zeros(b, dtype=torch.int32, device=slot_ids.device)
    mask[slot_ids] = 1
    cache, ok = admit(cache, mask, mask * s_p)
    tables_r = cache.block_tables[slot_ids]
    zero = torch.zeros(r, dtype=torch.int32, device=tokens.device)
    index = _write_index(tables_r, zero, s_p, cache.block_size) if ok else None
    positions = torch.arange(s_p, dtype=torch.int32,
                             device=tokens.device).expand(r, s_p)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, x, positions, c)
        _write_kv_layer(cache, li, index, k, v)
        o = attn(q, k, v, causal=True).to(c.dtype)
        x = x + torch.einsum("bshk,hkd->bsd", o, resolve(layer["wo"], c.dtype))
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c)
    x = _rmsnorm(x, params["ln_f"])
    if prompt_lens is not None:
        prompt_lens = _on(cache, prompt_lens)
    logits = _tied_logits(_last_real(x, prompt_lens), params["embed"], c.dtype)
    if not ok:
        return logits, cache, False
    lens_r = (torch.full((r,), s_p, dtype=torch.int32, device=tokens.device)
              if prompt_lens is None else prompt_lens)
    length = cache.length.clone()
    length[slot_ids] = lens_r
    return logits, cache._replace(length=length), True


def paged_decode_chunk(params: Dict, cache: PagedKVCache,
                       tokens: torch.Tensor, config: AnyConfig,
                       attn_impl: str = "gather", active=None):
    """T tokens (B, T) in -> (per-position logits (B, T, vocab), cache,
    ok): token i attends the cache plus chunk tokens 0..i. T=1 is a decode
    step; T>1 is chunked prefill.

    ``ok`` False: the pool could not supply a block some row needed; the
    cache comes back unchanged (no write, no length advance) and the
    logits are meaningless. ``active`` (B,) masks rows: idle slots compute
    garbage logits but write nothing and never advance.
    ``attn_impl="kernel"`` reads through the paged decode kernel on T=1
    steps; chunks read through the gather path. MoE layers route
    drop-free, each row its own group, so idle rows never displace live
    ones."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    c = config
    b, t = tokens.shape
    owned = cache.n_blocks > 0
    active = owned if active is None else _on(cache, active, torch.bool) & owned
    cache, ok = _extend_for_write(cache, t, active)
    use_kernel = attn_impl == "kernel" and t == 1
    pos = cache.length
    positions = pos[:, None] + torch.arange(
        t, dtype=torch.int32, device=tokens.device)[None, :]
    index = (_write_index(cache.block_tables, pos, t, cache.block_size,
                          active) if ok else None)
    tables = cache.block_tables
    x = embedding_lookup(params["embed"], tokens, c.dtype)
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
                           drop_free=True)
    x = _rmsnorm(x, params["ln_f"])
    logits = _tied_logits(x, params["embed"], c.dtype)
    if not ok:
        return logits, cache, False
    return logits, cache._replace(length=torch.where(active, pos + t, pos)), True


def paged_decode_step(params: Dict, cache: PagedKVCache,
                      token: torch.Tensor, config: AnyConfig,
                      attn_impl: str = "gather", active=None):
    """One token (B,) in -> (next-token logits (B, vocab), cache, ok)."""
    logits, cache, ok = paged_decode_chunk(
        params, cache, token[:, None], config, attn_impl=attn_impl,
        active=active)
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
    logits, cache, _ok = paged_prefill(params, prompt, c, cache,
                                       prompt_lens=prompt_lens)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    for _ in range(max_new_tokens - 1):
        # The pool covers the worst case, so every step is ok.
        logits, cache, _ok = paged_decode_step(params, cache, token, c,
                                               attn_impl=attn_impl)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)
