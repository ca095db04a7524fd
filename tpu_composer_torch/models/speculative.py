"""Speculative decoding: draft and verify (port of
``tpu_composer/models/speculative.py``).

A small draft model proposes ``gamma`` tokens greedily; the target scores
them all in ONE chunked forward (``decode_chunk``, per-query causal
limits) and accepts the longest agreeing prefix plus one token of its
own. Greedy verification reproduces the target's greedy decode while
running the target once per (accepted + 1) tokens. Caveat: the chunked
forward sums in another order than T single steps (about 1e-4 of logit
drift), so a position whose top-2 logits are closer than that may break
the tie the other way: a property of chunked verification on floats,
not a divergence of logic. MoE targets verify exactly too, since decode
chunks route drop-free.

The loop runs on the host, since the acceptance length depends on the
data. One host-driven draft roll serves the dense and paged caches
alike. Each round reads its drafts and the target's picks to the host
once, in one copy. Both caches are rewound by shortening their lengths:
K/V past the valid prefix stays in place, masked, and is overwritten
later (the dense cache is written in place).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from tpu_composer_torch.models.decode import AnyConfig, decode_chunk, prefill
from tpu_composer_torch.models.paged import (
    init_paged_cache,
    paged_decode_chunk,
    paged_prefill,
)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _draft_roll_host(chunk_fn: Callable, cache, pending: torch.Tensor,
                     gamma: int):
    """The drafting contract, generic over the cache: consume ``pending``
    (1, P), emit ``gamma`` greedy drafts (1, gamma) without reading them
    back; the cache advances past pending + the first gamma−1 drafts (the
    last draft's K/V is never written: re-feeding the newest accepted
    token keeps it one step ahead)."""
    logits, cache = chunk_fn(cache, pending)
    toks = [_greedy(logits[:, -1:])]
    for _ in range(gamma - 1):
        logits, cache = chunk_fn(cache, toks[-1])
        toks.append(_greedy(logits[:, -1:]))
    return torch.cat(toks, dim=1), cache


def _speculative_loop(first: int, max_new_tokens: int, gamma: int,
                      prompt_len: int, draft_roll: Callable,
                      verify: Callable, t_cache, d_cache,
                      set_length: Callable) -> List[int]:
    """The one accept loop, generic over the cache type:
    ``draft_roll(cache, pending, gamma) -> (drafts, cache)``,
    ``verify(cache, chunk) -> (greedy, cache)``,
    ``set_length(cache, n) -> cache`` (the rewind). Dense and paged
    speculative generation share it, so the bookkeeping cannot fork."""
    out: List[int] = [first]
    device = d_cache.length.device
    # Invariant: both caches cover the prompt plus out[:covered]; the
    # uncovered suffix of `out` is what the draft consumes next (1 token,
    # 2 after a fully accepted round), and the target's verify chunk
    # starts at its own first uncovered token.
    covered_d = 0
    covered_t = 0
    while len(out) < max_new_tokens:
        pending_d = torch.tensor([out[covered_d:]], dtype=torch.int32,
                                 device=device)
        drafts, d_cache = draft_roll(d_cache, pending_d, gamma)
        chunk = torch.cat([torch.tensor([out[covered_t:]], dtype=torch.int32,
                                        device=drafts.device), drafts], dim=1)
        greedy, t_cache = verify(t_cache, chunk)
        # greedy[:, i] is the target's choice AFTER chunk[:, :i+1]; drafts
        # start at chunk position (len(out) - covered_t). One host read.
        both = torch.cat([drafts[0], greedy[0]]).tolist()
        d_np, g_np = both[:gamma], both[gamma:]
        off = len(out) - covered_t
        a = 0
        while a < gamma and d_np[a] == g_np[off - 1 + a]:
            a += 1
        accepted = d_np[:a] + [g_np[off - 1 + a]]
        prev_len = len(out)
        out.extend(accepted)

        # The verify chunk wrote off+gamma entries of which off+a are
        # real; the draft wrote pending+gamma-1, of which
        # pending+min(a, gamma-1) are. Lengths rewind to the valid prefix.
        covered_t = prev_len + a
        t_cache = set_length(t_cache, prompt_len + covered_t)
        covered_d = prev_len + min(a, gamma - 1)
        d_cache = set_length(d_cache, prompt_len + covered_d)
    return out[:max_new_tokens]


def _set_length(cache, n: int):
    return cache._replace(length=torch.full_like(cache.length, n))


def _check_request(prompt: torch.Tensor, gamma: int, max_new_tokens: int,
                   cap: int) -> int:
    """The batch, gamma and capacity checks both entry points share;
    returns the highest length a cache reaches."""
    if prompt.shape[0] != 1:
        raise ValueError(
            f"speculative decoding runs per-sequence (batch 1), got batch"
            f" {prompt.shape[0]}"
        )
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    # Tight bound: the last round starts with len(out) = max_new_tokens - 1
    # and its verify chunk writes 1 + gamma entries from prompt +
    # len(out) - 1, so the highest slot written is prompt + max_new_tokens
    # + gamma - 2. Inside it the dense cache's write clamp never fires.
    need = prompt.shape[1] + max_new_tokens + gamma - 1
    if need > cap:
        raise ValueError(
            f"prompt + max_new_tokens + gamma overshoot ({need}) exceeds the"
            f" cache capacity ({cap})"
        )
    return need


def speculative_generate(params: Dict, draft_params: Dict,
                         prompt: torch.Tensor, config: AnyConfig,
                         draft_config: Optional[AnyConfig] = None,
                         max_new_tokens: int = 32, gamma: int = 4,
                         max_seq: Optional[int] = None,
                         kv_quant: bool = False) -> torch.Tensor:
    """Greedy speculative generation over dense caches on the prompt's
    device. prompt (1, S) -> (1, max_new_tokens) int32: the tokens
    target-only greedy decoding would produce.

    Batch 1 per call (acceptance lengths diverge per sequence).
    ``kv_quant`` applies to both caches. The draft may be any config and
    params with the same vocabulary: fewer layers or heads, or the same
    model quantized (``models/quant.py``). Both caches must hold the whole
    run: the draft's max_seq bounds it when ``max_seq`` is not given."""
    dc = draft_config or config
    _check_request(prompt, gamma, max_new_tokens,
                   max_seq or min(config.max_seq, dc.max_seq))
    t_logits, t_cache = prefill(params, prompt, config, max_seq=max_seq,
                                quant=kv_quant)
    _, d_cache = prefill(draft_params, prompt, dc, max_seq=max_seq,
                         quant=kv_quant)

    def draft_roll(cache, pending, g):
        return _draft_roll_host(
            lambda c, toks: decode_chunk(draft_params, c, toks, dc),
            cache, pending, g)

    def verify(cache, chunk):
        logits, cache = decode_chunk(params, cache, chunk, config)
        return _greedy(logits), cache

    out = _speculative_loop(
        int(_greedy(t_logits)[0]), max_new_tokens, gamma, prompt.shape[1],
        draft_roll=draft_roll, verify=verify, t_cache=t_cache,
        d_cache=d_cache, set_length=_set_length)
    return torch.tensor([out], dtype=torch.int32, device=prompt.device)


def paged_speculative_generate(params: Dict, draft_params: Dict,
                               prompt: torch.Tensor, config: AnyConfig,
                               num_blocks: int, block_size: int = 16,
                               draft_config: Optional[AnyConfig] = None,
                               max_new_tokens: int = 32, gamma: int = 4,
                               kv_quant: bool = False) -> torch.Tensor:
    """``speculative_generate`` over paged block-pool caches, one per
    model, on the prompt's device: the same loop and the same exact-greedy
    contract. ``num_blocks``/``block_size`` size EACH pool; the verify
    overshoot (gamma) counts toward capacity as in the dense bound.
    Chunks and draft steps read through the gather path."""
    dc = draft_config or config
    # The trained-context bound of the dense path: past it the reference
    # run (target-only greedy) is undefined.
    need = _check_request(prompt, gamma, max_new_tokens,
                          min(config.max_seq, dc.max_seq))
    per_row = -(-need // block_size)
    if per_row > num_blocks:
        raise ValueError(
            f"prompt + max_new_tokens + gamma overshoot ({need}) needs "
            f"{per_row} blocks; the pool has {num_blocks}"
        )

    def make(cfg, p):
        cache = init_paged_cache(cfg, 1, num_blocks, block_size,
                                 blocks_per_row=per_row, quant=kv_quant,
                                 device=prompt.device)
        logits, cache, ok = paged_prefill(p, prompt, cfg, cache)
        if not ok:
            raise RuntimeError("pool could not cover the prompt")
        return logits, cache

    def chunked(p, cfg):
        def fn(cache, chunk):
            logits, cache, ok = paged_decode_chunk(p, cache, chunk, cfg)
            if not ok:
                raise RuntimeError(
                    "pool exhausted mid-speculation despite the capacity "
                    "precheck")
            return logits, cache
        return fn

    t_chunk, d_chunk = chunked(params, config), chunked(draft_params, dc)
    t_logits, t_cache = make(config, params)
    _, d_cache = make(dc, draft_params)

    def verify(cache, chunk):
        logits, cache = t_chunk(cache, chunk)
        return _greedy(logits), cache

    out = _speculative_loop(
        int(_greedy(t_logits)[0]), max_new_tokens, gamma, prompt.shape[1],
        draft_roll=lambda cache, pending, g: _draft_roll_host(
            d_chunk, cache, pending, g),
        verify=verify, t_cache=t_cache, d_cache=d_cache,
        set_length=_set_length)
    return torch.tensor([out], dtype=torch.int32, device=prompt.device)
