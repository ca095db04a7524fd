"""Continuous-batching serving engine over the paged KV cache (port of
``tpu_composer/models/serving.py``), for the dense and MoE models.

One decode step over a fixed number of batch slots runs forever;
requests stream in and out of slots between steps. A finished row
releases its blocks to the shared pool and its slot admits the next
waiting request, through a single-row prefill or through chunked
prefill (``prefill_chunk``).

Correctness contract (tests/test_torch_serving.py): every request's
output is EXACTLY what a solo ``decode.generate`` call on its prompt
produces. Sampling is per request (temperature / top-k / top-p / seed):
each request draws from its own CPU ``torch.Generator`` seeded with
``Request.seed``, one uniform number per generated token, token t from
draw t, exactly as the solo ``generate(..., seed=seed)`` run does.

Capacity-routed MoE models need chunked admission (``prefill_chunk``):
a bucketed prefill runs the training forward over the padded row, whose
shared capacity group lets pads push real tokens past an expert's
capacity, while a chunk routes drop-free. Equality with the solo run
then holds whenever the solo prefill itself drops nothing. A dropless
MoE config (``capacity_factor=None``) routes each token on its own, so
it admits through the bucketed prefill as a dense model does.

The port runs eagerly; JAX's ``jit`` has no counterpart here. Prompt
lengths are still padded to power-of-two buckets, because the padded
length is what the block reservation is computed from. The exceptions
are on the card. The paged cache reads nothing back (its ``ok`` stays on
the device, refused writes go to its sink), so an engine's decode step
reads nothing until its tokens and is captured once as a CUDA graph at
the fixed ``(slots,)`` shape and replayed every step
(:class:`_DecodeGraph`). A bucketed admission reads nothing back until
its first token either (``paged_prefill_rows`` on one upload of the
padded prompt, its slot and its length, one read of the first token with
the pool's ok), and a dense engine replays it from one CUDA graph per
padded length (:class:`_PrefillGraph`); an MoE engine's admission, paced
by its expert products, runs eagerly. CPU engines run everything
eagerly. Chunked admission and prefixes read the pool's ok where they
branch on it.

An MLA engine (``models/mla.py``) keeps one latent pool, admits by
bucketed prefill (eagerly, as MoE does; the expanded form through K1)
and decodes through the latent kernel K3 inside its decode graph; it
takes no int8 pool, no chunked admission and so no prefixes.

An MoE engine may keep a routing record (``record_routes=True``): on the
device, the top-k expert ids of every layer at every position it
computed for a request, prompt and generated alike, read from the
tensor dispatch reads (``models/paged.py``). A finished request carries
its part as ``Request.routes``, a device copy.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_composer_torch.models.decode import (
    AnyConfig,
    pads_route,
    sample_categorical,
)
from tpu_composer_torch.models.mla import MLAConfig
from tpu_composer_torch.models.moe import MoEConfig
from tpu_composer_torch.models.paged import (
    admit,
    attach_prefix,
    detach_row_keep_blocks,
    drop_blocks,
    init_paged_cache,
    paged_decode_chunk,
    paged_decode_step,
    paged_prefill_rows,
    release,
    upload,
)
from tpu_composer_torch.models.quant import QTensor
from tpu_composer_torch.ops.attention import flash_fwd_cuda
from tpu_composer_torch.ops.mla_decode import mla_decode_cuda
from tpu_composer_torch.ops.moe_grouped import (
    combine_cuda,
    down_cuda,
    gate_up_cuda,
    group_cuda,
)
from tpu_composer_torch.ops.paged_attention import paged_decode_cuda
from tpu_composer_torch.ops.swiglu import swiglu_cuda
from tpu_composer_torch.runtime import tracing
from tpu_composer_torch.runtime.tracing import host_sync


@dataclass
class Request:
    """One generation request. ``tokens`` fills as the engine runs;
    ``done`` flips when max_new_tokens are out or eos_id was emitted.
    temperature 0 (the default) is greedy and ignores the rest."""

    prompt: List[int]
    max_new_tokens: int
    req_id: int = -1
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    temperature: float = 0.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    seed: int = 0
    prefix: Optional["PrefixHandle"] = None
    #: (n_layers, positions, top_k) uint8 on the device, once done with
    #: the engine's routing record on: position p's experts at each MoE
    #: layer, for the prompt and every generated token but the last.
    routes: Optional[torch.Tensor] = None


@dataclass
class PrefixHandle:
    """A shared prompt prefix cached ONCE in the pool (see
    ContinuousBatchingEngine.register_prefix). ``refs`` counts host-side
    references (the registry hold + every unfinished submitted request);
    the blocks free only when the last one lets go."""

    tokens: List[int]
    block_ids: torch.Tensor
    n_blocks: int
    closed: bool = False
    refs: int = 1  # the registry's own hold

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _filter_rows(logits, temp, top_k, top_p):
    """Per-row temperature, top-k and top-p with every control a PER-ROW
    tensor; row for row the same result as dividing by the temperature
    and applying decode.filter_top_k then filter_top_p (top_k <= 0 and
    top_p = 1.0 keep everything). The k-th-largest threshold with >=
    keeps ties exactly like filter_top_k."""
    v = logits.shape[-1]
    safe_t = torch.where(temp > 0, temp, 1.0)
    scaled = logits / safe_t[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k <= 0, v, top_k).clamp(1, v)
    kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None].long())
    filt = torch.where(scaled >= kth, scaled, -torch.inf)
    # The sorted view of `filt` without a second sort: kept entries are
    # exactly the first `kept` of sorted_desc (a count, so ties stay).
    kept = (scaled >= kth).sum(dim=-1, keepdim=True)
    sorted_f = torch.where(
        torch.arange(v, device=logits.device)[None, :] < kept,
        sorted_desc, -torch.inf)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    cut = torch.where(keep_sorted, sorted_f, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(filt >= cut, filt, -torch.inf)


def _pick_rows(logits, temp, top_k, top_p, u):
    """Per-row sampling: rows with temp > 0 draw from the filtered
    distribution with their uniform ``u``; the rest take the argmax."""
    sampled = sample_categorical(_filter_rows(logits, temp, top_k, top_p), u)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0, sampled, greedy).to(torch.int32)


def _params_device(params: Dict) -> torch.device:
    embed = params["embed"]
    return (embed.q if isinstance(embed, QTensor) else embed).device


class ContinuousBatchingEngine:
    """Fixed ``slots``-row engine over one shared block pool, on the
    params' device.

    Admission reserves each request's WORST-CASE blocks
    (ceil((padded_prompt + max_new)/block_size)) host-side before it is
    scheduled, so the pool can never run out mid-flight; the paged
    layer's all-or-nothing ok-flags stay as defense in depth."""

    def __init__(self, params: Dict, config: AnyConfig, slots: int,
                 num_blocks: int, block_size: int = 16,
                 attn_impl: str = "gather", eos_id: Optional[int] = None,
                 blocks_per_row: Optional[int] = None,
                 kv_quant: bool = False,
                 prefill_chunk: Optional[int] = None,
                 record_routes: bool = False):
        """``blocks_per_row`` bounds one request's table and so how many
        table slots every attention read walks. ``attn_impl="kernel"``
        reads decode steps through the paged decode kernel. ``kv_quant``
        stores the pool int8. ``prefill_chunk`` switches admission to
        CHUNKED prefill: the prompt streams through fixed-size chunks, one
        per engine step, while every other slot keeps decoding;
        capacity-routed MoE models require it. ``record_routes`` keeps
        an MoE engine's routing record (module docstring)."""
        if pads_route(config) and prefill_chunk is None:
            raise ValueError(
                "capacity-routed MoE serving requires chunked admission: "
                "pass prefill_chunk (bucketed prefill's padded training-"
                "forward routing would let pads affect real tokens)"
            )
        moe = isinstance(config, MoEConfig)
        self._latent = isinstance(config, MLAConfig)
        if self._latent and (kv_quant or prefill_chunk is not None):
            raise ValueError("an MLA engine admits by bucketed prefill into"
                             " a bf16 latent pool: no kv_quant, no"
                             " prefill_chunk (and so no prefixes)")
        if record_routes and not (moe and config.n_experts <= 256):
            raise ValueError("record_routes needs an MoE config of at most"
                             " 256 experts (uint8 ids)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.params = params
        self.config = config
        self.slots = slots
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.attn_impl = attn_impl
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.device = _params_device(params)
        self.cache = init_paged_cache(
            config, slots, num_blocks, block_size,
            blocks_per_row=blocks_per_row, quant=kv_quant,
            device=self.device,
        )
        # An engine on the card replays its decode step from a CUDA graph,
        # captured at its first decode step, and a dense engine its
        # bucketed admissions from one graph per padded length, captured
        # at that length's first admission; the admission graphs share one
        # memory pool, as they replay one at a time.
        self._graphed = self.device.type == "cuda"
        self._graph: Optional[_DecodeGraph] = None
        self._admit_graphs: Optional[Dict[int, _PrefillGraph]] = (
            None if moe else {})
        self._admit_pool = None
        # The routing record: (slots, layers, positions + 1 spare, top_k).
        self._routes = (torch.zeros(
            (slots, config.n_layers, self.cache.capacity_per_row + 1,
             config.top_k), dtype=torch.uint8, device=self.device)
            if record_routes else None)
        self._moe = moe
        self._n_moe = (sum(map(config.is_moe_layer, range(config.n_layers)))
                       if moe else 0)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._next_token = np.zeros(slots, np.int32)
        self._reserved = np.zeros(slots, np.int64)  # blocks held per slot
        self._temp = np.zeros(slots, np.float32)
        self._topk = np.zeros(slots, np.int32)
        self._topp = np.ones(slots, np.float32)
        # A sampled request's own generator: one draw per generated token.
        self._slot_gen: List[Optional[torch.Generator]] = [None] * slots
        self._waiting: Deque[Request] = deque()
        self._next_id = 0
        self._prefix_reserved = 0  # blocks held by open prefix handles
        # In-flight chunked admissions, round-robin (one chunk of admission
        # work per engine step): {slot, req, consumed, padded, tail}.
        self._admitting: Deque[Dict[str, Any]] = deque()

    def _row_mask(self, slot: int) -> np.ndarray:
        m = np.zeros(self.slots, np.int32)
        m[slot] = 1
        return m

    def _check_ids(self, tokens: List[int]) -> None:
        """Refuse token ids outside the vocab on the host: on the card an
        out-of-range embedding row is a device-side assert, which would
        take every request in flight down with it."""
        vocab = self.config.vocab_size
        bad = [t for t in tokens if not 0 <= int(t) < vocab]
        if bad:
            raise ValueError(
                f"token ids {bad[:8]} outside the vocab [0, {vocab})")

    # -- submission ----------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               prefix: Optional[PrefixHandle] = None) -> Request:
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if prefix is not None:
            if self.prefill_chunk is None:
                raise ValueError(
                    "prefix-attached requests need chunked admission "
                    "(pass prefill_chunk): the remainder streams in "
                    "after the shared blocks"
                )
            if prefix.closed:
                raise ValueError("prefix handle is closed")
            p_n = prefix.n_tokens
            if prompt[:p_n] != prefix.tokens or len(prompt) <= p_n:
                raise ValueError(
                    "prompt must START with the prefix tokens and "
                    "extend past them (the first-token logits come from "
                    "the request's own suffix)"
                )
        # Validate with the SAME padded length the scheduler reserves
        # with, or an accepted request could never be placed.
        pad = self._pad_len_req(prompt, prefix)
        worst = self._worst_fresh_blocks(pad, max_new_tokens, prefix)
        cap = self.cache.capacity_per_row
        if worst > self.num_blocks or pad + max_new_tokens > cap:
            raise ValueError(
                f"request needs {worst} blocks / {pad + max_new_tokens} "
                f"positions worst-case; the pool has {self.num_blocks} "
                f"blocks and {cap} positions per row"
            )
        # max_seq bounds the solo reference run (positions advance from
        # the REAL prompt length, not the padded one).
        if len(prompt) + max_new_tokens > self.config.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds config.max_seq "
                f"({self.config.max_seq}) — the solo reference run has "
                "no defined output past it"
            )
        self._check_ids(prompt)
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      req_id=self._next_id, temperature=temperature,
                      top_k=top_k, top_p=top_p, seed=seed, prefix=prefix)
        self._next_id += 1
        if prefix is not None:
            prefix.refs += 1  # held until this request finishes/cancels
        self._waiting.append(req)
        return req

    def _pad_len(self, prompt_len: int) -> int:
        """The padded prompt length admission allocates for: the next
        multiple of prefill_chunk in chunked mode, the power-of-two
        bucket otherwise."""
        if self.prefill_chunk is not None:
            return -(-prompt_len // self.prefill_chunk) * self.prefill_chunk
        return _bucket(prompt_len)

    def _pad_len_req(self, prompt: List[int],
                     prefix: Optional[PrefixHandle]) -> int:
        if prefix is None:
            return self._pad_len(len(prompt))
        return prefix.n_tokens + self._pad_len(len(prompt) - prefix.n_tokens)

    def _worst_fresh_blocks(self, pad_total: int, max_new: int,
                            prefix: Optional[PrefixHandle]) -> int:
        """Blocks the request itself will claim (a shared prefix's blocks
        are paid for by the registry)."""
        worst = _worst_blocks(pad_total, max_new, self.block_size)
        return worst - (prefix.n_blocks if prefix is not None else 0)

    # -- shared prompt prefixes ---------------------------------------
    def register_prefix(self, tokens: List[int]) -> PrefixHandle:
        """Prefill ``tokens`` once into pool blocks and return a handle
        requests can attach to (``submit(..., prefix=h)``). Length must be
        a nonzero multiple of block_size, and for capacity-routed MoE
        models of prefill_chunk too (chunk pads would be routed): such a
        prefix is staged through ``admit`` and one chunk per
        ``prefill_chunk`` tokens, any other through a bucketed prefill.
        Staging borrows a free slot; the blocks then detach into the
        handle. An engine keeping a routing record has no prefixes: a
        request's record holds the positions it computed itself."""
        if self.prefill_chunk is None:
            raise ValueError(
                "register_prefix requires chunked admission (pass"
                " prefill_chunk): bucketed engines cannot attach requests"
                " to a prefix, so its blocks would leak"
            )
        if self._routes is not None:
            raise ValueError("register_prefix: this engine keeps a routing"
                             " record, which a shared prefix would leave"
                             " without its positions")
        self._check_ids(tokens)
        p_n = len(tokens)
        if p_n == 0 or p_n % self.block_size:
            raise ValueError(
                f"prefix length must be a nonzero multiple of "
                f"block_size ({self.block_size}), got {p_n}"
            )
        k = p_n // self.block_size
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError("no free slot to stage the prefix prefill")
        capacity_moe = pads_route(self.config)
        if capacity_moe and p_n % self.prefill_chunk:
            raise ValueError(
                f"MoE prefixes must be a multiple of prefill_chunk "
                f"({self.prefill_chunk}): chunk pads would be routed"
            )
        staged = -(-(p_n if capacity_moe else self._pad_len(p_n))
                   // self.block_size)
        if (int(self._reserved.sum()) + self._prefix_reserved + staged
                > self.num_blocks):
            raise RuntimeError(
                "pool cannot hold the prefix alongside the blocks "
                "reserved for in-flight requests"
            )
        if capacity_moe:
            self._stage_moe_prefix(slot, tokens)
        else:
            pad = self._pad_len(p_n)
            buf = np.zeros((1, pad), np.int64)
            buf[0, :p_n] = tokens
            _, cache, ok = paged_prefill_rows(
                self.params, upload(self.device, buf),
                self.config, self.cache, slot_ids=[slot], prompt_lens=[p_n])
            if not host_sync("pool_ok", bool, ok):
                raise RuntimeError("pool cannot hold the prefix")
            self.cache = cache
        self.cache, ids, n_total = detach_row_keep_blocks(self.cache, slot)
        n_total = int(n_total)
        if n_total > k:  # chunk-pad blocks past the prefix: free them
            self.cache = drop_blocks(self.cache, ids[k:], n_total - k)
        self._prefix_reserved += k
        return PrefixHandle(tokens=list(tokens), block_ids=ids[:k].clone(),
                            n_blocks=k)

    def _stage_moe_prefix(self, slot: int, tokens: List[int]) -> None:
        """Admit ``slot`` for exactly the prefix and stream it through
        ``prefill_chunk``-token chunks (drop-free routing, no pads)."""
        c_sz = self.prefill_chunk
        mask = self._row_mask(slot)
        cache, ok = admit(self.cache, mask, mask * len(tokens))
        if not host_sync("pool_ok", bool, ok):
            raise RuntimeError("pool cannot hold the prefix")
        self.cache = cache
        active = mask.astype(bool)
        for i in range(0, len(tokens), c_sz):
            chunk = np.zeros((self.slots, c_sz), np.int64)
            chunk[slot] = tokens[i:i + c_sz]
            _, cache, ok = paged_decode_chunk(
                self.params, self.cache, upload(self.device, chunk),
                self.config, attn_impl=self.attn_impl, active=active)
            if not host_sync("pool_ok", bool, ok):
                raise RuntimeError("pool cannot hold the prefix")
            self.cache = cache

    def _release_handle_ref(self, handle: PrefixHandle) -> None:
        handle.refs -= 1
        if handle.refs == 0:
            # Last reference anywhere (registry AND every submitted
            # request): only now may the blocks and the reservation go.
            self.cache = drop_blocks(self.cache, handle.block_ids,
                                     handle.n_blocks)
            self._prefix_reserved -= handle.n_blocks

    def close_prefix(self, handle: PrefixHandle) -> None:
        """Stop new submits against the handle and drop the registry's
        reference; blocks free once the last submitted request finishes."""
        if handle.closed:
            return
        handle.closed = True
        self._release_handle_ref(handle)

    # -- scheduling ----------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._slot_req):
            if r is None:
                return i
        return None

    def _try_admit(self, tree: Optional[tracing.Tree]
                   ) -> List[Tuple[int, int]]:
        """Admit the head-of-line request if a slot and its worst-case
        blocks are available; returns the (req_id, token) events the
        admission produced. One admission per call; a bucketed one is a
        ``serving.admit`` span of ``tree`` (``prompt`` real tokens,
        ``padded`` positions the prefill runs)."""
        if not self._waiting:
            return []
        slot = self._free_slot()
        if slot is None:
            return []
        req = self._waiting[0]
        pad = self._pad_len_req(req.prompt, req.prefix)
        worst = self._worst_fresh_blocks(pad, req.max_new_tokens, req.prefix)
        if (int(self._reserved.sum()) + self._prefix_reserved + worst
                > self.num_blocks):
            return []  # head-of-line blocks; FIFO fairness, no starvation
        self._waiting.popleft()
        if self.prefill_chunk is not None:
            # Reserve the blocks now (admit-only), then stream the prompt
            # one chunk per step; a prefix-attached row opens with the
            # shared blocks and streams only its remainder.
            if req.prefix is not None:
                p_n = req.prefix.n_tokens
                cache, ok = attach_prefix(
                    self.cache, slot, req.prefix.block_ids, p_n,
                    extra_tokens=pad - p_n)
                tail = req.prompt[p_n:]
            else:
                mask = self._row_mask(slot)
                cache, ok = admit(self.cache, mask, mask * pad)
                tail = req.prompt
            if not host_sync("pool_ok", bool, ok):
                # The host reservation makes this unreachable.
                self._waiting.appendleft(req)
                return []
            self.cache = cache
            self._slot_req[slot] = req
            self._reserved[slot] = worst
            padded = np.zeros(self._pad_len(len(tail)), np.int64)
            padded[:len(tail)] = tail
            self._admitting.append({"slot": slot, "req": req, "consumed": 0,
                                    "padded": padded, "tail": len(tail)})
            return []
        if tree is None:
            return self._prefill(slot, req, pad, worst)
        tree.begin("serving.admit", req_id=req.req_id,
                   prompt=len(req.prompt), padded=pad,
                   graph=int(self._admit_graphed))
        launched = self._launch_counts()
        events = self._prefill(slot, req, pad, worst)
        self._note_kernels(tree, launched, self._admit_graphs.get(pad + 2)
                           if self._admit_graphed else None)
        tree.end()
        return events

    def _prefill(self, slot: int, req: Request, pad: int, worst: int
                 ) -> List[Tuple[int, int]]:
        """The bucketed prefill of ``req`` (padded to ``pad``) into
        ``slot``, up to its first token: one upload of the padded prompt,
        the slot and the real length, and one read of the first token
        with the pool's ok."""
        n = len(req.prompt)
        inputs = np.zeros(pad + 2, np.int64)
        inputs[:n] = req.prompt
        inputs[pad:] = slot, n
        logits, cache, ok = self._admit(upload(self.device, inputs))
        self._slot_req[slot] = req
        self._arm_sampling(slot, req)
        first, ok = self._pick_first(slot, logits, ok)
        if not ok:  # host reservation makes this unreachable
            self._clear(slot)
            self._waiting.appendleft(req)
            return []
        self.cache = cache
        self._reserved[slot] = worst
        self._emit(slot, first)
        return [(req.req_id, first)]

    @property
    def _admit_graphed(self) -> bool:
        """Whether a bucketed admission replays a CUDA graph."""
        return self._graphed and self._admit_graphs is not None

    def _admit_body(self, cache, inputs: torch.Tensor):
        """The bucketed admission from its one upload ``inputs`` (S + 2,):
        the prompt padded to S, the released slot it takes, its length."""
        pad = inputs.shape[0] - 2
        return paged_prefill_rows(
            self.params, inputs[None, :pad], self.config, cache,
            slot_ids=inputs[pad:pad + 1], prompt_lens=inputs[-1:],
            **self._route_kw())

    def _admit(self, inputs: torch.Tensor):
        """The bucketed admission's (logits, cache, ok), ``ok`` on the
        device: replayed from the padded length's CUDA graph where the
        engine takes one (captured here at that length's first
        admission), run eagerly otherwise."""
        if not self._admit_graphed:
            return self._admit_body(self.cache, inputs)
        graph = self._admit_graphs.get(inputs.shape[0])
        if graph is None:
            if self._admit_pool is None:
                self._admit_pool = torch.cuda.graph_pool_handle()
            graph = host_sync("capture", _PrefillGraph, self,
                              self._admit_body, (inputs,), self._admit_pool)
            self._admit_graphs[inputs.shape[0]] = graph
        return graph.replay(self.cache, inputs)

    def _arm_sampling(self, slot: int, req: Request) -> None:
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._slot_gen[slot] = (torch.Generator().manual_seed(req.seed)
                                if req.temperature > 0 else None)

    def _draw(self, slot: int) -> float:
        """The slot's next uniform draw (0 for a greedy slot, which uses
        none)."""
        gen = self._slot_gen[slot]
        if gen is None:
            return 0.0
        return float(torch.rand(1, generator=gen, dtype=torch.float64))

    def _pick(self, logits, rows: slice, u: np.ndarray) -> torch.Tensor:
        temp, top_k, top_p, u = upload(
            logits.device, self._temp[rows], self._topk[rows],
            self._topp[rows], u)
        return _pick_rows(logits, temp, top_k, top_p, u)

    def _pick_first(self, slot: int, logits_1v, ok=None) -> Tuple[int, bool]:
        """The slot's first token from its (1, vocab) logits, the argmax
        for a greedy slot: (token, ok), read in one copy with ``ok``, a
        device flag, or None where the host has checked the pool."""
        if self._slot_gen[slot] is None:
            pick = torch.argmax(logits_1v, dim=-1)
        else:
            pick = self._pick(logits_1v, slice(slot, slot + 1),
                              np.array([self._draw(slot)]))
        if ok is None:
            return host_sync("first_token", int, pick[0]), True
        first, ok = host_sync("first_token", _tokens_and_ok, pick, ok)
        return int(first[0]), ok

    def _advance_admission(self, tree: Optional[tracing.Tree]
                           ) -> List[Tuple[int, int]]:
        """Feed the longest-waiting chunked admission its next chunk, a
        ``serving.admit`` span of ``tree`` (``prompt`` real tokens in the
        chunk, ``padded`` the chunk's length)."""
        if not self._admitting:
            return []
        st = self._admitting.popleft()
        if tree is None:
            return self._chunk(st)
        c_sz = self.prefill_chunk
        tree.begin("serving.admit", req_id=st["req"].req_id,
                   prompt=min(c_sz, st["tail"] - st["consumed"]),
                   padded=c_sz, graph=0)
        launched = self._launch_counts()
        events = self._chunk(st)
        self._note_kernels(tree, launched, None)
        tree.end()
        return events

    def _chunk(self, st: Dict[str, Any]) -> List[Tuple[int, int]]:
        """Run one chunk of the admission ``st``; on its last chunk, set
        the real prompt length, arm sampling and emit the first token."""
        c_sz = self.prefill_chunk
        slot, req = st["slot"], st["req"]
        chunk = np.zeros((self.slots, c_sz), np.int64)
        chunk[slot] = st["padded"][st["consumed"]:st["consumed"] + c_sz]
        active = np.zeros(self.slots, bool)
        active[slot] = True
        logits, cache, ok = paged_decode_chunk(
            self.params, self.cache, upload(self.device, chunk),
            self.config, attn_impl=self.attn_impl, active=active,
            **self._route_kw())
        if not host_sync("pool_ok", bool, ok):
            raise RuntimeError(
                "pool exhausted during chunked admission despite "
                "host-side reservation"
            )
        self.cache = cache
        st["consumed"] += c_sz
        if st["consumed"] < len(st["padded"]):
            self._admitting.append(st)  # more chunks to stream
            return []
        # Pad-slot K/V sits past the real length: masked on every read and
        # overwritten as the row decodes.
        length = self.cache.length.clone()
        length[slot] = upload(self.device, len(req.prompt))
        self.cache = self.cache._replace(length=length)
        self._arm_sampling(slot, req)
        # The streamed content is the request's tail; its last real
        # token's logits sit at tail-relative offset (tail-1) % chunk.
        first, _ = self._pick_first(
            slot, logits[slot:slot + 1, (st["tail"] - 1) % c_sz])
        self._emit(slot, first)
        return [(req.req_id, first)]

    def _free(self, slot: int) -> None:
        """Release a slot's blocks and zero its per-slot state (completion
        and cancellation alike); a prefix-attached row also drops its
        handle reference."""
        req = self._slot_req[slot]
        self.cache = release(self.cache, self._row_mask(slot))
        self._clear(slot)
        if req is not None and req.prefix is not None:
            self._release_handle_ref(req.prefix)

    def _clear(self, slot: int) -> None:
        """Zero a slot's per-slot state."""
        self._slot_req[slot] = None
        self._reserved[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._slot_gen[slot] = None

    def _route_kw(self) -> Dict[str, torch.Tensor]:
        """The paged calls' ``routes`` argument, where the engine keeps a
        routing record."""
        return {} if self._routes is None else {"routes": self._routes}

    def _emit(self, slot: int, token: int) -> None:
        req = self._slot_req[slot]
        req.tokens.append(token)
        self._next_token[slot] = token
        if (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and token == self.eos_id)):
            req.done = True
            if self._routes is not None:
                n = len(req.prompt) + len(req.tokens) - 1
                req.routes = self._routes[slot, :, :n].clone()
            self._free(slot)

    def cancel(self, req: Request) -> bool:
        """Abort a request wherever it is — waiting, mid-chunked-
        admission, or decoding — returning its blocks to the pool. Returns
        False when it had already finished; ``req.done`` flips either way."""
        if req.done:
            return False
        req.done = True
        if req in self._waiting:
            self._waiting.remove(req)
            if req.prefix is not None:
                self._release_handle_ref(req.prefix)
            return True
        for st in list(self._admitting):
            if st["req"] is req:
                self._admitting.remove(st)
                self._free(st["slot"])
                return True
        for slot, r in enumerate(self._slot_req):
            if r is req:
                self._free(slot)
                return True
        return False

    # -- the loop ------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine iteration: admit (at most one), then one decode step
        across every active slot. Returns ALL (req_id, token) events this
        step, including a just-admitted request's first token.

        While tracing is on (``runtime/tracing.py``), the step records one
        span tree, category ``serving``: ``serving.step`` (args ``rows``
        decoded, ``tokens`` emitted, ``syncs``) holding ``serving.admit``
        (the admission up to its first token) and ``serving.decode`` (the
        decode forward, from the call until the logits return), each with
        args ``graph`` (1 where its forward is a CUDA graph's replay, 0
        where it runs eagerly) and ``swiglu_fused`` (the SwiGLU products
        of its forward that ran the kernel ``csrc/swiglu.cu``); an MoE
        engine's also carry ``moe_grouped`` (the MoE layers of its
        forward that ran the grouped path, ``models/moe._grouped_ffn``; a
        replay's counted at its capture), and its replayed
        ``serving.decode`` the step's ``rows`` and ``real`` (what the
        eager step's ``moe.experts`` spans carry, summed over the
        captured layers); an MLA
        engine's ``serving.decode`` also carries ``latent_positions``
        (the latent entries its attention reads: Σ over decoded rows of
        their lengths, times the layers, from the host's own counts) and
        ``k3`` (its forward's launches of K3, a replay's counted at its
        capture), then
        ``serving.emit`` (emitting the tokens and freeing finished
        slots), and a ``serving.sync`` leaf (arg ``what``) for each host
        sync, in whichever phase it falls."""
        tree = tracing.open_tree("serving.step", "serving")
        if tree is None:
            return self._step(None)[0]
        try:
            events, rows = self._step(tree)
        except BaseException as e:
            tree.close(error=f"{type(e).__name__}: {e}")
            raise
        tree.close(rows=rows, tokens=len(events))
        return events

    def _step(self, tree: Optional[tracing.Tree]
              ) -> Tuple[List[Tuple[int, int]], int]:
        """The step's events and the number of rows it decoded."""
        events = self._try_admit(tree)
        events += self._advance_admission(tree)
        admitting_slots = {st["slot"] for st in self._admitting}
        active = np.array(
            [r is not None and s not in admitting_slots
             for s, r in enumerate(self._slot_req)], bool)
        if not active.any():
            return events, 0
        if tree is not None:
            tree.begin("serving.decode", graph=int(self._graphed))
            if self._latent:
                tree.note(latent_positions=self.config.n_layers * sum(
                    len(r.prompt) + len(r.tokens)
                    for s, r in enumerate(self._slot_req) if active[s]))
        launched = self._launch_counts()
        logits, cache, ok = self._decode(
            *upload(self.device, self._next_token, active))
        if tree is not None:
            grouped = self._note_kernels(tree, launched, self._graph)
            if self._latent:
                tree.note(k3=self._ran(mla_decode_cuda, launched,
                                       self._graph))
            if self._graph is not None and self._moe:
                # A replay records no ``moe.experts`` span: its sums go
                # here, the rows as the captured layers computed them.
                c, rows = self.config, self.slots
                tree.note(rows=rows * (grouped * c.top_k + (
                    self._n_moe - grouped) * c.n_experts),
                    real=self._n_moe * rows * c.top_k)
            tree.end()
        if all(g is None for g in self._slot_gen):
            picks = torch.argmax(logits, dim=-1)
        else:
            # Each active sampled slot takes its next draw, in slot order
            # (each request has its own generator, so order is free).
            u = np.array([self._draw(s) if active[s] else 0.0
                          for s in range(self.slots)])
            picks = self._pick(logits, slice(None), u)
        picks, ok = host_sync("tokens", _tokens_and_ok, picks, ok)
        if not ok:
            # A real exception, not an assert: python -O would strip it
            # and then emit tokens picked from meaningless logits.
            raise RuntimeError("pool exhausted despite host-side reservation")
        self.cache = cache
        if tree is not None:
            tree.begin("serving.emit")
        rows = np.nonzero(active)[0]
        for slot in rows:
            req = self._slot_req[slot]
            self._emit(slot, int(picks[slot]))
            events.append((req.req_id, int(picks[slot])))
        if tree is not None:
            tree.end()
        return events, len(rows)

    @staticmethod
    def _launch_counts() -> Dict[Any, int]:
        """The launch counts of the kernels a forward's span reports."""
        return {fn: fn.launches for fn in (swiglu_cuda, group_cuda,
                                           mla_decode_cuda)}

    @staticmethod
    def _ran(fn, launched: Dict[Any, int], graph: Optional["_Graph"]
             ) -> int:
        """The launches of ``fn`` in the forward just run: a replayed
        graph's, counted at its capture; an eager forward's, since the
        counts ``launched``."""
        return fn.launches - launched[fn] if graph is None else (
            graph.count(fn))

    def _note_kernels(self, tree: tracing.Tree, launched: Dict[Any, int],
                      graph: Optional["_Graph"]) -> int:
        """Note on the open span ``swiglu_fused`` (the SwiGLU products of
        the forward just run that took ``csrc/swiglu.cu``) and, for an
        MoE engine, ``moe_grouped`` (its MoE layers that ran the grouped
        path, ``csrc/moe_grouped.cu``); returns the latter."""
        tree.note(swiglu_fused=self._ran(swiglu_cuda, launched, graph))
        grouped = self._ran(group_cuda, launched, graph)
        if self._moe:
            tree.note(moe_grouped=grouped)
        return grouped

    def _decode(self, token: torch.Tensor, active: torch.Tensor):
        """The decode step's (logits, cache, ok), ``ok`` on the device:
        replayed from the CUDA graph where the engine has one (captured
        here at its first decode step), run eagerly otherwise."""
        if not self._graphed:
            return self._decode_body(self.cache, token, active)
        if self._graph is None:
            self._graph = host_sync("capture", _DecodeGraph, self,
                                    self._decode_body, (token, active))
        return self._graph.replay(self.cache, token, active)

    def _decode_body(self, cache, token: torch.Tensor, active: torch.Tensor):
        return paged_decode_step(
            self.params, cache, token, self.config, attn_impl=self.attn_impl,
            active=active, **self._route_kw())

    def run(self, max_steps: int = 100000) -> None:
        """Drive until every submitted request is done."""
        for _ in range(max_steps):
            if not self._waiting and not any(
                    r is not None for r in self._slot_req):
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")


def _worst_blocks(prompt_len: int, max_new: int, block_size: int) -> int:
    return -(-(prompt_len + max_new) // block_size)


def _tokens_and_ok(picks: torch.Tensor, ok: torch.Tensor):
    """A decode step's picked tokens and its pool flag, read in one copy
    to the host: (tokens as a NumPy array, ok as a bool)."""
    both = torch.cat([picks.to(torch.int64), ok.to(torch.int64)[None]]).cpu()
    return both[:-1].numpy(), bool(both[-1])


#: The cache's bookkeeping, copied into a graph before each replay.
_STATE = ("block_tables", "length", "n_blocks", "free", "free_top",
          "refcount")
#: What a decode step or an admission changes of it (the free stack only
#: on release).
_STEPPED = ("block_tables", "length", "n_blocks", "free_top", "refcount")


class _Graph:
    """One of an engine's forwards, ``body(cache, *args) -> (logits,
    cache, ok)``, as one CUDA graph at the shape of ``args``.

    Its inputs are static device buffers: copies of ``args`` and of the
    cache's bookkeeping; the K/V pools and the routing record are the
    engine's own, written in place as an eager forward writes them, and
    the weights are the engine's; warm-up and capture record no spans
    (``tracing.suspended``). :meth:`replay` copies the engine's current
    state and the new arguments into the inputs (on the device, no sync),
    replays, and returns the logits and ``ok`` the graph writes and the
    new bookkeeping as copies, so the engine's cache never shares a
    buffer with the graph. The body is captured through the names it
    calls, looked up when it is captured, after one eager warm-up on a
    side stream; ``pool`` is a memory pool shared with other graphs that
    never replay at once. The kernels' launch counts (``COUNTERS``),
    which a capture raises without running anything, are put back and
    raised by as much at each replay (:meth:`count`)."""

    COUNTERS: Tuple[Tuple[Any, str], ...] = (
        (swiglu_cuda, "launches"), (group_cuda, "launches"),
        (gate_up_cuda, "launches"), (down_cuda, "launches"),
        (combine_cuda, "launches"))

    def __init__(self, eng: "ContinuousBatchingEngine", body,
                 args: Tuple[torch.Tensor, ...], pool=None):
        self.args = [a.clone() for a in args]
        self.cache = eng.cache._replace(
            **{f: getattr(eng.cache, f).clone() for f in _STATE})
        main = torch.cuda.current_stream(eng.device)
        side = torch.cuda.Stream(eng.device)
        side.wait_stream(main)
        with tracing.suspended():
            with torch.cuda.stream(side):
                body(self.cache, *self.args)
            main.wait_stream(side)
            before = [getattr(fn, name) for fn, name in self.COUNTERS]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = body(self.cache, *self.args)
        self.launches = []
        for (fn, name), was in zip(self.COUNTERS, before):
            self.launches.append(getattr(fn, name) - was)
            setattr(fn, name, was)
        self.replays = 0

    def count(self, fn, name: str = "launches") -> int:
        """The launches of ``fn`` (its counter ``name``) in the captured
        forward."""
        return self.launches[self.COUNTERS.index((fn, name))]

    def replay(self, cache, *args):
        """The forward from ``cache`` on ``args``: (logits, cache, ok)."""
        for buf, a in zip(self.args, args):
            buf.copy_(a)
        for f in _STATE:
            getattr(self.cache, f).copy_(getattr(cache, f))
        self.graph.replay()
        self.replays += 1
        for (fn, name), n in zip(self.COUNTERS, self.launches):
            setattr(fn, name, getattr(fn, name) + n)
        logits, out, ok = self.out
        return logits, cache._replace(
            **{f: getattr(out, f).clone() for f in _STEPPED}), ok


class _DecodeGraph(_Graph):
    """An engine's decode step at its fixed ``(slots,)`` shape, on the
    step's tokens and active mask; it raises K3's and K2's launch
    counts."""

    COUNTERS = _Graph.COUNTERS + ((mla_decode_cuda, "launches"),
                                  (paged_decode_cuda, "launches"),
                                  (paged_decode_cuda, "launches_int8"))


class _PrefillGraph(_Graph):
    """A dense engine's bucketed admission at one padded length, on the
    admission's uploaded inputs (``_admit_body``); it raises K1's
    launch count."""

    COUNTERS = _Graph.COUNTERS + ((flash_fwd_cuda, "launches"),)
