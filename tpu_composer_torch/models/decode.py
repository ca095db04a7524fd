"""KV-cached autoregressive decoding for the dense and MoE transformers
(port of ``tpu_composer/models/decode.py``).

Prefill runs the prompt once and captures each layer's K/V; generation
is then a loop of single-token steps against a cache pre-allocated at
``max_seq``. The cache tensors are written IN PLACE: a ``KVCache``
returned by ``decode_chunk`` shares its K/V tensors with the one passed
in (only ``length`` is new), which is all ``generate`` needs and saves a
copy of the cache per token.

Sampling: temperature first, then top-k, then top-p, then a categorical
draw by inverse CDF from one uniform number per row per token, taken from
a CPU ``torch.Generator`` seeded with ``seed``: generated token t uses
draw t. JAX's categorical stream cannot be reproduced, so agreement with
the JAX package is greedy-only; the filters themselves agree exactly.

MoE capacity: ``prefill`` is the training forward and routes the whole
prompt as one group with the config's capacity rule, so a capacity-
routed config may drop tokens past an expert's capacity (a dropless one
never does). ``decode_chunk`` and ``decode_step`` route DROP-FREE
(capacity = chunk length, which no expert can overflow), so a T-token
chunk computes exactly what T single steps would: the invariant
speculative verify rests on. The two agree whenever the prompt's
forward dropped nothing.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.mla import MLAConfig
from tpu_composer_torch.models.moe import MoEConfig, RouteRecord, ffn_delta
from tpu_composer_torch.models.quant import (
    embedding_lookup,
    quantize_weight,
    resolve,
)
from tpu_composer_torch.models.transformer import (
    ModelConfig,
    _rmsnorm,
    _rope,
    _select_attn,
    _tied_logits,
    project_qkv,
)

AnyConfig = Union[ModelConfig, MoEConfig]


def _ffn_delta(h, layer, layer_idx: int, c: AnyConfig,
               drop_free: bool = False, record: Optional[RouteRecord] = None):
    """The FFN residual through the shared MoE-or-dense branch
    (``models/moe.ffn_delta``), its aux loss dropped: inference trains no
    router. The decode paths pass ``drop_free=True``; prefill keeps the
    training forward's capacity rule."""
    return ffn_delta(h, layer, layer_idx, c, drop_free=drop_free,
                     record=record)[0]


def pads_route(c: AnyConfig) -> bool:
    """Whether pad tokens after a prompt can change its real tokens: a
    capacity-routed MoE row is one capacity group, so pads may push real
    tokens past an expert's capacity. Dense and dropless models route
    (or not) each token on its own."""
    return isinstance(c, MoEConfig) and not c.dropless


class KVCache(NamedTuple):
    """Per-layer stacked K/V: (n_layers, B, max_seq, KV, Dh). ``k_scale``/
    ``v_scale`` (L, B, S, KV) fp32 are present when K/V are int8."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32 valid positions per row
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8 over the Dh axis: x (..., Dh)
    -> (int8 values, fp32 scale (...,))."""
    qt = quantize_weight(x, (-1,))
    return qt.q, qt.scale[..., 0]


def _rowwise_update(cache_layer, new, pos):
    """Write ``new`` (B, T, ...) into ``cache_layer`` (B, S, ...) in place
    at per-row start ``pos`` (B,), clamped so the slice fits (the
    ``dynamic_update_slice`` rule)."""
    b, t = new.shape[0], new.shape[1]
    start = pos.long().clamp(0, max(cache_layer.shape[1] - t, 0))
    idx = start[:, None] + torch.arange(t, device=new.device)[None, :]
    rows = torch.arange(b, device=new.device)[:, None]
    cache_layer[rows, idx] = new.to(cache_layer.dtype)
    return cache_layer


def _append_quantized(vals, scales, layer_idx: int, new, pos):
    """Quantize ``new`` and write values + scales of layer ``layer_idx``
    at per-row ``pos``; returns that layer's (values, scales)."""
    q, sc = quantize_kv(new)
    return (_rowwise_update(vals[layer_idx], q, pos),
            _rowwise_update(scales[layer_idx], sc, pos))


def init_kv_cache(config: AnyConfig, batch: int,
                  max_seq: Optional[int] = None, quant: bool = False,
                  device: DeviceLike = "cuda") -> KVCache:
    c = config
    if isinstance(c, MLAConfig):
        raise ValueError("an MLA config caches latent entries in the paged"
                         " pool only (models/paged.py): no contiguous cache,"
                         " so no solo generate and no speculative decoding")
    dev = resolve_device(device)
    s = max_seq or c.max_seq
    shape = (c.n_layers, batch, s, c.kv_heads, c.head_dim)
    length = torch.zeros(batch, dtype=torch.int32, device=dev)
    if not quant:
        return KVCache(k=torch.zeros(shape, dtype=c.dtype, device=dev),
                       v=torch.zeros(shape, dtype=c.dtype, device=dev),
                       length=length)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=dev),
        v=torch.zeros(shape, dtype=torch.int8, device=dev),
        length=length,
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    )


def _project_qkv(layer: Dict, x, positions, c):
    h = _rmsnorm(x, layer["ln1"])
    q, k, v = project_qkv(layer, h)
    return _rope(q, positions, c.rope_theta), _rope(k, positions, c.rope_theta), v


def _cached_attention(q, k_cache, v_cache, valid_len, c,
                      k_scale=None, v_scale=None, q_positions=None):
    """One query block against the cache. q: (B, Sq, H, Dh); cache:
    (B, S, KV, Dh); positions >= valid_len are masked to -1e30. Query
    heads are viewed as (KV, group), so grouped caches are read once.
    ``q_positions`` (B, Sq) gives per-query causal limits (query i sees
    positions <= q_positions[i]). int8 caches (``k_scale``/``v_scale``
    (B, S, KV)): the k scale multiplies the scores, the v scale folds
    into the probabilities."""
    b, sq, h, dh = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, dh)
    kc = k_cache if k_scale is None else k_cache.to(c.dtype)
    # fp32 accumulation from cache-dtype operands.
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
    scores = scores / math.sqrt(c.head_dim)
    if k_scale is not None:
        scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    k_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    if q_positions is None:
        keep = k_pos < valid_len[:, None, None, None, None]
    else:
        keep = k_pos <= q_positions[:, None, None, :, None]
    scores = torch.where(keep, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
        vc = v_cache.to(c.dtype)
    else:
        vc = v_cache
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(c.dtype), vc)
    return out.reshape(b, sq, h, dh)


def _check_prompt_lens(prompt_lens, b: int, s_p: int):
    if prompt_lens.shape != (b,):
        raise ValueError(
            f"prompt_lens shape {tuple(prompt_lens.shape)} != ({b},)")
    if bool(((prompt_lens < 1) | (prompt_lens > s_p)).any()):
        raise ValueError(
            f"prompt_lens must be in [1, {s_p}], got {prompt_lens.tolist()}")


def _last_real(x, prompt_lens):
    """Each row's hidden state at its last real position: (B, S, D) -> (B, D)."""
    if prompt_lens is None:
        return x[:, -1]
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, prompt_lens.long() - 1]


def prefill(params: Dict, tokens: torch.Tensor, config: AnyConfig,
            max_seq: Optional[int] = None, quant: bool = False,
            prompt_lens: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, S_prompt), filling a fresh cache on the tokens'
    device. Returns each row's last-real-position logits (B, vocab) fp32
    and the primed cache. Ragged batches: right-pad and pass
    ``prompt_lens`` (B,). Capacity-routed MoE configs refuse ragged
    batches: routing shares one capacity group across the padded row, so
    pads would affect real tokens."""
    c = config
    attn = _select_attn(c, None)
    b, s_p = tokens.shape
    cap = max_seq or c.max_seq
    if s_p > cap:
        raise ValueError(f"prompt length {s_p} exceeds cache capacity {cap}")
    if prompt_lens is not None:
        if pads_route(c):
            raise ValueError(
                "ragged prompts are dense-only (or dropless MoE): capacity"
                " MoE routing shares one"
                " capacity group across the padded row, so pad tokens"
                " would affect real ones"
            )
        prompt_lens = torch.as_tensor(prompt_lens, device=tokens.device)
        _check_prompt_lens(prompt_lens, b, s_p)
    cache = init_kv_cache(c, b, max_seq, quant=quant, device=tokens.device)
    positions = torch.arange(s_p, dtype=torch.int32,
                             device=tokens.device).expand(b, s_p)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, x, positions, c)
        if quant:
            for vals, scales, new in ((cache.k, cache.k_scale, k),
                                      (cache.v, cache.v_scale, v)):
                nq, ns = quantize_kv(new)
                vals[li, :, :s_p] = nq
                scales[li, :, :s_p] = ns
        else:
            cache.k[li, :, :s_p] = k
            cache.v[li, :, :s_p] = v
        o = attn(q, k, v, causal=True).to(c.dtype)
        x = x + torch.einsum("bshk,hkd->bsd", o, resolve(layer["wo"], c.dtype))
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c)
    x = _rmsnorm(x, params["ln_f"])
    logits = _tied_logits(_last_real(x, prompt_lens), params["embed"], c.dtype)
    length = (torch.full((b,), s_p, dtype=torch.int32, device=tokens.device)
              if prompt_lens is None else prompt_lens.to(torch.int32))
    return logits, cache._replace(length=length)


def decode_chunk(params: Dict, cache: KVCache, tokens: torch.Tensor,
                 config: AnyConfig) -> Tuple[torch.Tensor, KVCache]:
    """T tokens (B, T) in, per-position next-token logits (B, T, vocab)
    out, cache advanced by T (written in place). Token i attends the cache
    plus chunk tokens 0..i. MoE layers route drop-free."""
    c = config
    b, t = tokens.shape
    pos = cache.length
    positions = pos[:, None] + torch.arange(
        t, dtype=torch.int32, device=tokens.device)[None, :]
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = _project_qkv(layer, x, positions, c)
        if cache.quantized:
            k_cache, ks_cache = _append_quantized(cache.k, cache.k_scale, li,
                                                  k, pos)
            v_cache, vs_cache = _append_quantized(cache.v, cache.v_scale, li,
                                                  v, pos)
        else:
            ks_cache = vs_cache = None
            k_cache = _rowwise_update(cache.k[li], k, pos)
            v_cache = _rowwise_update(cache.v[li], v, pos)
        o = _cached_attention(q, k_cache, v_cache, pos + t, c,
                              k_scale=ks_cache, v_scale=vs_cache,
                              q_positions=positions)
        x = x + torch.einsum("bshk,hkd->bsd", o, resolve(layer["wo"], c.dtype))
        x = x + _ffn_delta(_rmsnorm(x, layer["ln2"]), layer, li, c,
                           drop_free=True)
    x = _rmsnorm(x, params["ln_f"])
    logits = _tied_logits(x, params["embed"], c.dtype)
    return logits, cache._replace(length=pos + t)


def decode_step(params: Dict, cache: KVCache, token: torch.Tensor,
                config: AnyConfig) -> Tuple[torch.Tensor, KVCache]:
    """One token (B,) in, next-token logits (B, vocab) out."""
    logits, cache = decode_chunk(params, cache, token[:, None], config)
    return logits[:, 0], cache


def filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top_k logits per row (ties with the k-th kept), set the
    rest to -inf."""
    if top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, -math.inf)


def filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the descending
    softmax whose mass reaches top_p (always at least the argmax)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    cut = torch.where(keep_sorted, sorted_logits, math.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= cut, logits, -math.inf)


def sample_categorical(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) (B, V) by inverse CDF, given
    uniforms ``u`` (B,) in [0, 1): the first index whose cumulative
    probability exceeds u. -inf logits are never drawn. Returns int32."""
    probs = torch.softmax(logits.double(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    target = (u.to(cdf.device, torch.float64) * cdf[:, -1])[:, None]
    idx = torch.searchsorted(cdf, target, right=True)[:, 0]
    return idx.clamp_max(logits.shape[-1] - 1).to(torch.int32)


def generate(params: Dict, prompt: torch.Tensor, config: AnyConfig,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             seed: int = 0, max_seq: Optional[int] = None,
             kv_quant: bool = False,
             prompt_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation: prefill + a loop of
    decode steps. Returns (B, max_new_tokens) int32. Sampling divides by
    ``temperature``, then filters by ``top_k`` and ``top_p``; draws come
    from a CPU generator seeded with ``seed``, one uniform per row per
    generated token, token t from draw t."""
    c = config
    cap = max_seq or c.max_seq
    if prompt.shape[1] + max_new_tokens > cap:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens ({max_new_tokens})"
            f" exceeds the KV cache capacity ({cap})"
        )
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    gen = torch.Generator().manual_seed(seed)
    logits, cache = prefill(params, prompt, c, max_seq=max_seq,
                            quant=kv_quant, prompt_lens=prompt_lens)

    def pick(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        logits = logits / temperature
        if top_k is not None:
            logits = filter_top_k(logits, top_k)
        if top_p is not None and top_p < 1.0:
            logits = filter_top_p(logits, top_p)
        u = torch.rand(logits.shape[0], generator=gen, dtype=torch.float64)
        return sample_categorical(logits, u)

    token = pick(logits)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cache, token, c)
        token = pick(logits)
        out.append(token)
    return torch.stack(out, dim=1)
