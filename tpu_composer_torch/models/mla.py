"""Multi-head latent attention (MLA) beside DeepSeek-V3's MoE block, as
Moonlight-16B-A3B and DeepSeek-V3 build them (``q_lora_rank`` null). The
JAX package has no such model; this module is the port's own.

Layer ``i`` of the tree (``MLAConfig``; H heads, r = ``kv_lora_rank``,
dn, dr = ``qk_nope_head_dim``, ``qk_rope_head_dim``, dv the value width):
``{ln1, wq (D, H, dn + dr), wkva (D, r + dr), kv_norm (r,) fp32,
wkvb (r, H, dn + dv), wo (H, dv, D), ln2}`` and the FFN of
``models/moe.py``: dense (``w_gate``, ``w_up``, ``w_down``) for
``i < first_k_dense_replace``, else routed experts, the router, its
selection bias and the shared experts. With x normalised by ``ln1``:

- ``q = x·wq`` splits into q_nope (dn) and q_pe (dr) per head;
- ``[c_kv | k_pe] = x·wkva``; c_kv ← RMSNorm(c_kv) with ``kv_norm``;
- RoPE (base ``rope_theta``) on q_pe and on the one k_pe all heads
  share, rotating halves as ``transformer._rope`` does: the first dr/2
  dimensions pair with the last dr/2. The source's modeling code
  permutes adjacent pairs into that layout before rotating, which is
  the same function of weights whose rope columns are permuted alike;
- ``[k_nope_h | v_h] = c_kv·wkvb_h``; scores ``q_h·[k_nope_h | k_pe]``
  times 1/√(dn + dr), causal softmax; ``o = concat_h(p·v_h)·wo``.

What a position leaves in the cache is its latent entry ``[c_kv |
k_pe]`` (r + dr wide, :func:`project`), the one paged pool of
``models/paged.py``; there is no separate K or V. Two forms read it:

- expanded (prefill, :func:`expanded_attention`): the entries lift to
  per-head k (dn + dr) and v (dv), and causal attention runs over them
  (K1 at 192/128 on the card);
- absorbed (decode, :func:`absorb_query`, :func:`absorbed_output`):
  ``q_lat_h = q_nope_h·W_uk_hᵀ`` (r wide) beside q_pe scores the
  entries directly, the output's latent ``o_lat_h`` (the first r dims
  of the entries weighed by p) goes through ``W_uv_h``; W_uk and W_uv
  are the k and v columns of ``wkvb``. On the card the decode kernel K3
  (``ops/mla_decode.py``) computes o_lat from the pool.

:func:`forward` is the whole model without a cache (expanded), for the
tests. While a ``runtime/tracing`` tree is the thread's, each layer's
attention is a ``mla.attend`` span (args ``path``, ``expand`` or
``absorb``, and ``positions``, the key positions it reads).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from tpu_composer_torch.models.moe import MoEConfig, ffn_delta
from tpu_composer_torch.models.quant import embedding_lookup, resolve
from tpu_composer_torch.models.transformer import (
    AttnFn,
    _rmsnorm,
    _rope,
    _select_attn,
    _tied_logits,
)
from tpu_composer_torch.runtime import tracing


@dataclass(frozen=True)
class MLAConfig(MoEConfig):
    """MoEConfig's DeepSeek-V3 block with latent attention; the fields
    are the source's config.json keys (the value width is ``wkvb``'s).
    Routed dropless. The expanded form always attends through
    ``flash_attention`` (K1 at 192/128 on the card, its plain twin on
    the CPU): ``attn_impl`` is "flash" and takes no other value."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    capacity_factor: Optional[float] = None
    moe_period: int = 1
    scoring_func: str = "sigmoid"
    attn_impl: str = "flash"

    def __post_init__(self):
        if not self.dropless:
            raise ValueError("MLA configs route dropless (capacity_factor"
                             " None)")
        if self.attn_impl != "flash":
            raise ValueError("an MLA config attends through flash_attention"
                             f" (attn_impl 'flash'), not {self.attn_impl!r}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """The width of one position's cache entry: c_kv, then k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def project(layer: Dict, x: torch.Tensor, positions: torch.Tensor,
            c: MLAConfig):
    """x (B, S, D) -> (q_nope (B, S, H, dn), roped q_pe (B, S, H, dr),
    the positions' latent entries (B, S, r + dr): [RMSNorm(c_kv) |
    RoPE(k_pe)])."""
    h = _rmsnorm(x, layer["ln1"])
    q = torch.einsum("bsd,dhk->bshk", h, resolve(layer["wq"], h.dtype))
    kva = torch.einsum("bsd,dr->bsr", h, resolve(layer["wkva"], h.dtype))
    r, dn = c.kv_lora_rank, c.qk_nope_head_dim
    c_kv = _rmsnorm(kva[..., :r], layer["kv_norm"])
    k_pe = _rope(kva[..., None, r:], positions, c.rope_theta)[:, :, 0]
    q_pe = _rope(q[..., dn:], positions, c.rope_theta)
    return q[..., :dn], q_pe, torch.cat([c_kv, k_pe], dim=-1)


def expanded_attention(layer: Dict, q_nope, q_pe, latent: torch.Tensor,
                       c: MLAConfig, attn: AttnFn) -> torch.Tensor:
    """Causal attention over the entries ``latent`` (B, S, r + dr) lifted
    to per-head k (dn + dr) and v (dv): (B, S, H, dv)."""
    r, dn = c.kv_lora_rank, c.qk_nope_head_dim
    b, s, h, _ = q_nope.shape
    with attend("expand", b * s):
        kvb = torch.einsum("bsr,rhk->bshk", latent[..., :r],
                           resolve(layer["wkvb"], latent.dtype))
        k_pe = latent[:, :, None, r:].expand(b, s, h, c.qk_rope_head_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([kvb[..., :dn], k_pe], dim=-1)
        return attn(q, k, kvb[..., dn:].contiguous(), causal=True)


def absorb_query(layer: Dict, q_nope, q_pe, c: MLAConfig) -> torch.Tensor:
    """The absorbed query (B, S, H, r + dr): q_nope·W_ukᵀ beside q_pe,
    so that its product with an entry is the expanded score's."""
    w_uk = resolve(layer["wkvb"], q_nope.dtype)[..., :c.qk_nope_head_dim]
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    return torch.cat([q_lat, q_pe], dim=-1)


def absorbed_output(layer: Dict, o_lat: torch.Tensor, c: MLAConfig
                    ) -> torch.Tensor:
    """The heads' outputs (..., H, dv) from their latent outputs
    (..., H, r): o_lat·W_uv."""
    w_uv = resolve(layer["wkvb"], o_lat.dtype)[..., c.qk_nope_head_dim:]
    return torch.einsum("...hr,rhv->...hv", o_lat, w_uv)


def out_proj(layer: Dict, x: torch.Tensor, o: torch.Tensor,
             c: MLAConfig) -> torch.Tensor:
    """The residual after attention: x + o·wo, o (B, S, H, dv)."""
    return x + torch.einsum("bshv,hvd->bsd", o.to(c.dtype),
                            resolve(layer["wo"], c.dtype))


class attend:
    """A ``mla.attend`` span of the thread's tree, if one is open, around
    one layer's attention: ``path`` ``expand`` or ``absorb``,
    ``positions`` the key positions it reads."""

    __slots__ = ("tree", "args")

    def __init__(self, path: str, positions: Optional[int]):
        self.tree = tracing.current_tree()
        self.args = {"path": path, "positions": positions}

    def __enter__(self):
        if self.tree is not None:
            self.tree.begin("mla.attend", **self.args)

    def __exit__(self, *exc):
        if self.tree is not None:
            self.tree.end()
        return False


def forward(params: Dict, tokens: torch.Tensor, config: MLAConfig,
            attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Logits (B, S, vocab) fp32 of the whole model, expanded, no cache."""
    c = config
    attn = _select_attn(c, attn_fn)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = embedding_lookup(params["embed"], tokens, c.dtype)
    for i, layer in enumerate(params["layers"]):
        q_nope, q_pe, latent = project(layer, x, positions, c)
        x = out_proj(layer, x, expanded_attention(layer, q_nope, q_pe,
                                                  latent, c, attn), c)
        x = x + ffn_delta(_rmsnorm(x, layer["ln2"]), layer, i, c)[0]
    return _tied_logits(_rmsnorm(x, params["ln_f"]), params["embed"], c.dtype)
