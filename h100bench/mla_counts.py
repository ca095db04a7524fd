"""The yardstick's arithmetic for the latent-attention MoE family
(DeepSeek-V3's block, Moonlight-16B-A3B), from the configuration file
alone (``counts.py``'s conventions). ``counts.Dims`` derives a head's
width as hidden / heads, which latent attention does not have, so the
readers of this family count here.

- The matmul parameters a token multiplies, per layer: W_q, W_kva, W_kvb
  and W_o of the attention, then either the leading dense layers'
  SwiGLU FFN, or the router (D × E), the ``num_experts_per_tok`` chosen
  experts and the shared experts (three D × F matrices each, F the
  expert width); the tied head. The embedding lookup is a gather.
- Attention: 2·H·(qk + v) operations per (query, key) pair and layer,
  qk = nope + rope and v the value width: the expanded (non-absorbed)
  form, whatever form runs.
- Bytes a decode step must read at least: every weight the model holds
  (at 128 rows every routed expert of every layer is chosen by some row),
  the live latent entries (kv_lora_rank + rope values a position and
  layer), and each row's absorbed query in and latent output out.
"""

from __future__ import annotations

from typing import Dict


class MLADims:
    """The widths of one configuration file (HF ``config.json`` keys of
    ``deepseek_v3``)."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.layers = cfg["num_hidden_layers"]
        self.vocab = cfg["vocab_size"]
        self.dense_layers = cfg["first_k_dense_replace"]
        self.f_dense = cfg["intermediate_size"]
        self.f = cfg["moe_intermediate_size"]
        self.experts = cfg["n_routed_experts"]
        self.top_k = cfg["num_experts_per_tok"]
        self.shared = cfg["n_shared_experts"]
        self.rank = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope = cfg["qk_rope_head_dim"]
        self.v = cfg["v_head_dim"]
        self.bytes = 4 if cfg.get("torch_dtype") == "float32" else 2

    @property
    def qk(self) -> int:
        return self.nope + self.rope

    @property
    def latent(self) -> int:
        """Values one position's cache entry holds per layer."""
        return self.rank + self.rope

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    def attn_params(self) -> int:
        """W_q, W_kva, W_kvb, W_o."""
        return (self.d * self.h * self.qk + self.d * self.latent
                + self.rank * self.h * (self.nope + self.v)
                + self.h * self.v * self.d)

    def token_params(self) -> int:
        """Weights one token multiplies in the whole model, head included:
        each layer's attention, the dense FFN or the router with the
        chosen and the shared experts, and the tied head."""
        moe = (self.d * self.experts
               + (self.top_k + self.shared) * 3 * self.d * self.f)
        return (self.layers * self.attn_params()
                + self.dense_layers * 3 * self.d * self.f_dense
                + self.moe_layers * moe + self.vocab * self.d)

    def params(self) -> int:
        """Every parameter the model holds, the head tied: attention,
        norms, the dense FFN, every routed and shared expert, the routers
        and their selection biases, the embedding."""
        norms = 2 * self.d + self.rank
        moe = ((self.experts + self.shared) * 3 * self.d * self.f
               + self.d * self.experts + self.experts)
        return (self.layers * (self.attn_params() + norms)
                + self.dense_layers * 3 * self.d * self.f_dense
                + self.moe_layers * moe + self.vocab * self.d + self.d)

    def held_bytes(self) -> int:
        """Bytes of every held weight: matrices in the configuration's
        dtype; norms, routers and their biases in float32."""
        fp32 = (self.layers * (2 * self.d + self.rank) + self.d
                + self.moe_layers * (self.d * self.experts + self.experts))
        return (self.params() - fp32) * self.bytes + 4 * fp32

    def pair_flops(self) -> int:
        """Attention operations per (query, key) pair, all layers."""
        return 2 * self.h * (self.qk + self.v) * self.layers

    def latent_bytes_per_position(self) -> int:
        """Bytes of latent one position holds, all layers."""
        return self.latent * self.bytes * self.layers

    def row_io_bytes(self) -> int:
        """One decoded row's absorbed query in and latent output out, all
        layers."""
        return self.h * (self.latent + self.rank) * self.bytes * self.layers


def prompt_flops(d: MLADims, n: int) -> float:
    """Forward operations of an n-token causal prompt."""
    return 2.0 * d.token_params() * n + d.pair_flops() * n * (n + 1) // 2


def decode_floor_bytes(d: MLADims, rows: int, keys: int) -> float:
    """Bytes a decode step of ``rows`` rows reading ``keys`` latent
    positions in all must move at least."""
    return (d.held_bytes() + d.row_io_bytes() * rows
            + d.latent_bytes_per_position() * keys)
