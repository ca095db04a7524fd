"""The latent-attention MoE family (DeepSeek-V3's block, Moonlight) as
the program builds it: ``tpu_composer_torch.models.mla.MLAConfig``,
routed without a capacity (no token dropped). A program without latent
attention fails here, at its import, before any weight is made."""

from __future__ import annotations

from typing import Dict

from tpu_composer_torch.models.mla import MLAConfig

from h100bench.mla_counts import MLADims
from h100bench.weights import dtype_of


def program_config(cfg: Dict) -> MLAConfig:
    d = MLADims(cfg)
    if cfg.get("q_lora_rank") is not None:
        raise ValueError("the program projects q without a low-rank step")
    if (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"],
            cfg["topk_group"], cfg["norm_topk_prob"], cfg["moe_layer_freq"]
            ) != ("sigmoid", "noaux_tc", 1, 1, True, 1):
        raise ValueError("the program routes by sigmoid scores over one "
                         "group, gates normalised, every layer past the "
                         "dense ones sparse")
    if cfg.get("rope_scaling"):
        raise ValueError("the program has no rope scaling")
    return MLAConfig(vocab_size=d.vocab, d_model=d.d, n_layers=d.layers,
                     n_heads=d.h, d_ff=d.f_dense,
                     max_seq=int(cfg["max_position_embeddings"]),
                     dtype=dtype_of(cfg), attn_impl="flash",
                     rope_theta=float(cfg["rope_theta"]),
                     n_experts=d.experts, top_k=d.top_k,
                     first_k_dense_replace=d.dense_layers,
                     n_shared_experts=d.shared,
                     routed_scaling_factor=float(cfg["routed_scaling_factor"]),
                     kv_lora_rank=d.rank, qk_nope_head_dim=d.nope,
                     qk_rope_head_dim=d.rope)
