"""The sparse MoE decoder family (Mixtral) as the program builds it:
``tpu_composer_torch.models.moe.MoEConfig``, every layer sparse, routed
without a capacity (no token dropped)."""

from __future__ import annotations

from typing import Dict

from tpu_composer_torch.models.moe import MoEConfig

from h100bench.moe_counts import MoEDims
from h100bench.weights import dtype_of


def program_config(cfg: Dict) -> MoEConfig:
    d = MoEDims(cfg)
    if d.hd * d.h != d.d:
        raise ValueError("the program derives head_dim as hidden/heads")
    if cfg.get("sliding_window"):
        raise ValueError("the program has no sliding window")
    if not hasattr(MoEConfig, "dropless"):
        raise SystemExit("the program routes MoE layers only with a "
                         "capacity, which may drop tokens; this family "
                         "routes every token")
    return MoEConfig(vocab_size=d.vocab, d_model=d.d, n_layers=d.layers,
                     n_heads=d.h, n_kv_heads=d.kv, d_ff=d.f,
                     max_seq=int(cfg["max_position_embeddings"]),
                     dtype=dtype_of(cfg), attn_impl="flash",
                     rope_theta=float(cfg["rope_theta"]),
                     n_experts=d.experts, top_k=d.top_k,
                     capacity_factor=None, moe_period=1)
