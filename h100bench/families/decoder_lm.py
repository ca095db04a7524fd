"""The dense decoder LM family (Mistral) as the program builds it:
``tpu_composer_torch.models.transformer.ModelConfig``."""

from __future__ import annotations

from typing import Dict

from tpu_composer_torch.models.transformer import ModelConfig

from h100bench.counts import Dims
from h100bench.weights import dtype_of


def program_config(cfg: Dict) -> ModelConfig:
    d = Dims(cfg)
    if d.hd * d.h != d.d:
        raise ValueError("the program derives head_dim as hidden/heads")
    if cfg.get("sliding_window"):
        raise ValueError("the program has no sliding window")
    return ModelConfig(vocab_size=d.vocab, d_model=d.d, n_layers=d.layers,
                       n_heads=d.h, n_kv_heads=d.kv, d_ff=d.f,
                       max_seq=int(cfg["max_position_embeddings"]),
                       dtype=dtype_of(cfg), attn_impl="flash",
                       rope_theta=float(cfg["rope_theta"]))
