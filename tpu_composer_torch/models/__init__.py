"""Transformer (dense and MoE), KV-cached decoding, the paged cache,
speculative decoding and the serving engine."""

from tpu_composer_torch.models.moe import MoEConfig
from tpu_composer_torch.models.transformer import ModelConfig

__all__ = ["ModelConfig", "MoEConfig"]
