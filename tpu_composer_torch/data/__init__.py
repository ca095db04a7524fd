"""Input pipeline: deterministic packed-LM batching and the device feed."""

from tpu_composer_torch.data.pipeline import PackedLMDataset, ShardedLoader

__all__ = ["PackedLMDataset", "ShardedLoader"]
