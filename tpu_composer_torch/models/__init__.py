"""Transformer, KV-cached decoding, paged cache and the serving engine."""
