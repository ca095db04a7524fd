"""The yardstick's arithmetic: operations and bytes from a configuration's
published widths, and the chip's peaks.

Every count here is written from the configuration file alone (the keys
of the source's ``config.json``), never from the program, so it is the
same whatever kernel does the work. Conventions:

- a multiply-add is 2 operations;
- the matmul parameters of a token are every weight it multiplies:
  q, k and v at their own head counts (k and v at ``num_key_value_heads``),
  the output projection, the SwiGLU FFN (three matrices) and the output
  head. The embedding lookup is a gather, not a
  matmul, and is not counted;
- attention is 4 · heads · head_dim operations per (query, key) pair
  (q·k and p·v), over the keys a query may see (causal: itself and the
  positions before it); padding is never counted.
"""

from __future__ import annotations

from typing import Dict, Optional

# Dense, non-sparse peaks of the cards this benchmark runs on, from
# NVIDIA's H100 data sheet (SXM5 part at its 700 W limit): bf16 tensor
# core FLOP/s and HBM3 bytes/s. Keyed by the start of
# torch.cuda.get_device_name(); the most specific key wins.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bf16_flops": 756e12, "hbm_bytes_s": 2.0e12},
    "NVIDIA H100 NVL": {"bf16_flops": 835e12, "hbm_bytes_s": 3.9e12},
}

def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peak row whose key starts ``device_name``, longest first; None
    for a card the table does not hold (no roofline is then reported)."""
    for key in sorted(PEAKS, key=len, reverse=True):
        if device_name.startswith(key):
            return PEAKS[key]
    return None


class Dims:
    """The widths of one configuration file (HF ``config.json`` keys)."""

    def __init__(self, cfg: Dict):
        self.d = cfg["hidden_size"]
        self.f = cfg["intermediate_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg.get("num_key_value_heads") or self.h
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.layers = cfg["num_hidden_layers"]
        self.vocab = cfg["vocab_size"]

    def layer_matmul_params(self) -> int:
        """Weights one token multiplies in one layer."""
        attn = (self.d * self.h * self.hd + 2 * self.d * self.kv * self.hd
                + self.h * self.hd * self.d)
        return attn + 3 * self.d * self.f

    def matmul_params(self) -> int:
        """Weights one token multiplies in the whole model, head included."""
        return self.layers * self.layer_matmul_params() + self.vocab * self.d

    def attn_pair_flops(self) -> int:
        """Attention operations per (query, key) pair, all layers."""
        return 4 * self.h * self.hd * self.layers

    def kv_bytes_per_position(self) -> int:
        """Bytes of K and V one position holds in bf16, all layers."""
        return 2 * self.kv * self.hd * 2 * self.layers


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal prompt of n tokens."""
    return n * (n + 1) // 2


def prompt_flops(dims: Dims, n: int) -> float:
    """Forward operations of an n-token causal prompt."""
    return 2.0 * dims.matmul_params() * n + dims.attn_pair_flops() * causal_pairs(n)


def decode_flops(dims: Dims, keys: int) -> float:
    """Forward operations of one generated token that attends ``keys``
    positions (the cache and itself)."""
    return 2.0 * dims.matmul_params() + dims.attn_pair_flops() * keys


def decode_attention_bytes(dims: Dims, keys: int) -> float:
    """Bytes the decode attention of one row must move, all layers: the live
    K and V it reads once, q in and the output out (bf16)."""
    return float(dims.kv_bytes_per_position() * keys
                 + 2 * dims.h * dims.hd * 2 * dims.layers)
