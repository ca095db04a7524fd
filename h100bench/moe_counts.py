"""The yardstick's arithmetic for the sparse MoE family, from the
configuration file alone (``counts.py``'s conventions).

A token multiplies its layer's attention weights, the router (D × E) and
the ``num_experts_per_tok`` experts it is routed to (three D × F
matrices each); the operations of an MoE forward are ``counts.py``'s
``prompt_flops`` and ``decode_flops`` over these parameters. The bytes a
decode step must read at least are every weight it holds (at 128 rows
every expert of every layer is chosen by some row), and the live K and
V, q in and the output out of ``counts.decode_attention_bytes``.
"""

from __future__ import annotations

from typing import Dict

from h100bench.counts import Dims, decode_attention_bytes


class MoEDims(Dims):
    """:class:`Dims` and the experts (HF ``num_local_experts``,
    ``num_experts_per_tok``)."""

    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        self.experts = cfg["num_local_experts"]
        self.top_k = cfg["num_experts_per_tok"]
        self.bytes = 4 if cfg.get("torch_dtype") == "float32" else 2

    def attn_params(self) -> int:
        return (self.d * self.h * self.hd + 2 * self.d * self.kv * self.hd
                + self.h * self.hd * self.d)

    def expert_params(self) -> int:
        return 3 * self.d * self.f

    def layer_matmul_params(self) -> int:
        """Weights one token multiplies in one layer: attention, the
        router and its ``top_k`` experts."""
        return (self.attn_params() + self.d * self.experts
                + self.top_k * self.expert_params())

    def held_bytes(self) -> int:
        """Every weight the model holds: each layer's attention, all its
        experts and its float32 router, and the embedding (the tied head
        reads all of it)."""
        layer = ((self.attn_params() + self.experts * self.expert_params())
                 * self.bytes + 4 * self.d * self.experts)
        return self.layers * layer + self.vocab * self.d * self.bytes


def decode_floor_bytes(dims: MoEDims, rows: int, keys: int) -> float:
    """Bytes a decode step of ``rows`` rows attending ``keys`` positions
    in all must move at least."""
    return (dims.held_bytes() + decode_attention_bytes(dims, 0) * rows
            + dims.kv_bytes_per_position() * keys)
