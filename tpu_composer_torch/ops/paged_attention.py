"""Paged decode attention: one query token per row against the block-pooled
KV cache, through the hand-written Hopper kernel ``csrc/paged_decode.cu``.

Port of ``tpu_composer/ops/paged_attention.py``. The contract is the
JAX kernel's: q (B, H, Dh) against pools (N, Bs, KV, Dh), routed by
block_tables (B, MB) int32 and masked by lengths (B,) int32 ->
(B, H, Dh) in q's dtype; a row of length 0 gives zeros; int8 pools take
both fp32 scale pools (N, Bs, KV) or neither.

- On CPU tensors :func:`paged_decode_plain` runs the gather path the
  model's reference read uses (``models/paged._paged_read`` +
  ``models/decode._cached_attention``).
- On CUDA tensors :func:`paged_decode_cuda` launches the kernel, or
  raises.

Numerics: the kernel keeps p in fp32 for P·V, while the gather path
casts probs to the cache dtype first (as the JAX gather path does). In
fp32 the two agree to rounding; in bf16 they differ by up to about one
bf16 ulp of the output, which the bf16 tolerances of the tests and of
``chip_smoke.py`` cover.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_composer_torch.ops import _build

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out;
# B, H, KV, Dh, Bs, MB, q dtype, kv dtype; stream.
_PAGED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths,
                       k_scale=None, v_scale=None):
    """The gather reference: materialize each row's blocks, attend with
    the dense cached-attention math, zero the rows of length 0 (the
    kernel's all-masked-row contract)."""
    from tpu_composer_torch.models.decode import _cached_attention
    from tpu_composer_torch.models.paged import _paged_read
    from tpu_composer_torch.models.transformer import ModelConfig

    b, h, dh = q.shape
    c = ModelConfig(d_model=h * dh, n_heads=h, n_kv_heads=k_pool.shape[2],
                    dtype=q.dtype)
    lengths = lengths.to(torch.int32)
    out = _cached_attention(
        q[:, None], _paged_read(k_pool, block_tables),
        _paged_read(v_pool, block_tables), lengths, c,
        k_scale=None if k_scale is None else _paged_read(k_scale, block_tables),
        v_scale=None if v_scale is None else _paged_read(v_scale, block_tables),
        q_positions=(lengths - 1)[:, None],
    )[:, 0]
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths,
                      k_scale=None, v_scale=None):
    """Launch kernel K2 on contiguous CUDA tensors (the layer view
    ``k_pool[li]``). ``paged_decode_cuda.launches`` counts launches."""
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "lengths": lengths}
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, dh = q.shape
    n, bs, kv, _ = k_pool.shape
    if q.dtype not in _Q_CODE:
        raise TypeError(f"q must be fp32 or bf16, got {q.dtype}")
    if k_pool.dtype not in _KV_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share one of {list(_KV_CODE)}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("int8 pools need k_scale/v_scale; fp pools take none")
    if k_scale is not None:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (n, bs, kv):
                raise ValueError(
                    f"scales must be fp32 {(n, bs, kv)}, got {t.dtype} "
                    f"{tuple(t.shape)}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be int32 ({b}, MB)")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 ({b},)")
    if dh not in (64, 128):
        raise ValueError(f"paged kernel supports head_dim 64 or 128, got {dh}")
    out = torch.empty_like(q)
    paged_decode = _build.load("paged_decode", _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kv, dh, bs, block_tables.shape[1],
            _Q_CODE[q.dtype], _KV_CODE[k_pool.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0


def paged_decode_attention(
    q: torch.Tensor,             # (B, H, Dh)
    k_pool: torch.Tensor,        # (N, Bs, KV, Dh)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MB) int32
    lengths: torch.Tensor,       # (B,) int32
    k_scale: Optional[torch.Tensor] = None,  # (N, Bs, KV) fp32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step of attention over the paged cache -> (B, H, Dh).
    ``k_scale``/``v_scale`` (both or neither) select the int8-pool
    variant."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    b, h, dh = q.shape
    n, bs, kv, dh2 = k_pool.shape
    if dh != dh2:
        raise ValueError(f"head_dim mismatch: q {dh} vs pool {dh2}")
    if h % kv:
        raise ValueError(f"H={h} not a multiple of KV={kv}")
    if q.is_cuda:
        return paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths,
                                 k_scale, v_scale)
    return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths,
                              k_scale, v_scale)
