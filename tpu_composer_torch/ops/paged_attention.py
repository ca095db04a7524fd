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
- On CUDA tensors :func:`paged_decode_cuda` launches the kernel (a
  split pass over chunks of the cache and a merge pass, the geometry
  from :func:`_decode_split`), or raises.
- :func:`paged_decode_split_plain` is the kernel's split-and-merge
  arithmetic in plain PyTorch, for the tests.

Numerics: the kernel keeps p in fp32 for P·V, while the gather path
casts probs to the cache dtype first (as the JAX gather path does). In
fp32 the two agree to rounding; in bf16 they differ by up to about one
bf16 ulp of the output, which the bf16 tolerances of the tests and of
``chip_smoke.py`` cover.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_composer_torch.ops import _build
from tpu_composer_torch.ops.attention import _check_aligned

_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, scratch;
# B, H, KV, Dh, Bs, MB, chunk, n_split, q dtype, kv dtype; stream.
_PAGED_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
# Cache positions per CTA of K2's split pass: the target, and the most
# the kernel takes.
_DECODE_CHUNK = 64
_MAX_CHUNK = 256


def _decode_split(bs: int, mb: int) -> Tuple[int, int]:
    """(chunk, n_split) of K2's split pass: each CTA attends ``chunk``
    cache positions of one (row, KV head), the whole blocks of size ``bs``
    that fit in 64 (64 itself for blocks past 64), and a row's ``mb``
    table slots take n_split = ceil(mb·bs / chunk) CTAs. From shapes
    only: never from the lengths (the wrapper reads nothing back from the
    card) and never from the batch size (a row's sums do not depend on
    which rows share its batch)."""
    chunk = (bs * (_DECODE_CHUNK // bs) if bs <= _DECODE_CHUNK
             else _DECODE_CHUNK)
    return chunk, -(-mb * bs // chunk)


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


def paged_decode_split_plain(q, k_pool, v_pool, block_tables, lengths,
                             k_scale=None, v_scale=None,
                             chunk: Optional[int] = None):
    """K2's split-and-merge arithmetic in plain PyTorch, for the tests.
    The cache positions are cut into chunks of ``chunk`` (default
    :func:`_decode_split`); each chunk's (m, l, acc) is a softmax over its
    positions below the row's length, an empty chunk giving m = -inf and
    l = 0; the partials merge in the order z = 0 … n_split−1 under the
    m_safe / alpha guards of the JAX kernel, and out = acc / max(l,
    1e-30). q, K and V in fp32 and p kept in fp32; int8: the k scale
    multiplies the score after 1/√Dh, the v scale folds into p, l sums
    the unscaled p."""
    from tpu_composer_torch.models.paged import _paged_read

    b, h, dh = q.shape
    _, bs, kv, _ = k_pool.shape
    mb = block_tables.shape[1]
    chunk = _decode_split(bs, mb)[0] if chunk is None else chunk
    n_split = -(-mb * bs // chunk)
    g, pad = h // kv, n_split * chunk - mb * bs

    def read(pool):  # (B, n_split, chunk, KV, ...) fp32, zero-padded
        x = _paged_read(pool, block_tables).float()
        x = torch.cat([x, x.new_zeros((b, pad) + x.shape[2:])], dim=1)
        return x.reshape((b, n_split, chunk) + x.shape[2:])

    s = torch.einsum("bkgd,bzckd->bkgzc", q.float().reshape(b, kv, g, dh),
                     read(k_pool)) * (1.0 / dh ** 0.5)
    if k_scale is not None:
        s = s * read(k_scale).permute(0, 3, 1, 2)[:, :, None]
    n_pos = lengths.long().clamp(0, mb * bs)
    pos = torch.arange(n_split * chunk, device=q.device).reshape(n_split,
                                                                 chunk)
    live = pos[None] < n_pos[:, None, None]                  # (B, z, c)
    s = torch.where(live[:, None, None], s, -torch.inf)
    m = s.amax(-1)                                           # (B, KV, G, z)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    if v_scale is not None:
        p = p * read(v_scale).permute(0, 3, 1, 2)[:, :, None]
    acc = torch.einsum("bkgzc,bzckd->bkgzd", p, read(v_pool))

    m_run = torch.full_like(m[..., 0], -torch.inf)
    l_run = torch.zeros_like(l[..., 0])
    acc_run = torch.zeros_like(acc[..., 0, :])
    for z in range(n_split):
        m_new = torch.maximum(m_run, m[..., z])
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe),
                            0.0)
        beta = torch.where(torch.isfinite(m[..., z]),
                           torch.exp(m[..., z] - m_safe), 0.0)
        l_run = alpha * l_run + beta * l[..., z]
        acc_run = alpha[..., None] * acc_run + beta[..., None] * acc[..., z, :]
        m_run = m_new
    out = acc_run / l_run.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths,
                      k_scale=None, v_scale=None,
                      chunk: Optional[int] = None):
    """Launch kernel K2 on contiguous CUDA tensors (the layer view
    ``k_pool[li]``): the split pass over chunks of ``chunk`` cache
    positions (1 to 256; default :func:`_decode_split`) into an fp32
    scratch buffer, then the merge
    pass. Reads nothing back from the card.
    ``paged_decode_cuda.launches`` counts calls on fp pools and
    ``paged_decode_cuda.launches_int8`` those on int8 pools (two kernels
    a call)."""
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
    mb = block_tables.shape[1]
    chunk = _decode_split(bs, mb)[0] if chunk is None else chunk
    if not 1 <= chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must be 1 to {_MAX_CHUNK}, got {chunk}")
    n_split = -(-mb * bs // chunk)
    _check_aligned(k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    scratch = torch.empty(b * h * n_split * (dh + 2), dtype=torch.float32,
                          device=q.device)
    paged_decode = _build.load("paged_decode", _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, kv, dh, bs, mb, chunk, n_split,
            _Q_CODE[q.dtype], _KV_CODE[k_pool.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    if k_scale is None:
        paged_decode_cuda.launches += 1
    else:
        paged_decode_cuda.launches_int8 += 1
    return out


paged_decode_cuda.launches = 0
paged_decode_cuda.launches_int8 = 0


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
