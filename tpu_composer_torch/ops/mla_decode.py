"""Latent (MLA) paged decode attention: each row's heads query one stream
of latent entries through the hand-written Hopper kernel
``csrc/mla_decode.cu`` (K3). The JAX package has no counterpart.

Contract: q (B, H, L) against one layer's latent pool (N, Bs, L), routed
by block_tables (B, MB) int32 and masked by lengths (B,) int32, scores
over all L dims times ``scale``, values the first ``v_dim`` dims of the
same entries -> (B, H, v_dim) in q's dtype; a row of length 0 gives
zeros. In the model (``models/mla.py``) L = kv_lora_rank + rope width
(576), v_dim = kv_lora_rank (512), H = 16 and scale = 1/√(nope + rope).

- On CPU tensors :func:`mla_decode_plain` gathers each row's entries and
  attends with plain PyTorch, in the kernel's arithmetic: scores and
  softmax in fp32, P rounded to the pool's dtype before P·V, l summing
  the unrounded P.
- On CUDA tensors :func:`mla_decode_cuda` launches the kernel (a split
  pass over chunks of the cache, the geometry from :func:`_mla_split`,
  and a merge pass), or raises. It reads nothing back from the card, so
  a decode step that calls it can be captured in a CUDA graph.

The kernel rounds P at each tile's running max and the twin at the
row's; in bf16 the two differ by about one bf16 ulp of the output.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_composer_torch.ops import _build
from tpu_composer_torch.ops.attention import _check_aligned

# q, pool, tables, lengths, out, scratch; B, Bs, MB, chunk, n_split;
# scale; stream.
_MLA_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_void_p])
# The kernel's fixed widths: heads, entry width, value width.
_HEADS, _WIDTH, _V_DIM = 16, 576, 512
# Cache positions per split CTA: the target, its granule (the kernel's
# tile) and the most the kernel takes.
_CHUNK = 512
_TILE = 32
_MAX_CHUNK = 4096


def _mla_split(bs: int, mb: int) -> Tuple[int, int]:
    """(chunk, n_split) of K3's split pass: each CTA attends up to
    ``chunk`` = 512 cache positions of one row for all its heads, and a
    row's ``mb`` table slots of ``bs`` positions take n_split =
    ceil(mb·bs / chunk) CTAs. From shapes only: never from the lengths
    (no host read) and never from the batch size."""
    return _CHUNK, -(-mb * bs // _CHUNK)


def mla_decode_plain(q, pool, block_tables, lengths, scale: float,
                     v_dim: int):
    """The gather twin: each row's entries in table order, masked at its
    length, attended in the kernel's arithmetic."""
    b, mb = block_tables.shape
    ent = pool[block_tables.reshape(-1).long()].reshape(b, -1, pool.shape[-1])
    s = torch.einsum("bhl,btl->bht", q.float(), ent.float()) * scale
    live = (torch.arange(ent.shape[1], device=q.device)[None, :]
            < lengths.long()[:, None])
    s = torch.where(live[:, None], s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bht,btr->bhr", p.to(pool.dtype).float(),
                       ent[..., :v_dim].float())
    return (acc / l).to(q.dtype)


def mla_decode_cuda(q, pool, block_tables, lengths, scale: float,
                    chunk: Optional[int] = None):
    """Launch K3 on contiguous bf16 CUDA tensors q (B, 16, 576) and a
    layer's pool (N, Bs, 576): the split pass over chunks of ``chunk``
    positions (a multiple of 32 up to 4096; default :func:`_mla_split`)
    into an fp32 scratch buffer, then the merge pass. Returns (B, 16,
    512) bf16. ``mla_decode_cuda.launches`` counts the calls (two
    kernels a call)."""
    tensors = {"q": q, "pool": pool, "block_tables": block_tables,
               "lengths": lengths}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b = q.shape[0]
    if q.dtype != torch.bfloat16 or pool.dtype != torch.bfloat16:
        raise TypeError(f"K3 takes bf16 q and pool, got {q.dtype}/"
                        f"{pool.dtype}")
    if q.shape[1:] != (_HEADS, _WIDTH) or pool.dim() != 3 \
            or pool.shape[2] != _WIDTH:
        raise ValueError(f"K3 takes q (B, {_HEADS}, {_WIDTH}) and a pool "
                         f"(N, Bs, {_WIDTH}), got {tuple(q.shape)} and "
                         f"{tuple(pool.shape)}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be int32 ({b}, MB)")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 ({b},)")
    bs, mb = pool.shape[1], block_tables.shape[1]
    chunk = _mla_split(bs, mb)[0] if chunk is None else chunk
    if not (_TILE <= chunk <= _MAX_CHUNK and chunk % _TILE == 0):
        raise ValueError(f"chunk must be a multiple of {_TILE} up to "
                         f"{_MAX_CHUNK}, got {chunk}")
    n_split = -(-mb * bs // chunk)
    _check_aligned(q=q, pool=pool)
    out = torch.empty((b, _HEADS, _V_DIM), dtype=q.dtype, device=q.device)
    scratch = torch.empty(b * _HEADS * n_split * (_V_DIM + 2),
                          dtype=torch.float32, device=q.device)
    fn = _build.load("mla_decode", _MLA_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), pool.data_ptr(), block_tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
                bs, mb, chunk, n_split, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode launch failed: CUDA error {rc}")
    mla_decode_cuda.launches += 1
    return out


mla_decode_cuda.launches = 0


def mla_decode_attention(q, pool, block_tables, lengths, scale: float,
                         v_dim: int):
    """One decode step of latent attention over one layer's pool ->
    (B, H, v_dim): the kernel on CUDA tensors (v_dim 512), the twin on
    CPU ones."""
    if q.is_cuda:
        if v_dim != _V_DIM:
            raise ValueError(f"K3 reads values {_V_DIM} wide, not {v_dim}")
        return mla_decode_cuda(q, pool, block_tables, lengths, scale)
    return mla_decode_plain(q, pool, block_tables, lengths, scale, v_dim)
