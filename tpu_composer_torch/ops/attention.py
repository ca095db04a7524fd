"""Multi-head attention: reference einsum path and flash attention
(forward) through the hand-written Hopper kernel ``csrc/flash_fwd.cu``.

Port of ``tpu_composer/ops/attention.py``, forward half. Shapes keep the
JAX package's layout: q (B, S, H, D), k/v (B, S, KV, D) with KV dividing
H; grouped K/V heads are fanned in by the kernel, never repeated in
memory. The flash entry points validate block sizes exactly as the JAX
ones do (same inputs, same ``ValueError``), then

- on CPU tensors run :func:`flash_fwd_plain`, the kernel's arithmetic in
  plain PyTorch;
- on CUDA tensors launch the kernel through :func:`flash_fwd_cuda`, or
  raise. There is no fallback from one to the other.

The backward kernels (dQ, dK/dV) belong to the training slice: on CUDA
tensors that require grad the entry points raise ``NotImplementedError``
rather than return a result with no gradient path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_composer_torch.ops import _build

NEG_INF = -1e30

# The JAX package's block defaults. They are TPU tuning and the kernel
# picks its own tile; they stay only so that the block validation below
# accepts and rejects exactly the inputs the JAX entry points do.
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512


def repeat_kv(q, k, v):
    """Broadcast grouped K/V heads up to the query head count (the
    reference path's GQA; the flash kernel never calls this)."""
    h, hk = q.shape[2], k.shape[2]
    if h == hk:
        return k, v
    if h % hk:
        raise ValueError(f"kv heads {hk} must divide query heads {h}")
    g = h // hk
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def mha_reference(q, k, v, causal: bool = False):
    """Plain attention. q (B, S, H, D), k/v (B, S, H or KV, D) ->
    (B, S, H, D). Scores in the input dtype, then fp32 softmax; probs are
    cast to the q dtype before P·V (as the JAX reference does)."""
    k, v = repeat_kv(q, k, v)
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(qi >= ki, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def flash_fwd_plain(q, k, v, causal: bool = False, with_lse: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The flash kernel's arithmetic in one pass: S = Q·Kᵀ in fp32 from
    input-dtype operands, times 1/√D on the logits; causal keeps row >=
    col in absolute positions and fills -1e30; P is cast to the V dtype
    before P·V; out = acc / max(l, 1e-30) and lse = m + log(max(l,
    1e-30)), (B, H, S) fp32."""
    k, v = repeat_kv(q, k, v)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d ** 0.5)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # (B, H, S, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.transpose(1, 2)).to(q.dtype)
    lse = (m + torch.log(l))[..., 0] if with_lse else None
    return out, lse


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# q, k, v, out, lse; B, Sq, Sk, H, KV, D, causal, dtype; stream.
_FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def flash_fwd_cuda(q, k, v, causal: bool = False, with_lse: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel K1 (``csrc/flash_fwd.cu``) on contiguous CUDA
    tensors q (B, Sq, H, D), k/v (B, Sk, KV, D) of one dtype (fp32 or
    bf16), D in {64, 128}. Returns (out (B, Sq, H, D), lse (B, H, Sq) fp32
    or None). ``flash_fwd_cuda.launches`` counts launches."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes fp32 or bf16, got {q.dtype}")
    b, sq, h, d = q.shape
    bk, sk, kv, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}"
            f" v {tuple(v.shape)}")
    if h % kv:
        raise ValueError(f"kv heads {kv} must divide query heads {h}")
    if d not in (64, 128):
        raise ValueError(f"flash kernel supports head_dim 64 or 128, got {d}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    flash_fwd = _build.load("flash_fwd", _FLASH_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, sq, sk, h, kv, d, int(causal), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


def _fit_block(explicit: Optional[int], s: int, default: int) -> int:
    """Resolve a block size against sequence length ``s`` exactly as the
    JAX package does: explicit sizes are clamped to ``s`` and must divide
    it; defaults halve until they divide."""
    if explicit is not None:
        b = min(explicit, s)
        if s % b:
            raise ValueError(f"block {b} must divide seq length {s}")
        return b
    b = min(default, s)
    while b > 8 and s % b:
        b //= 2
    if s % b:
        raise ValueError(
            f"seq length {s} has no power-of-two-friendly block <= {default};"
            " pass explicit block_q/block_k that divide it"
        )
    return b


def _flash_prep(q, k, block_q, block_k) -> None:
    """The JAX entry points' validation, for contract parity: the kernel
    masks ragged tiles itself and needs none of it."""
    sq, h = q.shape[1], q.shape[2]
    sk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(f"kv heads {hk} must divide query heads {h}")
    explicit_q = block_q is not None
    block_q = _fit_block(block_q, sq, DEFAULT_BLOCK_Q)
    _fit_block(block_k, sk, DEFAULT_BLOCK_K)
    while not explicit_q and block_q > 128 and block_q % 128:
        block_q //= 2
    if block_q > 128 and block_q % 128:
        raise ValueError(f"block_q {block_q} > 128 must be a multiple of 128")


def _flash(q, k, v, causal, block_q, block_k, with_lse):
    _flash_prep(q, k, block_q, block_k)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, with_lse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention on CUDA is forward-only: the dQ/dKV kernels"
            " come with the training slice"
        )
    return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, with_lse)


def flash_attention(q, k, v, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """FlashAttention forward. q (B, S, H, D), k/v (B, S, KV, D) ->
    (B, S, H, D), KV any divisor of H."""
    return _flash(q, k, v, causal, block_q, block_k, with_lse=False)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None):
    """flash_attention that also returns the per-row logsumexp (B, H, S)
    fp32."""
    return _flash(q, k, v, causal, block_q, block_k, with_lse=True)
