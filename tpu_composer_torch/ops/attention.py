"""Multi-head attention: reference einsum path and flash attention,
forward and backward, through the hand-written Hopper kernels
``csrc/flash_fwd.cu`` (K1) and ``csrc/flash_bwd.cu`` (B3 dQ, B4 dK/dV).

Port of ``tpu_composer/ops/attention.py``. Shapes keep the JAX package's
layout: q (B, S, H, D), k/v (B, S, KV, D) with KV dividing H; grouped
K/V heads are fanned in by the kernels, never repeated in memory. The
flash entry points validate block sizes exactly as the JAX ones do (same
inputs, same ``ValueError``), then

- without a gradient to record: on CPU tensors run
  :func:`flash_fwd_plain`, the kernel's arithmetic in plain PyTorch; on
  CUDA tensors launch K1 through :func:`flash_fwd_cuda`, or raise;
- when autograd records (an input requires grad): go through
  :class:`FlashAttention`, the counterpart of JAX's ``_flash_core`` and
  ``_flash_core_lse`` custom VJPs. Its forward is K1 with lse; its
  backward computes δ in PyTorch and then launches B3 and B4
  (:func:`flash_bwd_cuda`). On CPU tensors the same Function runs
  :func:`flash_fwd_plain` and :func:`flash_bwd_plain`, so the CPU tests
  exercise the custom backward that runs on the card.

There is no fallback from a kernel to its plain version.
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
# q, k, v, out, lse; B, Sq, Sk, H, KV, D, causal, dtype, rows; stream.
_FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# Streaming multiprocessors of one H100 SXM: the grid size the bf16
# kernels' geometry rules aim to fill.
_SMS = 132


def _fwd_rows(b: int, h: int, sq: int) -> int:
    """Query rows per CTA of K1's bf16 kernel: 64 (a warp per 16 rows)
    when that grid still has a CTA for every SM, else 16 (the CTA's four
    warps split the keys), so that a short prefill spreads over the
    card."""
    return 64 if b * h * -(-sq // 64) >= _SMS else 16


def _dkv_split(b: int, kv: int, g: int, sk: int) -> int:
    """CTAs along the GQA group of B4's bf16 kernel: the smallest divisor
    of the group size ``g`` that gives four CTAs for every SM, else the
    whole group. 1 for MHA."""
    ctas = b * kv * -(-sk // 64)
    for split in range(1, g + 1):
        if g % split == 0 and ctas * split >= 4 * _SMS:
            return split
    return g


def _check_aligned(**tensors) -> None:
    """The bf16 kernels copy 16-byte chunks (cp.async)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the bf16"
                             " kernel")


def flash_fwd_cuda(q, k, v, causal: bool = False, with_lse: bool = False,
                   rows: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel K1 (``csrc/flash_fwd.cu``) on contiguous CUDA
    tensors q (B, Sq, H, D), k/v (B, Sk, KV, D) of one dtype (fp32 or
    bf16), D in {64, 128}. Returns (out (B, Sq, H, D), lse (B, H, Sq) fp32
    or None). ``rows`` is the bf16 kernel's query rows per CTA, 16 or 64
    (default :func:`_fwd_rows`); the fp32 kernel always takes 32.
    ``flash_fwd_cuda.launches`` counts launches without lse (the serving
    prefill), ``flash_fwd_cuda.launches_lse`` those with it (the training
    forward)."""
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
    rows = _fwd_rows(b, h, sq) if rows is None else rows
    if rows not in (16, 64):
        raise ValueError(f"rows must be 16 or 64, got {rows}")
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    flash_fwd = _build.load("flash_fwd", _FLASH_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, sq, sk, h, kv, d, int(causal), _DTYPE_CODE[q.dtype], rows,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    if with_lse:
        flash_fwd_cuda.launches_lse += 1
    else:
        flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.launches_lse = 0


def flash_bwd_plain(q, k, v, out, lse, do, g_lse=None, causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in one pass, returning (dq, dk,
    dv) in the dtypes of q, k, v. P = exp(S·scale − lse) in fp32 with the
    −1e30 causal fill; dP = dO·Vᵀ; δ = rowsum(dO∘O) in fp32, minus
    ``g_lse`` (the lse cotangent, (B, H, Sq)) when given; dS = P∘(dP − δ)
    cast to the input dtype before dS·K and dSᵀ·Q; P cast to dO's dtype
    before Pᵀ·dO; dq and dk × 1/√D at the end, dv unscaled. dk and dv are
    summed over each GQA group, at KV-head width."""
    b, sk, kvh, d = k.shape
    group = q.shape[2] // kvh
    kr, vr = repeat_kv(q, k, v)
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    if causal:
        sq = s.shape[-2]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    delta = _delta(out, do, g_lse)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = dk.reshape(b, sk, kvh, group, d).sum(3)
    dv = dv.reshape(b, sk, kvh, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do, g_lse=None):
    """δ = rowsum(dO∘O) in fp32 as (B, H, Sq), minus the lse cotangent when
    lse is differentiated: dL/dlse enters dS as +P·g_lse, so the kernels'
    dS = P∘(dP − δ) absorbs it as δ − g_lse (attention.py:380-384)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


# q, k, v, dout, lse, delta, dq; B, Sq, Sk, H, KV, D, causal, dtype; stream.
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# q, k, v, dout, lse, delta, dk, dv, scratch; B, Sq, Sk, H, KV, D, causal,
# dtype, split; stream.
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _check_bwd(q, k, v, do, lse, delta) -> None:
    """The backward kernels' input contract; raises on what they do not
    take."""
    for name, t, shape in (("q", q, q.shape), ("do", do, q.shape),
                           ("k", k, k.shape), ("v", v, k.shape)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take fp32 or bf16, got {q.dtype}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash kernels support head_dim 64 or 128, got {d}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"{name} must be contiguous fp32 (B, H, Sq) on {q.device}")


def _dims(q, k, causal):
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    return (b, sq, sk, h, kv, d, int(causal), _DTYPE_CODE[q.dtype])


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool = False):
    """Launch kernel B3 (``csrc/flash_bwd.cu``, dQ): q/do (B, Sq, H, D),
    k/v (B, Sk, KV, D), lse and δ (B, H, Sq) fp32, all contiguous on one
    card. Returns dq like q. ``flash_bwd_dq_cuda.launches`` counts
    launches."""
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _build.load("flash_bwd", _DQ_ARGTYPES, symbol="flash_bwd_dq")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                *_dims(q, k, causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: CUDA error {rc}")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool = False,
                       split: Optional[int] = None):
    """Launch kernel B4 (``csrc/flash_bwd.cu``, dK/dV) on the inputs of
    :func:`flash_bwd_dq_cuda`. Returns (dk, dv) like k and v, summed over
    each GQA group. ``split`` is the bf16 kernel's CTAs along the group,
    dividing H/KV (default :func:`_dkv_split`); above 1 the partial sums
    go through an fp32 scratch buffer and a second, reducing kernel. The
    fp32 kernel sums the whole group in one CTA (split 1).
    ``flash_bwd_dkv_cuda.launches`` counts calls (one or both kernels)."""
    _check_bwd(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        _check_aligned(q=q, k=k, v=v, do=do)
        split = _dkv_split(b, kv, h // kv, sk) if split is None else split
        if split < 1 or (h // kv) % split:
            raise ValueError(
                f"split {split} must divide the GQA group {h // kv}")
    elif split not in (None, 1):
        raise ValueError("split applies to the bf16 kernel only")
    else:
        split = 1
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    scratch = (torch.empty((2, b, sk, kv, split, d), dtype=torch.float32,
                           device=q.device) if split > 1 else None)
    fn = _build.load("flash_bwd", _DKV_ARGTYPES, symbol="flash_bwd_dkv")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                *_dims(q, k, causal), split,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: CUDA error {rc}")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_cuda(q, k, v, out, lse, do, g_lse=None, causal: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward on the card: δ in PyTorch (as JAX computes it in
    XLA outside Pallas), then B3 and B4. Same arguments and results as
    :func:`flash_bwd_plain`."""
    do = do.to(q.dtype).contiguous()
    delta = _delta(out, do, g_lse)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward, returning (out, lse) with
    both outputs differentiable: the counterpart of JAX's ``_flash_core``
    and ``_flash_core_lse`` custom VJPs (``_flash_core`` differs only in
    its primal, which here is the no-grad path of :func:`_flash`).
    Forward: K1 with lse, saving q, k, v, out, lse. Backward: δ in
    PyTorch, then B3 and B4. A cotangent that does not reach the loss
    arrives as ``None``: a missing lse cotangent leaves δ as it is, a
    missing output cotangent is zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.is_cuda:
            out, lse = flash_fwd_cuda(q, k, v, causal, with_lse=True)
        else:
            out, lse = flash_fwd_plain(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:  # only lse reaches the loss
            g_out = torch.zeros_like(out)
        bwd = flash_bwd_cuda if q.is_cuda else flash_bwd_plain
        return (*bwd(q, k, v, out, lse, g_out, g_lse, ctx.causal), None)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, with_lse)
    return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, with_lse)


def flash_attention(q, k, v, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """FlashAttention, differentiable through the flash backward. q (B, S,
    H, D), k/v (B, S, KV, D) -> (B, S, H, D), KV any divisor of H."""
    return _flash(q, k, v, causal, block_q, block_k, with_lse=False)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None):
    """flash_attention that also returns the per-row logsumexp (B, H, S)
    fp32, differentiable through both outputs."""
    return _flash(q, k, v, causal, block_q, block_k, with_lse=True)
