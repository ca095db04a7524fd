"""Ring attention over a mesh dim (port of
``tpu_composer/parallel/ring_attention.py``).

Each rank holds a Q/K/V shard of the sequence, (B, S_local, H, D), the
global sequence being the shards in rank order along ``dim``. K/V chunks
rotate around the ring (:func:`collectives.ring_shift`) while the
online-softmax state (running max, normaliser, accumulator) gathers
locally in fp32; after n steps every query shard has seen the whole
sequence while holding 1/n of K/V.

``inner`` picks the per-block attention: ``"einsum"`` (matmuls in the
input dtype with fp32 accumulation, grouped K/V repeated before the
ring) or ``"flash"`` (the flash kernels: K1 with lse forward, B3 and B4
backward, through ``ops.attention.FlashAttention``; each block's
(out, lse) merges into the running state, so the merge sends B3 and B4
a nonzero lse cotangent, and grouped K/V rotate unrepeated).

Each rank is its own process, so a causal rank skips the blocks of
sources ahead of it with a Python ``if``; every rank still calls
``ring_shift`` on every step, outside the branch, or the ring would
deadlock. The backward has the same need: autograd runs a shift's
transpose only where the shifted chunk reaches the loss, so a rank that
skips a chunk keeps it in the graph with a zero cotangent
(:func:`collectives.tie`), and every rank runs every reverse shift, in
the same order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.ops.attention import (
    NEG_INF,
    flash_attention_with_lse,
    repeat_kv,
)
from tpu_composer_torch.parallel.collectives import (
    ppermute,
    ring_shift,
    tie,
)
from tpu_composer_torch.parallel.mesh import axis_index, axis_size


def _check_inner(inner: str) -> None:
    if inner not in ("einsum", "flash"):
        raise ValueError(f"unknown ring inner {inner!r} (einsum|flash)")


def _skip(state, *chunks):
    """The online-softmax state unchanged, with ``chunks`` tied to its
    accumulator (which always reaches the output; the running max may
    not)."""
    m, l, acc = state
    return m, l, tie(acc, *chunks)


def _zeros(q: torch.Tensor):
    """The empty online-softmax state for queries ``q`` (B, S, H, D):
    running max and normaliser (B, H, S, 1), accumulator (B, S, H, D),
    all fp32."""
    b, s, h, d = q.shape
    return (torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device),
            torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device))


def _flash_block_update(q, k, v, m, l, acc, causal_block: bool):
    """Flash-inner block update: the kernel attends this query shard to
    one K/V chunk and returns (out_i, lse_i); for a whole block
    exp(lse_i − m) is its normaliser's share and out_i·exp(lse_i − m)
    its accumulator's, merged with the usual rescale."""
    out_i, lse_i = flash_attention_with_lse(q, k, v, causal=causal_block)
    lse_col = lse_i[..., None]  # (B, H, S, 1)
    m_new = torch.maximum(m, lse_col)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_col - m_new)
    l_new = l * alpha + w
    acc_new = (acc * alpha.transpose(1, 2)
               + out_i.float() * w.transpose(1, 2))
    return m_new, l_new, acc_new


def _block_update(q, k, v, m, l, acc, scale, mask=None):
    """One online-softmax block update of the einsum inner: scores from
    input-dtype operands accumulated in fp32, times ``scale``; an
    optional boolean mask (True = keep) fills −1e30; the running-max
    rescale and P·V with P cast to V's dtype, accumulated in fp32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    acc_new = acc * alpha.transpose(1, 2) + pv
    return m_new, l_new, acc_new


def _finish(q, l, acc):
    return (acc / l.clamp_min(1e-30).transpose(1, 2)).to(q.dtype)


def _diag_mask(s: int, device) -> torch.Tensor:
    """The causal mask of a diagonal block: row >= column."""
    r = torch.arange(s, device=device)
    return r[:, None] >= r[None, :]


def ring_attention(q, k, v, mesh: Optional[DeviceMesh], dim: str = "sp",
                   causal: bool = False, inner: str = "einsum"):
    """Blockwise ring attention over mesh dim ``dim``. Local shapes
    (B, S_local, H, D) for q, (B, S_local, H or KV, D) for k and v; the
    output is q's shape and dtype. Causal masking uses global positions:
    only the diagonal block (the rank's own chunk, step 0) needs a mask,
    and on it the local mask is the global one."""
    _check_inner(inner)
    n = axis_size(mesh, dim)
    me = axis_index(mesh, dim)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if inner == "einsum":
        k, v = repeat_kv(q, k, v)

    def attend(k_cur, v_cur, state, diagonal=False):
        if inner == "flash":
            return _flash_block_update(q, k_cur, v_cur, *state,
                                       causal_block=diagonal)
        mask = _diag_mask(q.shape[1], q.device) if diagonal else None
        return _block_update(q, k_cur, v_cur, *state, scale, mask=mask)

    state = _zeros(q)
    k_cur, v_cur = k, v
    for s in range(n):
        # After s shifts this rank holds the chunk of rank (me - s).
        src = (me - s) % n
        if not causal:
            state = attend(k_cur, v_cur, state)
        elif s == 0:
            state = attend(k_cur, v_cur, state, diagonal=True)
        elif src < me:
            # Live off-diagonal blocks need no mask.
            state = attend(k_cur, v_cur, state)
        else:
            # Sources ahead of this rank (src > me) lie wholly above the
            # diagonal: their blocks are skipped.
            state = _skip(state, k_cur, v_cur)
        if s < n - 1:
            k_cur = ring_shift(k_cur, mesh, dim)
            v_cur = ring_shift(v_cur, mesh, dim)
    _, l, acc = state
    return _finish(q, l, acc)


def ring_attention_zigzag(q, k, v, mesh: Optional[DeviceMesh],
                          dim: str = "sp", causal: bool = False,
                          inner: str = "einsum"):
    """Compute-balanced causal ring attention in the zigzag layout.

    The 2n half-chunks of the sequence are redistributed so that rank i
    holds halves (i, 2n−1−i), one early and one late; each ring step then
    does the same causal work on every rank. Inputs and outputs keep the
    contiguous (B, S_local, H, D) layout of :func:`ring_attention`; the
    zigzag lives inside. The local length must be even. Non-causal
    attention and n = 1 delegate to :func:`ring_attention`."""
    _check_inner(inner)
    n = axis_size(mesh, dim)
    if not causal or n == 1:
        return ring_attention(q, k, v, mesh, dim, causal=causal, inner=inner)
    if inner == "einsum":
        k, v = repeat_kv(q, k, v)
    me = axis_index(mesh, dim)
    s_local = q.shape[1]
    if s_local % 2:
        raise ValueError(f"local sequence {s_local} must be even for zigzag")
    half = s_local // 2
    scale = 1.0 / (q.shape[-1] ** 0.5)

    # Contiguous -> zigzag: rank j's first half is global half-chunk 2j,
    # its second 2j+1; half-chunk g belongs on rank g if g < n, else on
    # 2n-1-g. Both maps are bijections, so two permutations redistribute.
    def owner(g):
        return g if g < n else 2 * n - 1 - g

    perm_first = [(j, owner(2 * j)) for j in range(n)]
    perm_second = [(j, owner(2 * j + 1)) for j in range(n)]
    # The half arriving through perm_first is this rank's early half
    # (global half me) when it left rank me / 2.
    inv_first = {dst: src for src, dst in perm_first}
    first_is_early = 2 * inv_first[me] == me

    def to_zigzag(x):
        rf = ppermute(x[:, :half], mesh, dim, perm_first)
        rs = ppermute(x[:, half:], mesh, dim, perm_second)
        return (rf, rs) if first_is_early else (rs, rf)

    qe, ql = to_zigzag(q)
    ke, kl = to_zigzag(k)
    ve, vl = to_zigzag(v)

    def upd(qh, k_cur, v_cur, state, diagonal):
        if inner == "flash":
            return _flash_block_update(qh, k_cur, v_cur, *state,
                                       causal_block=diagonal)
        mask = _diag_mask(half, qh.device) if diagonal else None
        return _block_update(qh, k_cur, v_cur, *state, scale, mask=mask)

    early, late = _zeros(qe), _zeros(ql)
    # Step 0 (the source is this rank): both diagonal half-blocks, masked,
    # and late-Q against its own early-K (every late row follows them).
    early = upd(qe, ke, ve, early, diagonal=True)
    late = upd(ql, kl, vl, late, diagonal=True)
    late = upd(ql, ke, ve, late, diagonal=False)
    k_both, v_both = torch.stack([ke, kl]), torch.stack([ve, vl])
    for s in range(1, n):
        k_both = ring_shift(k_both, mesh, dim)
        v_both = ring_shift(v_both, mesh, dim)
        src = (me - s) % n
        # Early-Q (half me) against the source's early-K (half src): live
        # below the diagonal, src < me.
        if src < me:
            early = upd(qe, k_both[0], v_both[0], early, diagonal=False)
        # Late-Q (half 2n-1-me) against early-K (half src < n): always.
        late = upd(ql, k_both[0], v_both[0], late, diagonal=False)
        # Late-Q against late-K (half 2n-1-src): live when src > me.
        # Early-Q against a late half is never live.
        if src > me:
            late = upd(ql, k_both[1], v_both[1], late, diagonal=False)

    oe = _finish(q, early[1], early[2])
    ol = _finish(q, late[1], late[2])
    # Zigzag -> contiguous: repack in arrival order, then invert the two
    # redistributions.
    out_first, out_second = (oe, ol) if first_is_early else (ol, oe)
    back_first = ppermute(out_first, mesh, dim,
                          [(d, j) for j, d in perm_first])
    back_second = ppermute(out_second, mesh, dim,
                           [(d, j) for j, d in perm_second])
    return torch.cat([back_first, back_second], dim=1)
