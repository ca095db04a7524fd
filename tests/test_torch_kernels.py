"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU and nvcc; without a card they skip
(decided inside each test, never at import). This file imports no JAX,
so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels.py -q

Tolerances (absolute): fp32 1e-4 (other summation order); bf16 2e-2
(bf16 outputs; K2 keeps P in fp32 where the gather path rounds it to
bf16); lse 1e-4; int8 pools with fp32 queries 2e-4. The backward
kernels B3/B4, relative to each gradient's own max|ref|: fp32 1e-4; bf16
3e-2 (dS is rounded to bf16 before two products). B3 and B4 in bf16,
K2 (split pass and merge) and K3 (the latent decode kernel, bf16 only;
its twin rounds P at the row's max where the kernel rounds at each
tile's, within the bf16 tolerance) are also held to the same bits on
two launches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_composer_torch.models.decode import quantize_kv
from tpu_composer_torch.ops import attention as tattn
from tpu_composer_torch.ops import mla_decode as tmla
from tpu_composer_torch.ops import paged_attention as tpa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_matches_plain(card, dtype, d):
    rng = np.random.default_rng(0)
    for b, sq, sk, h, kv, causal in ((1, 8, 8, 8, 2, True),
                                     (2, 100, 100, 8, 2, False),
                                     (2, 256, 256, 8, 8, True),
                                     (1, 33, 70, 4, 1, False)):
        q = _rand(rng, (b, sq, h, d), card, dtype)
        k = _rand(rng, (b, sk, kv, d), card, dtype)
        v = _rand(rng, (b, sk, kv, d), card, dtype)
        for with_lse in (False, True):
            before = (tattn.flash_fwd_cuda.launches
                      + tattn.flash_fwd_cuda.launches_lse)
            got, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse)
            want, lse_w = tattn.flash_fwd_plain(q, k, v, causal, with_lse)
            torch.cuda.synchronize()
            assert (tattn.flash_fwd_cuda.launches
                    + tattn.flash_fwd_cuda.launches_lse) == before + 1
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=TOL[dtype])
            if with_lse:
                assert lse.shape == (b, h, sq)
                torch.testing.assert_close(lse, lse_w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_geometries_match_plain(card, d, rows):
    """K1's tensor-core kernel at both CTA heights, whatever _fwd_rows
    would pick, over ragged and whole-tile lengths."""
    rng = np.random.default_rng(5)
    for s in (8, 100, 130, 512):
        q = _rand(rng, (2, s, 8, d), card, torch.bfloat16)
        k = _rand(rng, (2, s, 2, d), card, torch.bfloat16)
        v = _rand(rng, (2, s, 2, d), card, torch.bfloat16)
        for causal in (False, True):
            for with_lse in (False, True):
                got, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse,
                                                rows=rows)
                want, lse_w = tattn.flash_fwd_plain(q, k, v, causal,
                                                    with_lse)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                           atol=TOL[torch.bfloat16])
                if with_lse:
                    torch.testing.assert_close(lse, lse_w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv", [8, 2])  # G = 1 (MHA) and G = 4
@pytest.mark.parametrize("d", [64, 128])
def test_flash_dkv_bf16_split_matches_plain(card, d, kv):
    """B4's tensor-core kernel with the GQA group split across CTAs and
    not, against flash_bwd_plain's dk and dv (bf16 tolerance relative to
    each gradient's max|ref|)."""
    rng = np.random.default_rng(6)
    h = 8
    for s in (8, 100, 130, 512):
        q = _rand(rng, (2, s, h, d), card, torch.bfloat16)
        k = _rand(rng, (2, s, kv, d), card, torch.bfloat16)
        v = _rand(rng, (2, s, kv, d), card, torch.bfloat16)
        do = _rand(rng, (2, s, h, d), card, torch.bfloat16)
        for causal in (False, True):
            out, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse=True)
            for with_g_lse in (False, True):
                g_lse = (_rand(rng, (2, h, s), card, torch.float32)
                         if with_g_lse else None)
                delta = tattn._delta(out, do, g_lse)
                _, *want = tattn.flash_bwd_plain(q, k, v, out, lse, do,
                                                 g_lse, causal)
                for split in sorted({1, h // kv}):
                    got = tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                   causal, split=split)
                    torch.cuda.synchronize()
                    for name, a, w in zip(("dk", "dv"), got, want):
                        scale = float(w.float().abs().max())
                        err = float((a.float() - w.float()).abs().max())
                        assert err <= 3e-2 * scale, (name, s, causal, split,
                                                     err, scale)


def test_flash_dkv_bf16_is_deterministic(card):
    """Two launches of B4 on the same inputs (training shape, the group
    split over 4 CTAs) give the same bits: a fixed-order reduction, no
    atomics."""
    rng = np.random.default_rng(7)
    b, s, h, kv, d = 8, 512, 8, 2, 64
    q = _rand(rng, (b, s, h, d), card, torch.bfloat16)
    k = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
    v = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
    do = _rand(rng, (b, s, h, d), card, torch.bfloat16)
    out, lse = tattn.flash_fwd_cuda(q, k, v, True, with_lse=True)
    delta = tattn._delta(out, do)
    assert tattn._dkv_split(b, kv, h // kv, s) == 4
    first = tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    second = tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for a, w in zip(first, second):
        assert torch.equal(a.view(torch.int16), w.view(torch.int16))


def test_flash_entry_point_launches_on_cuda_and_its_gradient_path(card):
    """Without grad the entry point launches K1 without lse; with grad it
    launches K1 with lse, and backward() launches B3 and B4 once each."""
    rng = np.random.default_rng(1)
    q = _rand(rng, (1, 64, 8, 64), card, torch.bfloat16)
    k = _rand(rng, (1, 64, 2, 64), card, torch.bfloat16)
    before = tattn.flash_fwd_cuda.launches
    tattn.flash_attention(q, k, k, causal=True)
    assert tattn.flash_fwd_cuda.launches == before + 1
    counts = lambda: (tattn.flash_fwd_cuda.launches_lse,  # noqa: E731
                      tattn.flash_bwd_dq_cuda.launches,
                      tattn.flash_bwd_dkv_cuda.launches)
    before = counts()
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    out = tattn.flash_attention(qg, kg, kg, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before)
    assert qg.grad.shape == q.shape and kg.grad.shape == k.shape
    assert torch.isfinite(qg.grad.float()).all()
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd_cuda(q[..., :32].contiguous().detach(),
                             k[..., :32].contiguous(),
                             k[..., :32].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_kernels_match_plain(card, dtype, d):
    rng = np.random.default_rng(3)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    for b, s, h, kv, causal, with_g_lse in ((1, 8, 8, 2, True, False),
                                           (2, 100, 8, 2, False, True),
                                           (2, 256, 8, 8, True, True),
                                           (1, 130, 4, 1, True, False)):
        q = _rand(rng, (b, s, h, d), card, dtype)
        k = _rand(rng, (b, s, kv, d), card, dtype)
        v = _rand(rng, (b, s, kv, d), card, dtype)
        do = _rand(rng, (b, s, h, d), card, dtype)
        g_lse = (_rand(rng, (b, h, s), card, torch.float32)
                 if with_g_lse else None)
        out, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse=True)
        before = (tattn.flash_bwd_dq_cuda.launches,
                  tattn.flash_bwd_dkv_cuda.launches)
        got = tattn.flash_bwd_cuda(q, k, v, out, lse, do, g_lse, causal)
        torch.cuda.synchronize()
        assert (tattn.flash_bwd_dq_cuda.launches,
                tattn.flash_bwd_dkv_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
        want = tattn.flash_bwd_plain(q, k, v, out, lse, do, g_lse, causal)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == dtype and a.shape == w.shape, name
            scale = float(w.float().abs().max())
            err = float((a.float() - w.float()).abs().max())
            assert err <= tol * scale, (name, err, scale)


def test_train_step_makes_no_host_sync(card):
    """A train step only queues work: nothing in the forward, the flash
    backward or AdamW makes the host wait for the card."""
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    cfg = ModelConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=512, max_seq=64,
                      dtype=torch.bfloat16, attn_impl="flash")
    tc = TrainConfig(model=cfg)
    state, step = make_train_state(tc, 0, card), make_train_step(tc)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 64), dtype=np.int32)).to(card)
    step(state, tokens)  # first call builds the kernels
    torch.cuda.synchronize()
    counts = (tattn.flash_bwd_dq_cuda.launches,
              tattn.flash_bwd_dkv_cuda.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, tokens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (tattn.flash_bwd_dq_cuda.launches,
            tattn.flash_bwd_dkv_cuda.launches) == (counts[0] + 2,
                                                   counts[1] + 2)
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dh", [64, 128])
def test_paged_kernel_matches_plain(card, pool, dh):
    rng = np.random.default_rng(2)
    n_blocks, bs, kv, b, h, mb = 64, 16, 2, 4, 8, 8
    kf = torch.from_numpy(rng.standard_normal((n_blocks, bs, kv, dh),
                                              np.float32))
    vf = torch.from_numpy(rng.standard_normal((n_blocks, bs, kv, dh),
                                              np.float32))
    tables = torch.from_numpy(
        rng.permutation(n_blocks)[:b * mb].reshape(b, mb).astype(np.int32))
    lengths = torch.tensor([0, 1, 77, 128], dtype=torch.int32)
    if pool == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        qd, tol = torch.float32, 2e-4
    else:
        qd = getattr(torch, pool)
        kp, vp, ks, vs = kf.to(qd), vf.to(qd), None, None
        tol = TOL[qd]
    q = torch.from_numpy(rng.standard_normal((b, h, dh), np.float32)).to(qd)
    args = [x if x is None else x.to(card)
            for x in (q, kp, vp, tables, lengths, ks, vs)]
    counter = "launches_int8" if pool == "int8" else "launches"
    before = getattr(tpa.paged_decode_cuda, counter)
    got = tpa.paged_decode_attention(*args)
    want = tpa.paged_decode_plain(*args)
    torch.cuda.synchronize()
    assert getattr(tpa.paged_decode_cuda, counter) == before + 1
    assert (got[0] == 0).all()  # the length-0 row
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_kernel_mha_engine_shape(card, pool):
    """K2 at G = 1, the MoE engine's decode shape: 8 rows, 8 query heads
    over 8 KV heads of 64, blocks of 16, 32 table slots, lengths 0-320
    with stale slots past each row's blocks."""
    rng = np.random.default_rng(12)
    n_blocks, bs, kv, h, mb, dh = 256, 16, 8, 8, 32, 64
    lengths = np.array([0, 1, 15, 64, 65, 130, 257, 320], np.int32)
    tables = rng.integers(0, n_blocks, (8, mb)).astype(np.int32)
    perm, used = rng.permutation(n_blocks), 0
    for r, n_len in enumerate(lengths):
        owned = -(-int(n_len) // bs)
        tables[r, :owned] = perm[used:used + owned]
        used += owned
    kf, vf = (torch.from_numpy(rng.standard_normal((n_blocks, bs, kv, dh),
                                                   np.float32))
              for _ in range(2))
    if pool == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        qd, tol = torch.float32, 2e-4
    else:
        qd = getattr(torch, pool)
        kp, vp, ks, vs = kf.to(qd), vf.to(qd), None, None
        tol = TOL[qd]
    q = torch.from_numpy(rng.standard_normal((8, h, dh), np.float32)).to(qd)
    args = [x if x is None else x.to(card)
            for x in (q, kp, vp, torch.from_numpy(tables),
                      torch.from_numpy(lengths), ks, vs)]
    got = tpa.paged_decode_attention(*args)
    want = tpa.paged_decode_plain(*args)
    torch.cuda.synchronize()
    assert (got[0] == 0).all()  # the length-0 row
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("kv", [8, 2])  # G = 1 (MHA) and G = 4
@pytest.mark.parametrize("d", [64, 128])
def test_flash_dq_bf16_matches_plain(card, d, kv):
    """B3's tensor-core kernel against flash_bwd_plain's dq, causal and
    not, with and without an lse cotangent, at a ragged length, a whole
    number of tiles and a sequence shorter than one tile (bf16 tolerance
    relative to max|ref|)."""
    rng = np.random.default_rng(8)
    h = 8
    for b, s in ((2, 100), (1, 512), (2, 8)):
        q = _rand(rng, (b, s, h, d), card, torch.bfloat16)
        k = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
        v = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
        do = _rand(rng, (b, s, h, d), card, torch.bfloat16)
        for causal in (False, True):
            out, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse=True)
            for with_g_lse in (False, True):
                g_lse = (_rand(rng, (b, h, s), card, torch.float32)
                         if with_g_lse else None)
                delta = tattn._delta(out, do, g_lse)
                want = tattn.flash_bwd_plain(q, k, v, out, lse, do, g_lse,
                                             causal)[0]
                got = tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                              causal)
                torch.cuda.synchronize()
                assert got.dtype == torch.bfloat16 and got.shape == q.shape
                scale = float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                assert err <= 3e-2 * scale, (s, causal, with_g_lse, err,
                                             scale)


def test_flash_dq_bf16_is_deterministic(card):
    """Two launches of B3 on the training-shape inputs give the same bits:
    each CTA alone owns its dQ rows."""
    rng = np.random.default_rng(9)
    b, s, h, kv, d = 8, 512, 8, 2, 64
    q = _rand(rng, (b, s, h, d), card, torch.bfloat16)
    k = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
    v = _rand(rng, (b, s, kv, d), card, torch.bfloat16)
    do = _rand(rng, (b, s, h, d), card, torch.bfloat16)
    out, lse = tattn.flash_fwd_cuda(q, k, v, True, with_lse=True)
    delta = tattn._delta(out, do)
    first = tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
    second = tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def _paged_case(rng, pool, dh=64):
    """The engine's decode shape (8 rows, 8 query heads over 2 KV heads,
    blocks of 16, 32 table slots) with lengths on and around chunk and
    block edges, a 0-length row and a full row; each row owns distinct
    blocks, every other slot holds a stale id."""
    n_blocks, bs, kv, h, mb = 256, 16, 2, 8, 32
    lengths = np.array([0, 1, 16, 63, 65, 200, 511, 512], np.int32)
    tables = rng.integers(0, n_blocks, (8, mb)).astype(np.int32)
    perm, used = rng.permutation(n_blocks), 0
    for r, n_len in enumerate(lengths):
        owned = -(-int(n_len) // bs)
        tables[r, :owned] = perm[used:used + owned]
        used += owned
    kf = torch.from_numpy(rng.standard_normal((n_blocks, bs, kv, dh),
                                              np.float32))
    vf = torch.from_numpy(rng.standard_normal((n_blocks, bs, kv, dh),
                                              np.float32))
    if pool == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        qd, tol = torch.float32, 2e-4
    else:
        qd = getattr(torch, pool)
        kp, vp, ks, vs = kf.to(qd), vf.to(qd), None, None
        tol = TOL[qd]
    q = torch.from_numpy(rng.standard_normal((8, h, dh), np.float32)).to(qd)
    args = [x if x is None else x.to("cuda")
            for x in (q, kp, vp, torch.from_numpy(tables),
                      torch.from_numpy(lengths), ks, vs)]
    return args, tol


@pytest.mark.parametrize("chunk", [16, 24, 64, 256])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
def test_paged_kernel_split_matches_plain(card, pool, chunk):
    """K2 at forced chunk sizes (32 down to 2 CTAs a row and KV head;
    chunks of 24 start inside a block of 16) against the gather path, and
    against its own split arithmetic."""
    rng = np.random.default_rng(10)
    args, tol = _paged_case(rng, pool)
    got = tpa.paged_decode_cuda(*args, chunk=chunk)
    want = tpa.paged_decode_plain(*args)
    split = tpa.paged_decode_split_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert (got[0] == 0).all()  # the length-0 row
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    torch.testing.assert_close(got.float(), split.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_paged_kernel_is_deterministic(card, pool):
    """Two calls of K2 give the same bits: the partials merge in a fixed
    order, no atomics."""
    rng = np.random.default_rng(11)
    args, _ = _paged_case(rng, pool)
    first = tpa.paged_decode_cuda(*args)
    second = tpa.paged_decode_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))


def test_flash_serving_prefill_shape_matches_plain(card):
    """K1 without lse at the serving prefill shape that the HA operator's
    composed worker runs first (one prompt padded to its 256 bucket,
    8 query heads over 2 KV heads, head_dim 64, bf16, causal), with the
    CTA height ``_fwd_rows`` picks there; one launch, counted."""
    rng = np.random.default_rng(13)
    q = _rand(rng, (1, 256, 8, 64), card, torch.bfloat16)
    k = _rand(rng, (1, 256, 2, 64), card, torch.bfloat16)
    v = _rand(rng, (1, 256, 2, 64), card, torch.bfloat16)
    before = tattn.flash_fwd_cuda.launches
    got, lse = tattn.flash_fwd_cuda(q, k, v, True)
    want, _ = tattn.flash_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    assert lse is None and tattn.flash_fwd_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


# -- K3 (latent decode) and K1 at 192/128 (MLA's expanded prefill) ----------

def _mla_case(rng, card, lengths, mb, bs=16):
    """q (B, 16, 576), a pool of shuffled blocks, tables, lengths."""
    b = len(lengths)
    q = _rand(rng, (b, 16, 576), card, torch.bfloat16)
    pool = _rand(rng, (b * mb + 1, bs, 576), card, torch.bfloat16)
    tables = torch.from_numpy(rng.permutation(b * mb).astype(np.int32)).view(
        b, mb).to(card)
    return q, pool, tables, torch.tensor(lengths, dtype=torch.int32,
                                         device=card)


#: Ragged rows with a 0-length one, a block's last position (15, 31),
#: tile edges (32, 33), split edges (511, 512, 513) and a full table.
MLA_LENGTHS = [0, 1, 15, 16, 31, 32, 33, 100, 511, 512, 513, 1023, 1280]


@pytest.mark.parametrize("chunk", [None, 32, 96, 1024])
def test_mla_kernel_matches_its_twin(card, chunk):
    rng = np.random.default_rng(3)
    args = _mla_case(rng, card, MLA_LENGTHS, mb=80)
    scale = 192 ** -0.5
    before = tmla.mla_decode_cuda.launches
    got = tmla.mla_decode_cuda(*args, scale, chunk=chunk)
    want = tmla.mla_decode_plain(*args, scale, 512)
    torch.cuda.synchronize()
    assert tmla.mla_decode_cuda.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= TOL[
        torch.bfloat16]
    assert bool((got[0] == 0).all())
    again = tmla.mla_decode_cuda(*args, scale, chunk=chunk)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def test_mla_kernel_replays_from_a_graph(card):
    """Captured on one set of lengths and replayed on another, K3 gives
    the eager launch's bits (no host read, fixed shapes)."""
    rng = np.random.default_rng(4)
    q, pool, tables, lengths = _mla_case(rng, card, [600] * 8, mb=64)
    scale = 192 ** -0.5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmla.mla_decode_cuda(q, pool, tables, lengths, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmla.mla_decode_cuda(q, pool, tables, lengths, scale)
    new = torch.tensor([1, 16, 513, 1023, 0, 640, 1024, 77],
                       dtype=torch.int32, device=card)
    lengths.copy_(new)
    graph.replay()
    eager = tmla.mla_decode_cuda(q, pool, tables, new, scale)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


@pytest.mark.parametrize("rows", [16, 64])
def test_flash_192_128_matches_plain(card, rows):
    """MLA's expanded prefill: q and k 192 wide, v 128 (the wrapper pads
    it to 192 and cuts the output back), causal, bf16."""
    rng = np.random.default_rng(5)
    for b, s in ((1, 8), (2, 100), (1, 512)):
        q = _rand(rng, (b, s, 16, 192), card, torch.bfloat16)
        k = _rand(rng, (b, s, 16, 192), card, torch.bfloat16)
        v = _rand(rng, (b, s, 16, 128), card, torch.bfloat16)
        got, _ = tattn.flash_fwd_cuda(q, k, v, True, rows=rows)
        want, _ = tattn.flash_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        assert got.shape == (b, s, 16, 128)
        assert float((got.float() - want.float()).abs().max()) <= TOL[
            torch.bfloat16]
