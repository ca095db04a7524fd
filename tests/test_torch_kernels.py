"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU and nvcc; without a card they skip
(decided inside each test, never at import). This file imports no JAX,
so it runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_kernels.py -q

Tolerances (absolute): fp32 1e-4 (other summation order); bf16 2e-2
(bf16 outputs; K2 keeps P in fp32 where the gather path rounds it to
bf16); lse 1e-4; int8 pools with fp32 queries 2e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_composer_torch.models.decode import quantize_kv
from tpu_composer_torch.ops import attention as tattn
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
            before = tattn.flash_fwd_cuda.launches
            got, lse = tattn.flash_fwd_cuda(q, k, v, causal, with_lse)
            want, lse_w = tattn.flash_fwd_plain(q, k, v, causal, with_lse)
            torch.cuda.synchronize()
            assert tattn.flash_fwd_cuda.launches == before + 1
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=TOL[dtype])
            if with_lse:
                assert lse.shape == (b, h, sq)
                torch.testing.assert_close(lse, lse_w, rtol=0, atol=1e-4)


def test_flash_entry_point_launches_on_cuda_and_refuses_grad(card):
    rng = np.random.default_rng(1)
    q = _rand(rng, (1, 64, 8, 64), card, torch.bfloat16)
    k = _rand(rng, (1, 64, 2, 64), card, torch.bfloat16)
    before = tattn.flash_fwd_cuda.launches
    tattn.flash_attention(q, k, k, causal=True)
    assert tattn.flash_fwd_cuda.launches == before + 1
    with pytest.raises(NotImplementedError, match="training slice"):
        tattn.flash_attention(q.requires_grad_(), k, k)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd_cuda(q[..., :32].contiguous().detach(),
                             k[..., :32].contiguous(),
                             k[..., :32].contiguous())


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
    before = tpa.paged_decode_cuda.launches
    got = tpa.paged_decode_attention(*args)
    want = tpa.paged_decode_plain(*args)
    torch.cuda.synchronize()
    assert tpa.paged_decode_cuda.launches == before + 1
    assert (got[0] == 0).all()  # the length-0 row
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
