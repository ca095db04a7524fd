"""Port parity: tpu_composer_torch/ops/attention.py against the JAX
package's ops/attention.py (Pallas flash in interpret mode, and the
einsum reference) on the same numpy inputs.

Tolerances: fp32 atol 1e-5 (same math, different summation order);
bf16 atol 2e-2 (bf16 rounds at other places in the two frameworks).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tpu_composer.ops import attention as jattn
from tpu_composer_torch.ops import attention as tattn

torch.set_num_threads(1)

FP32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _qkv(seed, b, sq, h, kv, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, sk, kv, d), np.float32),
            rng.standard_normal((b, sk, kv, d), np.float32))


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(h, kv, causal):
    q, k, v = _qkv(0, 2, 24, h, kv, 16)
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    got = tattn.mha_reference(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


def test_repeat_kv_matches_jax():
    q, k, v = _qkv(1, 1, 8, 4, 2, 8)
    jk, jv = jattn.repeat_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tk, tv = tattn.repeat_kv(t(q), t(k), t(v))
    np.testing.assert_array_equal(n(tk), n(jk))
    np.testing.assert_array_equal(n(tv), n(jv))
    with pytest.raises(ValueError, match="must divide"):
        tattn.repeat_kv(t(q[:, :, :3]), t(k), t(v))


@pytest.mark.parametrize("kv", [2, 1])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_flash_multi_block(kv, causal):
    """GQA (H=4 over KV=2 and KV=1), several q and k blocks."""
    q, k, v = _qkv(2, 2, 64, 4, kv, 32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=16,
                                 block_k=32, interpret=True)
    got = tattn.flash_attention(t(q), t(k), t(v), causal=causal, block_q=16,
                                block_k=32)
    np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


def test_flash_cross_attention_lengths():
    q, k, v = _qkv(3, 1, 32, 4, 2, 16, sk=64)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), block_q=16, block_k=16,
                                 interpret=True)
    got = tattn.flash_attention(t(q), t(k), t(v), block_q=16, block_k=16)
    np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_with_lse_matches_jax(causal):
    q, k, v = _qkv(4, 2, 32, 4, 2, 16)
    jo, jl = jattn.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    to, tl = tattn.flash_attention_with_lse(t(q), t(k), t(v), causal=causal,
                                            block_q=16, block_k=16)
    assert tuple(tl.shape) == (2, 4, 32) and tl.dtype == torch.float32
    np.testing.assert_allclose(n(to), n(jo), atol=FP32_ATOL)
    np.testing.assert_allclose(n(tl), n(jl), atol=FP32_ATOL)


@pytest.mark.parametrize("sq,kw", [
    (300, {}),                          # no power-of-two-friendly block
    (64, {"block_q": 48}),              # explicit block must divide
    (64, {"block_k": 24}),
    (192, {"block_q": 192}),            # > 128 and not a multiple of 128
])
def test_rejects_indivisible_seq(sq, kw):
    q, k, v = _qkv(5, 1, sq, 2, 2, 8)
    with pytest.raises(ValueError) as jerr:
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              interpret=True, **kw)
    with pytest.raises(ValueError) as terr:
        tattn.flash_attention(t(q), t(k), t(v), **kw)
    assert str(terr.value) == str(jerr.value)


def test_rejects_kv_not_dividing_heads():
    q, k, v = _qkv(6, 1, 16, 4, 3, 8)
    with pytest.raises(ValueError, match="must divide"):
        tattn.flash_attention(t(q), t(k), t(v))


def test_bf16_io():
    q, k, v = _qkv(7, 1, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jattn.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                 block_k=32, interpret=True)
    tq, tk, tv = (t(n(a), torch.bfloat16) for a in (jq, jk, jv))
    got = tattn.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), atol=BF16_ATOL)


def test_plain_flash_matches_reference_in_fp32():
    """The kernel's plain twin and the einsum reference are the same
    function (they differ only in where the 1/sqrt(D) is applied)."""
    q, k, v = _qkv(8, 2, 40, 4, 2, 16)
    for causal in (False, True):
        got, _ = tattn.flash_fwd_plain(t(q), t(k), t(v), causal)
        want = tattn.mha_reference(t(q), t(k), t(v), causal)
        np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


@pytest.mark.parametrize("b,h,sq,rows", [
    (1, 8, 256, 16),    # the serving prefill: 128 CTAs of 16 rows
    (1, 8, 512, 16),
    (2, 8, 512, 16),    # 64-row CTAs would give 128 < 132
    (4, 8, 512, 64),
    (8, 8, 512, 64),    # the training shape: 512 CTAs of 64 rows
    (1, 8, 8, 16),
])
def test_fwd_rows_fills_the_card(b, h, sq, rows):
    """K1's CTA height: 64 rows when that grid has a CTA for every one of
    the card's 132 SMs, else 16, which at the prefill shape gives at least
    128 CTAs."""
    assert tattn._fwd_rows(b, h, sq) == rows
    ctas = b * h * -(-sq // rows)
    assert ctas >= 132 if rows == 64 else b * h * -(-sq // 64) < 132
    if (b, h, sq) == (1, 8, 256):
        assert ctas >= 128
    if (b, h, sq) == (8, 8, 512):
        assert ctas == 512


def test_cuda_wrapper_never_runs_on_cpu_tensors():
    """The kernel wrapper raises on CPU tensors instead of falling back."""
    q, k, v = _qkv(9, 1, 8, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_fwd_cuda(t(q), t(k), t(v))

