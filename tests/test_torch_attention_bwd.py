"""Port parity for the flash backward: gradients of
tpu_composer_torch/ops/attention.py against ``jax.grad`` of the JAX
package's flash attention (its custom VJP, Pallas kernels in interpret
mode) on the same numpy inputs.

On CPU tensors the port's entry points run the same autograd Functions
as on the card, with the kernels' plain versions (``flash_fwd_plain``,
``flash_bwd_plain``), so these tests hold the custom backward itself.

Tolerances: fp32 ``err < 1e-3 * max(max|ref|, 1)``, the bound of
tests/test_flash_attention.py (other summation order, exp rebuilt from
lse); bf16 ``5e-2 * max(max|ref|, 1)`` (dS and P are rounded to bf16
before the products, at other places in the two frameworks); the plain
backward against autograd of the plain forward, fp32, 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tpu_composer.ops import attention as jattn
from tpu_composer_torch.ops import attention as tattn

torch.set_num_threads(1)


def _inputs(seed, b, s, h, kv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for shape in
            ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))]


def _assert_close(got, want, rel):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = n(a), n(b)
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err < rel * max(scale, 1.0), f"{name}: {err} vs {scale}"


def _jax_grads(q, k, v, do, causal, dtype=jnp.float32, **blocks):
    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, interpret=True,
                                    **blocks)
        return (out.astype(jnp.float32) * do).sum()

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return jax.grad(loss, argnums=(0, 1, 2))(*args)


def _torch_grads(q, k, v, do, causal, dtype=torch.float32, **blocks):
    qkv = [t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*qkv, causal=causal, **blocks)
    (out.float() * t(do)).sum().backward()
    return [x.grad for x in qkv]


@pytest.mark.parametrize("kv", [4, 2, 1])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax(kv, causal):
    """H 4 over KV 4/2/1, S 64 in several q and k blocks."""
    q, k, v, do = _inputs(0, 2, 64, 4, kv, 32)
    blocks = dict(block_q=16, block_k=32)
    want = _jax_grads(q, k, v, do, causal, **blocks)
    got = _torch_grads(q, k, v, do, causal, **blocks)
    _assert_close(got, want, 1e-3)


def test_flash_grads_bf16():
    q, k, v, do = _inputs(1, 1, 64, 4, 2, 32)
    want = _jax_grads(q, k, v, do, True, jnp.bfloat16, block_q=32,
                      block_k=32)
    got = _torch_grads(q, k, v, do, True, torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_close(got, want, 5e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_grads_match_jax(causal):
    """A loss over both outputs of flash_attention_with_lse: the lse
    cotangent enters the backward as δ − g_lse (_flash_core_lse)."""
    q, k, v, do = _inputs(2, 2, 32, 4, 2, 16)
    w = np.random.default_rng(3).standard_normal((2, 4, 32)).astype(
        np.float32)

    def jloss(q, k, v):
        out, lse = jattn.flash_attention_with_lse(
            q, k, v, causal=causal, block_q=16, block_k=16, interpret=True)
        return (out * do).sum() + (lse * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out, lse = tattn.flash_attention_with_lse(*qkv, causal=causal,
                                              block_q=16, block_k=16)
    ((out * t(do)).sum() + (lse * t(w)).sum()).backward()
    _assert_close([x.grad for x in qkv], want, 1e-3)


def test_lse_only_loss_gets_zero_output_cotangent():
    """Only the lse reaches the loss: the output cotangent is None and the
    backward treats it as zeros."""
    q, k, v, _ = _inputs(4, 1, 16, 2, 1, 16)
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    _, lse = tattn.flash_attention_with_lse(*qkv, causal=True)
    lse.sum().backward()

    def jloss(q, k, v):
        return jattn.flash_attention_with_lse(q, k, v, causal=True,
                                              interpret=True)[1].sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    _assert_close([x.grad for x in qkv], want, 1e-3)


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_g_lse", [False, True])
def test_plain_backward_is_autograd_of_plain_forward(kv, causal, with_g_lse):
    q, k, v, do = _inputs(5, 2, 24, 4, kv, 16)
    g_lse = np.random.default_rng(6).standard_normal((2, 4, 24)).astype(
        np.float32) if with_g_lse else None
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out, lse = tattn.flash_fwd_plain(*qkv, causal=causal, with_lse=True)
    loss = (out * t(do)).sum()
    if with_g_lse:
        loss = loss + (lse * t(g_lse)).sum()
    want = torch.autograd.grad(loss, qkv)
    got = tattn.flash_bwd_plain(*(x.detach() for x in qkv), out.detach(),
                                lse.detach(), t(do),
                                None if g_lse is None else t(g_lse), causal)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=1e-5)


def test_grad_path_runs_through_the_flash_function():
    """CPU autograd goes through the same Function the card runs (its
    backward, not autograd of the plain forward's einsums)."""
    q, k, v, _ = _inputs(7, 1, 16, 2, 2, 16)
    qkv = [t(x).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*qkv, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out2, lse = tattn.flash_attention_with_lse(*qkv)
    assert type(out2.grad_fn).__name__ == "FlashAttentionBackward"
    assert lse.grad_fn is out2.grad_fn
    with torch.no_grad():
        assert tattn.flash_attention(*qkv).grad_fn is None


@pytest.mark.parametrize("b,kv,g,sk,split", [
    (8, 2, 4, 512, 4),   # the training shape: 16 · 8 = 128 CTAs unsplit
    (8, 8, 1, 512, 1),   # qualify_slice's MHA: nothing to split
    (1, 2, 4, 100, 4),
    (32, 2, 4, 512, 2),  # 512 CTAs unsplit: half the group suffices
    (64, 2, 4, 512, 1),  # 1,024 CTAs unsplit
    (8, 1, 6, 512, 6),   # the whole group when no divisor fills the card
])
def test_dkv_split_fills_the_card(b, kv, g, sk, split):
    """B4's group split: the smallest divisor of the GQA group that gives
    four CTAs for each of the 132 SMs, else the whole group; 1 for MHA."""
    assert tattn._dkv_split(b, kv, g, sk) == split
    assert g % split == 0
    if (b, kv, g, sk) == (8, 2, 4, 512):
        assert b * kv * -(-sk // 64) * split == 512


def test_backward_wrappers_never_run_on_cpu_tensors():
    q, k, v, do = (t(x) for x in _inputs(8, 1, 8, 2, 2, 64))
    out, lse = tattn.flash_fwd_plain(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_bwd_cuda(q, k, v, out, lse, do)
    delta = tattn._delta(out, do)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
