"""Port parity: tpu_composer_torch/ops/paged_attention.py (its plain
gather path on the CPU) against the JAX package's Pallas paged-decode
kernel in interpret mode, on the same numpy pools, tables and lengths.

Tolerances: fp32 atol 2e-5 and int8 atol 2e-4 (the JAX package's own
kernel-vs-gather tolerances); bf16 atol 2e-2 (the JAX kernel keeps P in
fp32, the gather path rounds it to bf16 before P·V).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tpu_composer.models.decode import quantize_kv as jax_quantize_kv
from tpu_composer.ops.paged_attention import (
    paged_decode_attention as jax_paged,
)
from tpu_composer_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_cuda,
    paged_decode_plain,
)

torch.set_num_threads(1)


def _inputs(seed, n_blocks, bs, kv, dh, b, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_blocks, bs, kv, dh), np.float32),
            rng.standard_normal((n_blocks, bs, kv, dh), np.float32),
            rng.standard_normal((b, h, dh), np.float32))


def _both(q, kp, vp, tables, lengths, ks=None, vs=None, dtype=None):
    """(port, JAX) outputs as float32 numpy."""
    tables = np.asarray(tables, np.int32)
    lengths = np.asarray(lengths, np.int32)
    jdt = None if dtype is None else jnp.bfloat16
    cast = (lambda a: jnp.asarray(a)) if jdt is None else (
        lambda a: jnp.asarray(a, jdt))
    want = jax_paged(cast(q), cast(kp) if ks is None else jnp.asarray(kp),
                     cast(vp) if vs is None else jnp.asarray(vp),
                     jnp.asarray(tables), jnp.asarray(lengths),
                     k_scale=None if ks is None else jnp.asarray(ks),
                     v_scale=None if vs is None else jnp.asarray(vs),
                     interpret=True)
    tdt = dtype or torch.float32
    got = paged_decode_attention(
        t(n(cast(q)), tdt),
        t(n(cast(kp)), tdt) if ks is None else t(kp),
        t(n(cast(vp)), tdt) if vs is None else t(vp),
        t(tables), t(lengths),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs))
    return n(got), n(want)


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 8), (4, 1)])
def test_matches_jax_kernel(h, kv):
    kp, vp, q = _inputs(0, 12, 16, kv, 64, 3, h)
    tables = [[4, 7, 2], [0, 3, 5], [8, 9, 1]]
    got, want = _both(q, kp, vp, tables, [40, 17, 48])  # ragged, mid-block
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_single_position_row():
    kp, vp, q = _inputs(1, 4, 8, 2, 32, 2, 4)
    got, want = _both(q, kp, vp, [[1, 2], [3, 0]], [1, 9])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.isfinite(got).all()


def test_length_zero_row_gives_zeros():
    kp, vp, q = _inputs(2, 4, 8, 2, 32, 2, 4)
    got, want = _both(q, kp, vp, [[1, 2], [3, 0]], [0, 13])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[0] == 0).all() and (want[0] == 0).all()


def test_stale_table_slots_never_leak():
    """Poison every block a row does not own and the owned block's tail
    past the length: the output must not change."""
    kp, vp, q = _inputs(3, 8, 8, 1, 32, 1, 2)
    tables, lengths = [[2, 6]], [11]
    base, _ = _both(q, kp, vp, tables, lengths)
    keep = np.zeros(8, bool)
    keep[[2, 6]] = True
    kq = np.where(keep[:, None, None, None], kp, 1e9).astype(np.float32)
    vq = np.where(keep[:, None, None, None], vp, 1e9).astype(np.float32)
    kq[6, 11 - 8:] = 1e9
    vq[6, 11 - 8:] = 1e9
    got, want = _both(q, kq, vq, tables, lengths)
    np.testing.assert_allclose(got, base, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_bf16_pool():
    kp, vp, q = _inputs(4, 6, 16, 2, 64, 2, 4)
    got, want = _both(q, kp, vp, [[0, 1, 2], [3, 4, 5]], [33, 48],
                      dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_int8_pool_with_scales():
    kf, vf, q = _inputs(5, 8, 16, 2, 64, 2, 4)
    kp, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(kf)))
    vp, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(vf)))
    got, want = _both(q, kp, vp, [[0, 3, 5], [1, 6, 7]], [35, 42], ks, vs)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_scale_args_must_pair():
    kp, vp, q = _inputs(6, 4, 8, 1, 32, 1, 2)
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention(t(q), t(kp), t(vp),
                               torch.zeros((1, 2), dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32),
                               k_scale=torch.zeros(4, 8, 1))


def test_rejects_head_dim_mismatch():
    kp, vp, q = _inputs(7, 4, 8, 1, 32, 1, 2)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(t(q[..., :16]), t(kp), t(vp),
                               torch.zeros((1, 2), dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))


def test_cuda_wrapper_never_runs_on_cpu_tensors():
    kp, vp, q = _inputs(8, 4, 8, 1, 64, 1, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_decode_cuda(t(q), t(kp), t(vp),
                          torch.zeros((1, 2), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32))

