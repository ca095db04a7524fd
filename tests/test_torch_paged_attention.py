"""Port parity: tpu_composer_torch/ops/paged_attention.py (its plain
gather path on the CPU) against the JAX package's Pallas paged-decode
kernel in interpret mode, on the same numpy pools, tables and lengths.

The split-and-merge arithmetic of the CUDA kernel
(``paged_decode_split_plain``: chunks of the cache, then a merge in a
fixed order) is held against the same JAX kernel, with empty chunks,
0-length rows, rows ending mid-chunk and stale table slots, at several
chunk sizes.

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
    _decode_split,
    paged_decode_attention,
    paged_decode_cuda,
    paged_decode_plain,
    paged_decode_split_plain,
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



@pytest.mark.parametrize("bs,mb,chunk,n_split", [
    (16, 32, 64, 8),    # the engine: 8 rows x 2 KV heads x 8 = 128 CTAs
    (16, 3, 64, 1),     # a short table: one chunk, partly past the table
    (8, 4, 64, 1),
    (32, 5, 64, 3),
    (48, 10, 48, 10),   # a block size that does not divide 64
    (128, 4, 64, 8),    # blocks past 64 positions: two chunks a block
    (512, 2, 64, 16),
])
def test_decode_split_geometry(bs, mb, chunk, n_split):
    """K2's split: a chunk is the whole blocks that fit in 64 positions,
    64 itself for larger blocks; the chunks cover the table's positions
    with no chunk wholly past it. Shapes only: neither the batch nor the
    lengths enter."""
    assert _decode_split(bs, mb) == (chunk, n_split)
    assert chunk % bs == 0 or bs % chunk == 0
    assert (n_split - 1) * chunk < mb * bs <= n_split * chunk
    if (bs, mb) == (16, 32):
        assert 8 * 2 * n_split == 128


def _split_case(seed, n_blocks, bs, kv, dh, h, lengths, mb):
    """Pools, q and tables for ``lengths``: each row owns distinct blocks
    for its live positions; every other slot holds a stale id (any block
    of the pool, another row's included)."""
    rng = np.random.default_rng(seed)
    kp, vp, q = _inputs(seed, n_blocks, bs, kv, dh, len(lengths), h)
    tables = rng.integers(0, n_blocks, (len(lengths), mb)).astype(np.int32)
    perm, used = rng.permutation(n_blocks), 0
    for r, n_len in enumerate(lengths):
        owned = -(-n_len // bs)
        tables[r, :owned] = perm[used:used + owned]
        used += owned
    return kp, vp, q, tables, np.asarray(lengths, np.int32)


def _jax_out(q, kp, vp, tables, lengths, ks=None, vs=None, jdt=None):
    cast = (lambda a: jnp.asarray(a)) if jdt is None else (
        lambda a: jnp.asarray(a, jdt))
    return n(jax_paged(cast(q), cast(kp) if ks is None else jnp.asarray(kp),
                       cast(vp) if vs is None else jnp.asarray(vp),
                       jnp.asarray(tables), jnp.asarray(lengths),
                       k_scale=None if ks is None else jnp.asarray(ks),
                       v_scale=None if vs is None else jnp.asarray(vs),
                       interpret=True))


# 0-length row; a row inside the first block; rows ending mid-chunk and
# mid-block; a full table (every chunk live). With chunks of 5 to 16 most
# of the short rows' chunks are empty; chunks of 5 and 12 start inside a
# block of 8; chunk 64 is one chunk past the table.
_SPLIT_LENGTHS = [0, 5, 17, 33, 48]


@pytest.mark.parametrize("chunk", [5, 8, 12, 16, 24, 64])
def test_split_plain_matches_jax_kernel(chunk):
    kp, vp, q, tables, lengths = _split_case(9, 40, 8, 2, 64, 4,
                                             _SPLIT_LENGTHS, 6)
    want = _jax_out(q, kp, vp, tables, lengths)
    got = n(paged_decode_split_plain(t(q), t(kp), t(vp), t(tables),
                                     t(lengths), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert (got[0] == 0).all()


def test_split_plain_default_chunk_matches_jax_kernel():
    """The engine's block size (16) and the default chunk of 64 over a
    12-slot table: three chunks, rows ending on and past chunk edges."""
    kp, vp, q, tables, lengths = _split_case(10, 60, 16, 2, 64, 8,
                                             [0, 1, 63, 64, 65, 130, 192],
                                             12)
    assert _decode_split(16, 12) == (64, 3)
    want = _jax_out(q, kp, vp, tables, lengths)
    got = n(paged_decode_split_plain(t(q), t(kp), t(vp), t(tables),
                                     t(lengths)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [8, 16])
def test_split_plain_stale_slots_never_leak(chunk):
    """Poison every block a row does not own and the owned tail past its
    length: the split arithmetic, empty chunks included, must not
    change."""
    kp, vp, q = _inputs(11, 8, 8, 1, 32, 1, 2)
    tables, lengths = np.array([[2, 6, 0, 5]], np.int32), np.array([11],
                                                                  np.int32)
    base = n(paged_decode_split_plain(t(q), t(kp), t(vp), t(tables),
                                      t(lengths), chunk=chunk))
    keep = np.zeros(8, bool)
    keep[[2, 6]] = True
    kq = np.where(keep[:, None, None, None], kp, 1e9).astype(np.float32)
    vq = np.where(keep[:, None, None, None], vp, 1e9).astype(np.float32)
    kq[6, 11 - 8:] = 1e9
    vq[6, 11 - 8:] = 1e9
    got = n(paged_decode_split_plain(t(q), t(kq), t(vq), t(tables),
                                     t(lengths), chunk=chunk))
    np.testing.assert_allclose(got, base, rtol=1e-6)
    np.testing.assert_allclose(got, _jax_out(q, kq, vq, tables, lengths),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [16, 32])
def test_split_plain_bf16_pool(chunk):
    kp, vp, q, tables, lengths = _split_case(12, 24, 16, 2, 64, 4,
                                             [0, 9, 40, 64], 4)
    want = _jax_out(q, kp, vp, tables, lengths, jdt=jnp.bfloat16)
    bf = lambda a: t(n(jnp.asarray(a, jnp.bfloat16)), torch.bfloat16)  # noqa: E731
    got = n(paged_decode_split_plain(bf(q), bf(kp), bf(vp), t(tables),
                                     t(lengths), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("chunk", [16, 48])
def test_split_plain_int8_pool(chunk):
    kf, vf, q, tables, lengths = _split_case(13, 24, 16, 2, 64, 4,
                                             [0, 9, 40, 64], 4)
    kp, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(kf)))
    vp, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(vf)))
    want = _jax_out(q, kp, vp, tables, lengths, ks, vs)
    got = n(paged_decode_split_plain(t(q), t(kp), t(vp), t(tables),
                                     t(lengths), k_scale=t(ks),
                                     v_scale=t(vs), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert (got[0] == 0).all()


def test_split_plain_agrees_with_gather_plain():
    """The two plain versions of K2 (the gather path the CPU runs, and
    the kernel's split arithmetic) on one GQA input, in fp32."""
    kp, vp, q, tables, lengths = _split_case(14, 40, 8, 2, 32, 8,
                                             _SPLIT_LENGTHS, 6)
    args = (t(q), t(kp), t(vp), t(tables), t(lengths))
    np.testing.assert_allclose(n(paged_decode_split_plain(*args, chunk=16)),
                               n(paged_decode_plain(*args)),
                               rtol=2e-5, atol=2e-5)

