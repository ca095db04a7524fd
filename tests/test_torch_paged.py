"""Port parity: tpu_composer_torch/models/paged.py against the JAX
package's models/paged.py.

Pool accounting: the same admit / extend / release / attach / detach /
drop sequence runs on both, and the tables, lengths, block counts, free
stack and refcounts agree exactly after every operation, refusals
included (a refused operation's bookkeeping is the cache's own); ``ok``
is a 0-dim bool tensor, as JAX's is an array. Decoding: paged greedy
tokens equal the JAX package's dense ``decode.generate``, through the
gather path and the kernel switch, fp and int8 pools; step logits agree
to fp32 atol 1e-4, and the pools on their first ``num_blocks`` blocks
(the port's pool carries a sink block past them). No pool operation
reads the device back.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import JaxGreedy, configs, n, t, world
from tpu_composer.models import paged as jpg
from tpu_composer_torch.models import paged as tpg
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

FP32_ATOL = 1e-4
STATE = ("block_tables", "length", "n_blocks", "free", "free_top",
         "refcount")


@pytest.fixture(scope="module")
def gqa():
    return world(0)


@pytest.fixture(scope="module")
def gold(gqa):
    jc, jp, _, _ = gqa
    return JaxGreedy(jc, jp)


def _state(cache):
    return {k: n(getattr(cache, k)) for k in STATE}


def _assert_same(tcache, jcache, what=""):
    ts, js = _state(tcache), _state(jcache)
    for k in STATE:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=f"{what}: {k}")


def _is_ok(ok) -> bool:
    """``ok`` as the one contract returns it: a 0-dim bool tensor."""
    assert torch.is_tensor(ok) and ok.dtype == torch.bool and ok.dim() == 0
    return bool(ok)


def _assert_refused(old, new, ok):
    """A refusal: ``ok`` False, the bookkeeping as it was and no block of
    the pool written but the sink."""
    assert not _is_ok(ok)
    for k in STATE:
        assert torch.equal(getattr(new, k), getattr(old["state"], k)), k
    for now, was in zip((new.k_pool, new.v_pool), old["pools"]):
        assert torch.equal(now[:, :new.sink], was[:, :new.sink])


def _before(cache):
    return {"state": cache._replace(**{k: getattr(cache, k).clone()
                                       for k in STATE}),
            "pools": (cache.k_pool.clone(), cache.v_pool.clone())}


class Twin:
    """A JAX pool and a port pool driven through the same operations,
    compared after each one."""

    def __init__(self, batch, num_blocks, bs, blocks_per_row=None):
        jc, tc = configs()
        self.j = jpg.init_paged_cache(jc, batch, num_blocks, bs,
                                      blocks_per_row=blocks_per_row)
        self.t = tpg.init_paged_cache(tc, batch, num_blocks, bs,
                                      blocks_per_row=blocks_per_row,
                                      device="cpu")
        _assert_same(self.t, self.j, "init")

    def _both(self, name, jfn, tfn, expect_ok=None):
        jres, tres = jfn(self.j), tfn(self.t)
        j_ok = t_ok = True
        if not isinstance(jres, jpg.PagedKVCache):
            jres, j_ok = jres[0], bool(jres[1])
            tres, t_ok = tres[0], _is_ok(tres[1])
        assert j_ok == t_ok, f"{name}: ok {t_ok} != JAX {j_ok}"
        if expect_ok is not None:
            assert t_ok == expect_ok, name
        if not t_ok:
            _assert_same(tres, self.j, f"{name}: a refusal must not touch it")
        self.j, self.t = jres, tres
        _assert_same(self.t, self.j, name)
        return t_ok

    def admit(self, mask, toks, expect_ok=None):
        return self._both(
            f"admit{mask}{toks}",
            lambda c: jpg.admit(c, jnp.asarray(mask, jnp.int32),
                                jnp.asarray(toks, jnp.int32)),
            lambda c: tpg.admit(c, mask, toks), expect_ok)

    def release(self, mask):
        self._both(f"release{mask}",
                   lambda c: jpg.release(c, jnp.asarray(mask, jnp.int32)),
                   lambda c: tpg.release(c, mask))

    def set_length(self, lengths):
        self.j = self.j._replace(length=jnp.asarray(lengths, jnp.int32))
        self.t = self.t._replace(
            length=torch.tensor(lengths, dtype=torch.int32))

    def extend(self, n_tok, active=None, expect_ok=None):
        return self._both(
            f"extend{n_tok}{active}",
            lambda c: jpg._extend_for_write(
                c, n_tok, None if active is None else jnp.asarray(active)),
            lambda c: tpg._extend_for_write(c, n_tok, active), expect_ok)

    def attach(self, slot, blocks, plen, extra, expect_ok=None):
        return self._both(
            f"attach{slot}",
            lambda c: jpg.attach_prefix(c, slot, jnp.asarray(blocks,
                                                             jnp.int32),
                                        plen, extra),
            lambda c: tpg.attach_prefix(c, slot, blocks, plen, extra),
            expect_ok)

    def detach(self, slot):
        self.j, jids, jn = jpg.detach_row_keep_blocks(self.j, slot)
        self.t, tids, tn = tpg.detach_row_keep_blocks(self.t, slot)
        _assert_same(self.t, self.j, "detach")
        assert n(tids).tolist() == n(jids).tolist() and int(tn) == int(jn)
        return n(tids).tolist(), int(tn)

    def drop(self, ids, count):
        self._both("drop",
                   lambda c: jpg.drop_blocks(c, jnp.asarray(ids, jnp.int32),
                                             count),
                   lambda c: tpg.drop_blocks(c, ids, count))


class TestPoolAccounting:
    def test_admit_allocates_ceil_blocks(self):
        tw = Twin(4, 16, 4)
        tw.admit([1, 1, 0, 0], [5, 4, 0, 0], expect_ok=True)
        assert n(tw.t.n_blocks).tolist() == [2, 1, 0, 0]
        assert int(tw.t.free_top) == 13

    def test_admit_over_capacity_is_all_or_nothing(self):
        tw = Twin(2, 3, 4)
        tw.admit([1, 1], [8, 8], expect_ok=False)  # wants 4 > 3

    def test_admit_beyond_row_table_is_all_or_nothing(self):
        tw = Twin(2, 16, 4, blocks_per_row=2)
        tw.admit([1, 0], [12, 0], expect_ok=False)  # wants 3 > MB 2

    def test_release_returns_blocks_for_reuse(self):
        tw = Twin(2, 4, 4)
        tw.admit([1, 1], [8, 8], expect_ok=True)
        tw.release([1, 0])
        assert int(tw.t.free_top) == 2
        tw.admit([1, 0], [8, 0], expect_ok=True)
        assert int(tw.t.free_top) == 0

    def test_extend_claims_only_on_boundary_and_refuses_cleanly(self):
        tw = Twin(2, 5, 4, blocks_per_row=3)
        tw.admit([1, 1], [3, 8], expect_ok=True)
        tw.set_length([3, 8])
        tw.extend(1, expect_ok=True)           # row 0 fits, row 1 claims
        assert int(tw.t.free_top) == 1
        tw.set_length([4, 9])
        tw.extend(1, active=[True, False], expect_ok=True)  # row 0 claims
        tw.set_length([8, 12])
        tw.extend(1, expect_ok=False)          # both need one, one is free
        tw.extend(5, active=[False, True], expect_ok=False)  # past MB

    def test_prefix_attach_detach_drop(self):
        tw = Twin(3, 12, 4)
        tw.admit([1, 0, 0], [8, 0, 0], expect_ok=True)
        ids, cnt = tw.detach(0)                # the registry holds 2 blocks
        prefix = ids[:cnt]
        tw.attach(1, prefix, 8, 5, expect_ok=True)
        tw.attach(2, prefix, 8, 1, expect_ok=True)
        rc = n(tw.t.refcount)[prefix]
        assert (rc == 3).all()                 # registry + two rows
        tw.attach(0, prefix, 8, 40, expect_ok=False)  # pool exhausted
        tw.release([0, 1, 1])
        tw.drop(prefix, len(prefix))
        assert int(tw.t.free_top) == 12
        assert sorted(n(tw.t.free).tolist()) == list(range(12))

    def test_attach_rejects_unaligned_prefix(self):
        _, tc = configs()
        cache = tpg.init_paged_cache(tc, 2, 8, 4, device="cpu")
        with pytest.raises(ValueError, match="prefix_len"):
            tpg.attach_prefix(cache, 0, [1, 2], 7, 1)

    def test_churn_conserves_blocks_in_lockstep(self):
        tw = Twin(4, 12, 4)
        rng = np.random.default_rng(7)
        for _ in range(12):
            mask = (rng.random(4) < 0.7).astype(np.int32).tolist()
            toks = rng.integers(1, 12, 4).tolist()
            tw.admit(mask, toks)
            tw.release([1, 1, 1, 1])
            assert int(tw.t.free_top) == 12
            assert sorted(n(tw.t.free).tolist()) == list(range(12))


class TestDecodeParity:
    def _prompts(self, seed, lens):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, 64, ln).tolist() for ln in lens]

    @pytest.mark.parametrize("attn_impl,kv_quant", [
        ("gather", False), ("kernel", False), ("gather", True),
        ("kernel", True)])
    def test_paged_generate_matches_jax_dense(self, gqa, gold, attn_impl,
                                              kv_quant):
        _, _, tc, tp = gqa
        prompts = self._prompts(1, (7, 3, 12))
        width = max(map(len, prompts))
        toks = np.zeros((3, width), np.int32)
        for r, p in enumerate(prompts):
            toks[r, :len(p)] = p
        got = tpg.paged_generate(
            tp, t(toks), tc, 10, num_blocks=24, block_size=4,
            prompt_lens=[len(p) for p in prompts], attn_impl=attn_impl,
            kv_quant=kv_quant)
        assert got.tolist() == gold(prompts, 10, kv_quant=kv_quant)

    def test_block_size_one_and_large(self, gqa, gold):
        _, _, tc, tp = gqa
        prompts = self._prompts(2, (5, 5))
        want = gold(prompts, 6)
        for bs, nb in ((1, 32), (64, 4)):
            got = tpg.paged_generate(tp, t(np.array(prompts)), tc, 6,
                                     num_blocks=nb, block_size=bs)
            assert got.tolist() == want

    @pytest.mark.parametrize("quant", [False, True])
    def test_chunk_and_step_logits_match_jax_paged(self, gqa, quant):
        """Prefill, a 3-token chunk and a masked single step against the
        JAX paged functions: same logits, same pool state, same pool
        bytes (int8 values may differ by one rounding step)."""
        jc, jp, tc, tp = gqa
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 64, (2, 6)).astype(np.int32)
        jcache = jpg.init_paged_cache(jc, 3, 16, 4, quant=quant)
        tcache = tpg.init_paged_cache(tc, 3, 16, 4, quant=quant,
                                      device="cpu")
        jl, jcache, jok = jpg.paged_prefill_rows(
            jp, jnp.asarray(toks), jc, jcache, jnp.array([2, 0], jnp.int32),
            prompt_lens=jnp.array([6, 4], jnp.int32))
        tl, tcache, tok = tpg.paged_prefill_rows(
            tp, t(toks), tc, tcache, [2, 0], prompt_lens=[6, 4])
        assert bool(jok) and _is_ok(tok)
        np.testing.assert_allclose(n(tl), n(jl), atol=FP32_ATOL)
        _assert_same(tcache, jcache, "prefill_rows")
        chunk = rng.integers(0, 64, (3, 3)).astype(np.int32)
        jl, jcache, jok = jpg.paged_decode_chunk(jp, jcache,
                                                 jnp.asarray(chunk), jc)
        tl, tcache, tok = tpg.paged_decode_chunk(tp, tcache, t(chunk), tc)
        assert bool(jok) and _is_ok(tok)
        np.testing.assert_allclose(n(tl)[[0, 2]], n(jl)[[0, 2]],
                                   atol=FP32_ATOL)
        _assert_same(tcache, jcache, "chunk")
        step = chunk[:, -1]
        active = np.array([False, True, True])
        jl, jcache, _ = jpg.paged_decode_step(jp, jcache, jnp.asarray(step),
                                              jc, active=jnp.asarray(active))
        tl, tcache, _ = tpg.paged_decode_step(tp, tcache, t(step), tc,
                                              attn_impl="kernel",
                                              active=active)
        np.testing.assert_allclose(n(tl)[[0, 2]], n(jl)[[0, 2]],
                                   atol=FP32_ATOL)
        _assert_same(tcache, jcache, "step")
        blocks = tcache.sink
        if quant:
            assert np.abs(n(tcache.k_pool[:, :blocks])
                          - n(jcache.k_pool)).max() <= 1
            np.testing.assert_allclose(n(tcache.v_scale[:, :blocks]),
                                       n(jcache.v_scale), rtol=1e-5)
        else:
            np.testing.assert_allclose(n(tcache.k_pool[:, :blocks]),
                                       n(jcache.k_pool), atol=1e-5)

    def test_exhausted_step_is_a_cache_noop(self, gqa):
        _, _, tc, tp = gqa
        toks = np.random.default_rng(5).integers(0, 64, (2, 4)).astype(
            np.int32)
        cache = tpg.init_paged_cache(tc, 2, 2, 4, device="cpu")
        _, cache, ok = tpg.paged_prefill(tp, t(toks), tc, cache)
        assert _is_ok(ok) and int(cache.free_top) == 0
        old = _before(cache)
        _, cache2, ok = tpg.paged_decode_step(tp, cache, t(toks[:, 0]), tc)
        _assert_refused(old, cache2, ok)
        # Releasing a row unblocks the other: the documented recovery.
        cache3 = tpg.release(cache2, [0, 1])
        _, cache4, ok = tpg.paged_decode_step(tp, cache3, t(toks[:, 0]), tc)
        assert _is_ok(ok) and int(cache4.length[0]) == 5

    def test_idle_row_with_stale_table_writes_nothing(self, gqa):
        """An idle slot whose stale table names a live row's block must
        not write into it (masked, never clamped): no block but the sink
        changes."""
        _, _, tc, tp = gqa
        cache = tpg.init_paged_cache(tc, 2, 4, 4, device="cpu")
        toks = torch.tensor([[5, 6, 7]], dtype=torch.int32)
        _, cache, ok = tpg.paged_prefill_rows(tp, toks, tc, cache, [0])
        assert _is_ok(ok)
        live = int(cache.block_tables[0, 0])
        tables = cache.block_tables.clone()
        tables[1, 0] = live  # the idle row's stale slot names it
        cache = cache._replace(block_tables=tables)
        before = (cache.k_pool.clone(), cache.v_pool.clone())
        _, cache, ok = tpg.paged_decode_step(
            tp, cache, torch.tensor([1, 2], dtype=torch.int32), tc,
            active=[False, False])
        assert _is_ok(ok)
        sink = cache.sink
        for now, was in zip((cache.k_pool, cache.v_pool), before):
            torch.testing.assert_close(now[:, :sink], was[:, :sink], rtol=0,
                                       atol=0)

    def test_prefill_over_capacity_leaves_pool_clean(self, gqa):
        _, _, tc, tp = gqa
        cache = tpg.init_paged_cache(tc, 2, 2, 4, device="cpu")
        toks = torch.zeros((2, 8), dtype=torch.int32)
        old = _before(cache)
        _, cache2, ok = tpg.paged_prefill(tp, toks, tc, cache)
        _assert_refused(old, cache2, ok)
        assert int(cache2.k_pool[:, :cache2.sink].abs().sum()) == 0

    def test_generate_pool_too_small_raises(self, gqa):
        _, _, tc, tp = gqa
        with pytest.raises(ValueError, match="cannot cover the worst case"):
            tpg.paged_generate(tp, torch.zeros((2, 5), dtype=torch.int32),
                               tc, 20, num_blocks=2, block_size=4)

    def test_rejects_unknown_attn_impl(self, gqa):
        _, _, tc, tp = gqa
        cache = tpg.init_paged_cache(tc, 1, 4, 4, device="cpu")
        with pytest.raises(ValueError, match="attn_impl"):
            tpg.paged_decode_step(tp, cache, torch.zeros(1, dtype=torch.int32),
                                  tc, attn_impl="pallas")


def _live_row(tc, tp):
    """Three slots over eight blocks of four, slot 0 holding five
    tokens."""
    cache = tpg.init_paged_cache(tc, 3, 8, 4, device="cpu")
    _, cache, ok = tpg.paged_prefill_rows(
        tp, torch.tensor([[5, 6, 7, 8, 9]]), tc, cache, torch.tensor([0]))
    assert _is_ok(ok)
    return cache


#: Each pool operation on :func:`_live_row`'s cache, with the host inputs
#: it is handed (each one upload).
POOL_CALLS = {
    "admit": (lambda tp, tc, c: tpg.admit(c, [0, 1, 0], [0, 6, 0]), 2),
    "_extend_for_write": (
        lambda tp, tc, c: tpg._extend_for_write(c, 4, [True, False, False]),
        1),
    "attach_prefix": (lambda tp, tc, c: tpg.attach_prefix(
        c, 1, c.block_tables[0, :1], 4, 3), 0),
    "paged_prefill_rows": (lambda tp, tc, c: tpg.paged_prefill_rows(
        tp, torch.tensor([[1, 2, 3, 0]]), tc, c, [2], prompt_lens=[3]), 2),
    "paged_decode_chunk": (lambda tp, tc, c: tpg.paged_decode_chunk(
        tp, c, torch.tensor([[1, 2], [3, 4], [5, 6]]), tc,
        active=[True, False, False]), 1),
}


@pytest.mark.parametrize("name", sorted(POOL_CALLS))
def test_the_cache_layer_reads_nothing_back(gqa, name):
    """Under an open span tree, each pool operation records no host sync
    but the uploads of the host inputs it was handed, and returns ``ok``
    as a 0-dim bool tensor."""
    _, _, tc, tp = gqa
    call, uploads = POOL_CALLS[name]
    cache = _live_row(tc, tp)
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    try:
        tree = tracing.open_tree("serving.step", "serving")
        try:
            ok = call(tp, tc, cache)[-1]
        finally:
            tree.close()
        syncs = [e["args"] for e in tracing.snapshot(cat="serving")
                 if e["name"] == "serving.sync"]
    finally:
        tracing.set_enabled(was)
        tracing.reset()
    assert [a["what"] for a in syncs] == ["upload"] * len(syncs)
    assert sum(a.get("count", 1) for a in syncs) == uploads
    assert _is_ok(ok)
