"""Port parity: tpu_composer_torch/models/serving.py, the continuous-
batching engine. The gold contract is the JAX suite's
(tests/test_serving.py): whatever the batch composition, admission
order, slot reuse or pool pressure, every greedy request's tokens EQUAL
the JAX package's solo ``decode.generate`` run on the same params.
Sampled requests equal the port's own solo ``generate`` with the same
seed (JAX's categorical stream cannot be reproduced in torch). Every
engine drains its pool back to full.

``test_compiles_are_bucketed`` has no twin here: the port runs eagerly
and compiles nothing, so there is no compile cache to count.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import JaxGreedy, n, world
from tpu_composer_torch.models.decode import filter_top_k, filter_top_p
from tpu_composer_torch.models.decode import generate as port_generate
from tpu_composer_torch.models.serving import (
    ContinuousBatchingEngine,
    _filter_rows,
    _pick_rows,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env():
    jc, jp, tc, tp = world(0)
    return tc, tp, JaxGreedy(jc, jp)


def _engine(env, **kw):
    tc, tp, _ = env
    return ContinuousBatchingEngine(tp, tc, **kw)


def _drained(eng):
    assert int(eng.cache.free_top) == eng.num_blocks
    assert sorted(n(eng.cache.free).tolist()) == list(range(eng.num_blocks))


def _port_solo(env, prompt, count, **kw):
    tc, tp, _ = env
    return port_generate(tp, torch.tensor([prompt]), tc, count,
                         **kw)[0].tolist()


class TestSoloEquality:
    def test_interleaved_requests_match_jax_solo_runs(self, env):
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 64, int(ln)).tolist()
                   for ln in rng.integers(3, 12, 6)]
        lens = [5, 9, 3, 12, 7, 4]  # finish at different times
        eng = _engine(env, slots=3, num_blocks=32, block_size=8)
        reqs = [eng.submit(p, k) for p, k in zip(prompts, lens)]
        eng.run()
        assert all(r.done for r in reqs)
        assert [r.tokens for r in reqs] == env[2](prompts, lens)
        _drained(eng)

    def test_single_slot_and_pool_pressure(self, env):
        prompts = [[1, 2, 3], [7, 8], [5, 5, 5, 5]]
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        assert [r.tokens for r in reqs] == env[2](prompts, 6)
        # The pool fits about one worst-case request at a time though two
        # slots exist: the others wait for blocks, then still match.
        eng = _engine(env, slots=2, num_blocks=4, block_size=8)
        reqs = [eng.submit([3, 1, 4, 1, 5], 8) for _ in range(3)]
        eng.run()
        gold = env[2]([[3, 1, 4, 1, 5]], 8)[0]
        assert all(r.tokens == gold for r in reqs)
        _drained(eng)

    def test_eos_releases_early(self, env):
        gold = env[2]([[2, 7, 1]], 10)[0]
        eng = _engine(env, slots=2, num_blocks=16, block_size=8,
                      eos_id=gold[0])
        req = eng.submit([2, 7, 1], 10)
        eng.run()
        assert req.tokens == gold[:1]
        _drained(eng)
        absent = next(x for x in range(64) if x not in gold)
        eng = _engine(env, slots=2, num_blocks=16, block_size=8,
                      eos_id=absent)
        req = eng.submit([2, 7, 1], 10)
        eng.run()
        assert req.tokens == gold

    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_kernel_switch_matches_jax(self, env, kv_quant):
        """attn_impl="kernel" (the paged kernel's plain twin on the CPU),
        fp and int8 pools."""
        eng = _engine(env, slots=2, num_blocks=16, block_size=8,
                      attn_impl="kernel", kv_quant=kv_quant)
        prompts = [[9, 8, 7], [1, 2]]
        reqs = [eng.submit(prompts[0], 5), eng.submit(prompts[1], 7)]
        eng.run()
        assert [r.tokens for r in reqs] == env[2](prompts, [5, 7],
                                                  kv_quant=kv_quant)
        _drained(eng)

    def test_blocks_per_row_bounds_the_table(self, env):
        eng = _engine(env, slots=2, num_blocks=64, block_size=8,
                      blocks_per_row=4)
        assert tuple(eng.cache.block_tables.shape) == (2, 4)
        reqs = [eng.submit([1, 2, 3], 6), eng.submit([9], 4)]
        eng.run()
        assert [r.tokens for r in reqs] == env[2]([[1, 2, 3], [9]], [6, 4])
        with pytest.raises(ValueError, match="positions per row"):
            eng.submit(list(range(1, 30)), 10)

    def test_bucket_padding_does_not_shrink_max_seq(self, env):
        prompt = [i % 64 for i in range(1, 66)]  # 65 tokens: bucket 128
        eng = _engine(env, slots=1, num_blocks=64, block_size=8)
        req = eng.submit(prompt, 10)
        eng.run()
        assert req.tokens == env[2]([prompt], 10)[0]


class TestChunkedAdmission:
    def test_chunked_prefill_requests_match_jax(self, env):
        prompts = [list(range(1, 21)), [5] * 11, [7, 9]]  # 3, 2, 1 chunks
        eng = _engine(env, slots=2, num_blocks=32, block_size=8,
                      prefill_chunk=8)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.run()
        assert [r.tokens for r in reqs] == env[2](prompts, 6)
        _drained(eng)

    def test_admission_streams_while_others_decode(self, env):
        eng = _engine(env, slots=2, num_blocks=32, block_size=8,
                      prefill_chunk=8)
        first = eng.submit([3, 1, 4], 12)
        eng.step()
        assert len(first.tokens) == 2
        long = eng.submit(list(range(1, 25)), 4)  # 3 chunks
        for _ in range(3):
            before = len(first.tokens)
            eng.step()
            assert len(first.tokens) == before + 1, "decode stalled"
        assert long.tokens
        eng.run()
        assert [first.tokens, long.tokens] == env[2](
            [[3, 1, 4], list(range(1, 25))], [12, 4])

    def test_free_slots_admit_during_long_admission(self, env):
        eng = _engine(env, slots=3, num_blocks=48, block_size=8,
                      prefill_chunk=8)
        prompts = [list(range(1, 49)), [4, 2], [7, 7, 7]]
        reqs = [eng.submit(p, 3) for p in prompts]  # 6, 1, 1 chunks
        for _ in range(6):
            eng.step()
        assert not reqs[0].tokens and reqs[1].tokens and reqs[2].tokens
        eng.run()
        assert [r.tokens for r in reqs] == env[2](prompts, 3)

    def test_chunked_int8_matches_jax_int8(self, env):
        eng = _engine(env, slots=2, num_blocks=32, block_size=8,
                      prefill_chunk=8, kv_quant=True, attn_impl="kernel")
        prompts = [list(range(2, 15)), [6, 1]]
        reqs = [eng.submit(p, 7) for p in prompts]
        eng.run()
        assert [r.tokens for r in reqs] == env[2](prompts, 7, kv_quant=True)
        _drained(eng)


class TestSampling:
    def test_sampled_requests_match_port_solo_runs(self, env):
        eng = _engine(env, slots=2, num_blocks=24, block_size=8)
        cases = [([5, 9, 2], 8, 0.8, 5, 0.9, 7),
                 ([1, 3], 6, 1.3, 0, 1.0, 11),      # temperature only
                 ([8, 8, 8, 8], 7, 0.5, 3, 1.0, 3)]  # top-k only
        reqs = [eng.submit(p, k, temperature=tm, top_k=tk, top_p=tp,
                           seed=s) for p, k, tm, tk, tp, s in cases]
        greedy = eng.submit([2, 4, 6], 7)
        eng.run()
        for req, (p, k, tm, tk, tp, s) in zip(reqs, cases):
            assert req.tokens == _port_solo(
                env, p, k, temperature=tm, top_k=tk or None,
                top_p=tp if tp < 1.0 else None, seed=s), req.req_id
        assert greedy.tokens == env[2]([[2, 4, 6]], 7)[0]

    def test_chunked_sampled_int8(self, env):
        eng = _engine(env, slots=2, num_blocks=32, block_size=8,
                      prefill_chunk=8, kv_quant=True)
        pr = list(range(2, 15))
        req = eng.submit(pr, 7, temperature=0.7, top_k=6, seed=21)
        eng.run()
        assert req.tokens == _port_solo(env, pr, 7, temperature=0.7,
                                        top_k=6, seed=21, kv_quant=True)

    def test_filter_rows_equals_jax_scalar_filters(self):
        """The filter half of _pick_rows, row by row, equals dividing by
        the temperature then the JAX package's filter_top_k and
        filter_top_p (and the port's own), exactly."""
        from tpu_composer.models.decode import filter_top_k as jk
        from tpu_composer.models.decode import filter_top_p as jp

        rng = np.random.default_rng(3)
        logits = rng.standard_normal((5, 64)).astype(np.float32)
        logits[1, :4] = 3.0  # ties at the k-th value
        temp = np.array([0.8, 1.0, 1.3, 0.5, 2.0], np.float32)
        top_k = np.array([5, 3, 0, 64, 1], np.int32)
        top_p = np.array([0.9, 1.0, 0.5, 0.3, 1.0], np.float32)
        got = n(_filter_rows(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(top_k),
                             torch.from_numpy(top_p)))
        for r in range(5):
            row = jnp.asarray(logits[r:r + 1]) / temp[r]
            mine = torch.from_numpy(logits[r:r + 1]) / float(temp[r])
            if top_k[r] > 0:
                row, mine = jk(row, int(top_k[r])), filter_top_k(
                    mine, int(top_k[r]))
            if top_p[r] < 1.0:
                row, mine = jp(row, float(top_p[r])), filter_top_p(
                    mine, float(top_p[r]))
            np.testing.assert_array_equal(got[r], n(row)[0])
            np.testing.assert_array_equal(got[r], n(mine)[0])

    def test_pick_rows_greedy_rows_take_the_argmax(self):
        logits = torch.from_numpy(
            np.random.default_rng(4).standard_normal((3, 64)).astype(
                np.float32))
        picks = _pick_rows(logits, torch.tensor([0.0, 0.7, 0.0]),
                           torch.tensor([0, 1, 0]), torch.ones(3),
                           torch.tensor([0.5, 0.5, 0.5], dtype=torch.float64))
        # temp 0 rows and the top-1 row are all the argmax.
        assert picks.tolist() == torch.argmax(logits, -1).tolist()

    def test_submit_validates_sampling_controls(self, env):
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        with pytest.raises(ValueError, match="top_k"):
            eng.submit([1], 2, top_k=-1)
        with pytest.raises(ValueError, match="top_p"):
            eng.submit([1], 2, top_p=0.0)


class TestPrefixCaching:
    def test_shared_prefix_requests_match_jax(self, env):
        eng = _engine(env, slots=3, num_blocks=48, block_size=8,
                      prefill_chunk=8)
        sys_prompt = list(range(1, 17))  # 2 blocks
        h = eng.register_prefix(sys_prompt)
        free_after_reg = int(eng.cache.free_top)
        tails = [[7, 3], [9], [5, 5, 5, 2]]
        reqs = [eng.submit(sys_prompt + tl, 6, prefix=h) for tl in tails]
        eng.step()
        eng.step()
        rc = n(eng.cache.refcount)[n(h.block_ids)]
        assert (rc == 3).all()  # the handle + two attached rows
        eng.run()
        assert [r.tokens for r in reqs] == env[2](
            [sys_prompt + tl for tl in tails], 6)
        assert int(eng.cache.free_top) == free_after_reg
        eng.close_prefix(h)
        _drained(eng)

    def test_prefix_with_sampling_and_cancel(self, env):
        eng = _engine(env, slots=2, num_blocks=32, block_size=8,
                      prefill_chunk=8)
        h = eng.register_prefix(list(range(2, 10)))
        sampled = eng.submit(h.tokens + [3, 1], 5, temperature=0.9,
                             top_k=4, seed=17, prefix=h)
        doomed = eng.submit(h.tokens + [9], 8, prefix=h)
        eng.step()
        eng.step()
        assert eng.cancel(doomed)
        eng.run()
        assert sampled.tokens == _port_solo(env, h.tokens + [3, 1], 5,
                                            temperature=0.9, top_k=4,
                                            seed=17)
        eng.close_prefix(h)
        _drained(eng)

    def test_close_while_request_queued_keeps_blocks_alive(self, env):
        eng = _engine(env, slots=1, num_blocks=32, block_size=8,
                      prefill_chunk=8)
        h = eng.register_prefix(list(range(1, 9)))
        eng.submit([2, 4, 6], 10)  # takes the only slot
        queued = eng.submit(h.tokens + [5, 5], 6, prefix=h)
        eng.step()
        assert not queued.tokens
        eng.close_prefix(h)
        assert (n(eng.cache.refcount)[n(h.block_ids)] >= 1).all()
        eng.run()
        assert queued.tokens == env[2]([h.tokens + [5, 5]], 6)[0]
        _drained(eng)

    def test_prefix_validation(self, env):
        eng = _engine(env, slots=1, num_blocks=16, block_size=8,
                      prefill_chunk=8)
        with pytest.raises(ValueError, match="multiple of"):
            eng.register_prefix([1, 2, 3])
        h = eng.register_prefix(list(range(1, 9)))
        with pytest.raises(ValueError, match="START with"):
            eng.submit([9] * 8 + [1], 2, prefix=h)
        with pytest.raises(ValueError, match="START with"):
            eng.submit(h.tokens, 2, prefix=h)
        eng.close_prefix(h)
        with pytest.raises(ValueError, match="closed"):
            eng.submit(h.tokens + [1], 2, prefix=h)
        bucketed = _engine(env, slots=1, num_blocks=16, block_size=8)
        with pytest.raises(ValueError, match="chunked admission"):
            bucketed.submit([1, 2], 2, prefix=h)
        with pytest.raises(ValueError, match="chunked admission"):
            bucketed.register_prefix(list(range(1, 9)))
        _drained(bucketed)


class TestCancellation:
    def test_cancel_in_every_lifecycle_stage(self, env):
        eng = _engine(env, slots=2, num_blocks=16, block_size=8,
                      prefill_chunk=8)
        decoding = eng.submit([1, 2, 3], 10)
        streaming = eng.submit(list(range(1, 25)), 5)  # 3 chunks
        waiting = eng.submit([7], 5)
        for _ in range(3):
            eng.step()
        assert decoding.tokens
        assert any(st["req"] is streaming for st in eng._admitting)
        assert eng.cancel(waiting) and waiting.done
        assert eng.cancel(streaming) and not streaming.tokens
        assert eng.cancel(decoding)
        assert eng.cancel(decoding) is False
        eng.run()
        _drained(eng)

    def test_cancel_frees_slot_for_next_request(self, env):
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        hog = eng.submit([5, 5], 40)
        eng.step()
        eng.cancel(hog)
        nxt = eng.submit([3, 1, 4], 4)
        eng.run()
        assert nxt.tokens == env[2]([[3, 1, 4]], 4)[0]

    def test_random_churn_conserves_and_stays_exact(self, env):
        rng = np.random.default_rng(42)
        eng = _engine(env, slots=3, num_blocks=48, block_size=8,
                      prefill_chunk=8)
        live, finished = [], []
        for _ in range(40):
            r = rng.random()
            if r < 0.4 and len(live) < 8:
                pr = rng.integers(0, 64, int(rng.integers(1, 20))).tolist()
                kw = ({"temperature": 0.8, "top_k": 5,
                       "seed": int(rng.integers(99))}
                      if rng.random() < 0.3 else {})
                req = eng.submit(pr, int(rng.integers(1, 7)), **kw)
                live.append(req)
            elif r < 0.5 and live:
                eng.cancel(live.pop(int(rng.integers(len(live)))))
            else:
                eng.step()
            finished += [q for q in live if q.done]
            live = [q for q in live if not q.done]
        eng.run()
        _drained(eng)
        greedy = [q for q in finished + live
                  if q.temperature == 0 and q.tokens][:6]
        want = env[2]([q.prompt for q in greedy],
                      [q.max_new_tokens for q in greedy])
        for q, w in zip(greedy, want):
            assert q.tokens == w[:len(q.tokens)]


class TestEngineHygiene:
    def test_rejects_impossible_requests(self, env):
        eng = _engine(env, slots=1, num_blocks=2, block_size=8)
        with pytest.raises(ValueError, match="worst-case"):
            eng.submit(list(range(30)), 20)
        eng = _engine(env, slots=1, num_blocks=3, block_size=8)
        with pytest.raises(ValueError, match="worst-case"):
            eng.submit(list(range(1, 18)), 7)  # buckets to 32
        eng = _engine(env, slots=1, num_blocks=64, block_size=8)
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(list(range(1, 121)), 20)
        with pytest.raises(ValueError, match="prefill_chunk"):
            _engine(env, slots=1, num_blocks=8, prefill_chunk=0)

    @pytest.mark.parametrize("bad", [64, -1, 10**6])
    def test_submit_refuses_out_of_vocab_ids(self, env, bad):
        """The vocab is 64: an id outside it is refused on the host (on
        the card it would be a device-side assert in the embedding)."""
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        with pytest.raises(ValueError, match="outside the vocab"):
            eng.submit([1, 2, bad], 4)
        assert not eng._waiting
        req = eng.submit([1, 2, 63], 2)
        eng.run()
        assert req.done

    @pytest.mark.parametrize("bad", [64, -1])
    def test_register_prefix_refuses_out_of_vocab_ids(self, env, bad):
        eng = _engine(env, slots=1, num_blocks=8, block_size=8,
                      prefill_chunk=8)
        with pytest.raises(ValueError, match="outside the vocab"):
            eng.register_prefix([1] * 7 + [bad])
        assert int(eng.cache.free_top) == eng.num_blocks

    def test_step_events_include_the_prefill_token(self, env):
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        req = eng.submit([4, 2], 1)
        assert eng.step() == [(req.req_id, req.tokens[0])]
        assert req.done
        req2 = eng.submit([4, 2], 5)
        seen = []
        while not req2.done:
            seen.extend(tok for rid, tok in eng.step() if rid == req2.req_id)
        assert seen == req2.tokens == env[2]([[4, 2]], 5)[0]

    def test_engine_runs_on_the_params_device(self, env):
        eng = _engine(env, slots=1, num_blocks=8, block_size=8)
        assert eng.device == torch.device("cpu")
        assert eng.cache.k_pool.device == torch.device("cpu")
        assert eng.cache.block_tables.dtype == torch.int32
