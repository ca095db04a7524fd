"""Port parity for speculative decoding: greedy draft-and-verify must
reproduce target greedy decoding EXACTLY, for any draft, over dense and
paged caches (twins of tests/test_speculative.py), and the port's tokens
equal the JAX package's on the same weights.

Tolerances: tokens equal everywhere; ``decode_chunk`` against T single
steps, logits 2e-4 and cache contents 1e-5 (tests/test_speculative.py's).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import moe_world, n, t, world
from tpu_composer.models.decode import generate as jax_generate
from tpu_composer.models.speculative import (
    speculative_generate as jax_speculative_generate,
)
from tpu_composer_torch.models.decode import (
    decode_chunk,
    decode_step,
    generate,
    prefill,
)
from tpu_composer_torch.models.quant import quantize_decode_params
from tpu_composer_torch.models.speculative import (
    paged_speculative_generate,
    speculative_generate,
)

torch.set_num_threads(1)

BASE = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=8, n_kv_heads=2,
            d_ff=192, max_seq=96)


def _world(seed, **kw):
    return world(seed, **{**BASE, **kw})


def _prompt(seed, s, vocab=128):
    return t(np.random.default_rng(seed).integers(0, vocab, (1, s)).astype(
        np.int32))


@pytest.fixture(scope="module")
def target():
    return _world(0)


@pytest.fixture(scope="module")
def weak_draft():
    return _world(7, n_layers=1, d_ff=96)


class TestSpeculativeExactness:
    @pytest.mark.parametrize("gamma", [1, 2, 3, 4])
    def test_matches_target_greedy_with_weak_draft(self, target, weak_draft,
                                                   gamma):
        _, _, c, params = target
        _, _, dc, draft = weak_draft
        prompt = _prompt(1, 6)
        ref = generate(params, prompt, c, max_new_tokens=16, max_seq=96)
        spec = speculative_generate(params, draft, prompt, c,
                                    draft_config=dc, max_new_tokens=16,
                                    gamma=gamma, max_seq=96)
        assert spec.tolist() == ref.tolist()

    def test_perfect_draft_accepts_everything(self, target):
        _, _, c, params = target
        prompt = _prompt(2, 4)
        ref = generate(params, prompt, c, max_new_tokens=12, max_seq=96)
        spec = speculative_generate(params, params, prompt, c,
                                    max_new_tokens=12, gamma=4, max_seq=96)
        assert spec.tolist() == ref.tolist()

    def test_quantized_draft(self, target):
        _, _, c, params = target
        draft = quantize_decode_params(params)
        prompt = _prompt(3, 5)
        ref = generate(params, prompt, c, max_new_tokens=12, max_seq=96)
        spec = speculative_generate(params, draft, prompt, c,
                                    max_new_tokens=12, gamma=3, max_seq=96)
        assert spec.tolist() == ref.tolist()

    def test_gqa_and_mqa_targets(self):
        _, _, c, params = _world(2, n_kv_heads=1)
        _, _, dc, draft = _world(3, n_kv_heads=1, n_layers=1)
        prompt = torch.tensor([[9, 4, 17]], dtype=torch.int32)
        ref = generate(params, prompt, c, max_new_tokens=10, max_seq=96)
        spec = speculative_generate(params, draft, prompt, c,
                                    draft_config=dc, max_new_tokens=10,
                                    gamma=2, max_seq=96)
        assert spec.tolist() == ref.tolist()

    def test_rejects_batch_and_capacity_errors(self, target):
        _, _, c, params = target
        with pytest.raises(ValueError, match="batch 1"):
            speculative_generate(params, params,
                                 torch.zeros((2, 4), dtype=torch.int32), c,
                                 max_new_tokens=4)
        with pytest.raises(ValueError, match="gamma must be"):
            speculative_generate(params, params,
                                 torch.zeros((1, 4), dtype=torch.int32), c,
                                 max_new_tokens=4, gamma=0)
        with pytest.raises(ValueError, match="cache capacity"):
            speculative_generate(params, params,
                                 torch.zeros((1, 90), dtype=torch.int32), c,
                                 max_new_tokens=16, gamma=4, max_seq=96)

    def test_matches_the_jax_package(self, target, weak_draft):
        """Cross-framework: the same weights, prompt and gamma give the
        JAX package's speculative tokens and its target-only greedy run."""
        jc, jp, c, params = target
        jdc, jdp, dc, draft = weak_draft
        prompt = _prompt(4, 7)
        want = jax_speculative_generate(jp, jdp, jnp.asarray(n(prompt)), jc,
                                        draft_config=jdc, max_new_tokens=14,
                                        gamma=3, max_seq=96)
        got = speculative_generate(params, draft, prompt, c, draft_config=dc,
                                   max_new_tokens=14, gamma=3, max_seq=96)
        assert got.tolist() == np.asarray(want).tolist()
        ref = jax_generate(jp, jnp.asarray(n(prompt)), jc, max_new_tokens=14,
                           max_seq=96)
        assert got.tolist() == np.asarray(ref).tolist()


class TestDecodeChunk:
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_paged_speculative_matches_dense_and_target(self, target,
                                                        weak_draft,
                                                        kv_quant):
        _, _, c, params = target
        _, _, dc, draft = weak_draft
        prompt = _prompt(5, 5)
        ref = generate(params, prompt, c, max_new_tokens=12, max_seq=96,
                       kv_quant=kv_quant)
        dense = speculative_generate(params, draft, prompt, c,
                                     draft_config=dc, max_new_tokens=12,
                                     gamma=3, max_seq=96, kv_quant=kv_quant)
        paged = paged_speculative_generate(params, draft, prompt, c,
                                           num_blocks=8, block_size=8,
                                           draft_config=dc,
                                           max_new_tokens=12, gamma=3,
                                           kv_quant=kv_quant)
        assert paged.tolist() == dense.tolist() == ref.tolist()

    def test_paged_speculative_capacity_check(self, target):
        _, _, c, params = target
        with pytest.raises(ValueError, match="blocks"):
            paged_speculative_generate(
                params, params, torch.zeros((1, 6), dtype=torch.int32), c,
                num_blocks=2, block_size=8, max_new_tokens=32, gamma=4)

    def test_chunk_equals_stepwise(self, target):
        """decode_chunk(T) equals T successive decode_steps: the same
        logits, the same cache contents (verify's correctness)."""
        _, _, c, params = target
        rng = np.random.default_rng(6)
        prompt = t(rng.integers(0, 128, (2, 5)).astype(np.int32))
        toks = t(rng.integers(0, 128, (2, 3)).astype(np.int32))
        _, cache_a = prefill(params, prompt, c, max_seq=32)
        chunk_logits, cache_a = decode_chunk(params, cache_a, toks, c)
        _, cache_b = prefill(params, prompt, c, max_seq=32)
        step_logits = []
        for i in range(3):
            lg, cache_b = decode_step(params, cache_b, toks[:, i], c)
            step_logits.append(lg)
        for i in range(3):
            assert float((chunk_logits[:, i] - step_logits[i]).abs().max()) \
                < 2e-4
        assert int(cache_a.length[0]) == int(cache_b.length[0])
        assert float((cache_a.k - cache_b.k).abs().max()) < 1e-5

    def test_moe_target_is_exact(self):
        """MoE targets verify exactly: decode chunks route drop-free, so a
        chunk computes what single steps would."""
        moe = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=96, max_seq=96, n_experts=2, top_k=1,
                   capacity_factor=2.0, moe_period=2)
        jc, jp, mc, mp = moe_world(0, n_layers=2, **moe)
        _, _, dc, dp = moe_world(5, n_layers=1, **moe)
        prompt = torch.tensor([[9, 4, 17, 2]], dtype=torch.int32)
        ref = generate(mp, prompt, mc, max_new_tokens=10, max_seq=96)
        spec = speculative_generate(mp, dp, prompt, mc, draft_config=dc,
                                    max_new_tokens=10, gamma=3, max_seq=96)
        assert spec.tolist() == ref.tolist()
        paged = paged_speculative_generate(mp, dp, prompt, mc, num_blocks=4,
                                           block_size=8, draft_config=dc,
                                           max_new_tokens=10, gamma=3)
        assert paged.tolist() == ref.tolist()
        gold = jax_generate(jp, jnp.asarray(n(prompt)), jc, max_new_tokens=10,
                            max_seq=96)
        assert spec.tolist() == np.asarray(gold).tolist()

    def test_draft_max_seq_bounds_capacity(self):
        _, _, c, params = _world(0, max_seq=256)
        _, _, dc, draft = _world(1, max_seq=32, n_layers=1)
        with pytest.raises(ValueError, match="cache capacity"):
            speculative_generate(params, draft,
                                 torch.zeros((1, 20), dtype=torch.int32), c,
                                 draft_config=dc, max_new_tokens=16, gamma=4)

