"""Port parity: tpu_composer_torch's quant, transformer, convert and
decode modules against the JAX package on the same params and inputs.

Tolerances: fp32 logits atol 1e-4 (same math, other summation order);
bf16 logits atol 2e-2 (bf16 rounds at other places in the two
frameworks; the logits here are O(0.1)); int8 values and scales are
bit-equal (same IEEE ops); the top-k / top-p filters are exact; greedy
tokens are equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import JaxGreedy, n, t, to_numpy, world
from tpu_composer.models import decode as jdec
from tpu_composer.models import quant as jquant
from tpu_composer.models import transformer as jtr
from tpu_composer_torch.convert import params_from_jax
from tpu_composer_torch.models import decode as tdec
from tpu_composer_torch.models import quant as tquant
from tpu_composer_torch.models import transformer as ttr

torch.set_num_threads(1)

FP32_ATOL = 1e-4
BF16_ATOL = 2e-2


@pytest.fixture(scope="module")
def gqa():
    return world(0)


@pytest.fixture(scope="module")
def gold(gqa):
    jc, jp, _, _ = gqa
    return JaxGreedy(jc, jp)


def _tokens(seed, b, s, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# -- quant -------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((32, 3, 4, 8), (0,)),      # wqkv
    ((4, 8, 32), (0, 1)),       # wo
    ((64, 32), (1,)),           # embed
    ((5, 7, 16), (-1,)),        # a KV cache row (quantize_kv)
])
def test_quantize_weight_bit_equal(shape, axes):
    w = np.random.default_rng(1).standard_normal(shape, np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w), axes)
    tq = tquant.quantize_weight(t(w), axes)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(n(tq.q), n(jq.q))
    np.testing.assert_array_equal(n(tq.scale), n(jq.scale))
    np.testing.assert_array_equal(n(tquant.resolve(tq, torch.float32)),
                                  n(jquant.resolve(jq, jnp.float32)))


def test_resolve_is_identity_for_tensors():
    w = torch.ones(4, 4)
    assert tquant.resolve(w, torch.float32) is w


@pytest.mark.parametrize("quantized", [False, True])
def test_embedding_lookup_matches_jax(quantized):
    embed = np.random.default_rng(2).standard_normal((50, 16), np.float32)
    toks = np.array([[3, 7], [11, 0]], np.int32)
    je, te = jnp.asarray(embed), t(embed)
    if quantized:
        je, te = (jquant.quantize_weight(je, (1,)),
                  tquant.quantize_weight(te, (1,)))
    want = jquant.embedding_lookup(je, jnp.asarray(toks), jnp.float32)
    got = tquant.embedding_lookup(te, t(toks), torch.float32)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_quantize_decode_params_matches_jax(kv_heads):
    jc, jp, tc, tp = world(3, n_kv_heads=kv_heads)
    jq = to_numpy(jquant.quantize_decode_params(jp))
    tq = tquant.quantize_decode_params(tp)
    assert isinstance(tq["embed"], tquant.QTensor)
    jl = jax.tree_util.tree_leaves(jq)
    tl = jax.tree_util.tree_leaves(
        tq, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(n(b), a)


def test_quantize_decode_params_rejects_moe_stacks():
    """A 3-dim expert stack (E, D, F) is no longer refused: it takes
    per-(expert, channel) scales, as the JAX package's ``_MOE_FFN``."""
    _, _, _, tp = world(0)
    stack = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 32, 64), np.float32))
    layer = dict(tp["layers"][0], w_gate=stack)
    got = tquant.quantize_decode_params({**tp, "layers": [layer]})
    got = got["layers"][0]["w_gate"]
    want = jquant.quantize_weight(jnp.asarray(n(stack)), (1,))
    assert got.scale.shape == (2, 1, 64)
    np.testing.assert_array_equal(n(got.q), n(want.q))
    np.testing.assert_array_equal(n(got.scale), n(want.scale))


# -- transformer / convert -----------------------------------------------------

@pytest.mark.parametrize("kv_heads", [None, 2])
def test_init_params_layout_matches_jax(kv_heads):
    jc, jp, tc, _ = world(0, n_kv_heads=kv_heads)
    mine = ttr.init_params(tc, seed=5, device="cpu")
    again = ttr.init_params(tc, seed=5, device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = jax.tree_util.tree_flatten(mine)
    assert tdef == jdef  # same keys, same nesting
    for a, b, b2 in zip(jl, tl, jax.tree_util.tree_leaves(again)):
        assert tuple(b.shape) == a.shape
        assert n(b).dtype == n(a).dtype
        torch.testing.assert_close(b, b2, rtol=0, atol=0)  # seeded
    w = mine["layers"][0]["w_gate"]
    assert 0.015 < float(w.std()) < 0.025  # N(0, 0.02)


def test_params_from_jax_casts_to_config_dtype():
    jc, jp, _, _ = world(0, dtype="bfloat16")
    tc = ttr.ModelConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(jc)
                            if f.name != "dtype"}, dtype=torch.bfloat16)
    tp = params_from_jax(to_numpy(jp), tc, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"][0]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(n(tp["layers"][1]["wkv"]),
                                  n(jp["layers"][1]["wkv"]))


@pytest.mark.parametrize("kv_heads,attn", [
    (None, "reference"), (2, "reference"), (2, "flash"), (1, "flash")])
def test_forward_logits_match_jax_fp32(kv_heads, attn):
    jc, jp, tc, tp = world(4, n_kv_heads=kv_heads, attn_impl=attn)
    toks = _tokens(5, 2, 16)
    want = jtr.forward(jp, jnp.asarray(toks), jc)
    got = ttr.forward(tp, t(toks), tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


def test_forward_logits_match_jax_bf16():
    jc, jp, tc, tp = world(6, dtype="bfloat16")
    toks = _tokens(7, 2, 16)
    want = jtr.forward(jp, jnp.asarray(toks), jc)
    got = ttr.forward(tp, t(toks), tc)
    assert got.dtype == torch.float32  # the tied head accumulates in fp32
    np.testing.assert_allclose(n(got), n(want), atol=BF16_ATOL)


def test_forward_int8_weights_match_jax(gqa):
    jc, jp, tc, tp = gqa
    toks = _tokens(8, 2, 12)
    want = jtr.forward(jquant.quantize_decode_params(jp), jnp.asarray(toks),
                       jc)
    got = ttr.forward(tquant.quantize_decode_params(tp), t(toks), tc)
    np.testing.assert_allclose(n(got), n(want), atol=FP32_ATOL)


# -- decode --------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_prefill_and_chunk_logits_match_jax(gqa, quant):
    jc, jp, tc, tp = gqa
    toks, chunk = _tokens(9, 3, 7), _tokens(10, 3, 3)
    lens = np.array([7, 4, 2], np.int32)
    jl, jcache = jdec.prefill(jp, jnp.asarray(toks), jc, quant=quant,
                              prompt_lens=jnp.asarray(lens))
    tl, tcache = tdec.prefill(tp, t(toks), tc, quant=quant,
                              prompt_lens=t(lens))
    np.testing.assert_allclose(n(tl), n(jl), atol=FP32_ATOL)
    assert n(tcache.length).tolist() == n(jcache.length).tolist()
    if quant:
        # K/V come out of projections summed in another order, so an
        # int8 value may sit one step over a rounding boundary.
        assert np.abs(n(tcache.k) - n(jcache.k)).max() <= 1
        np.testing.assert_allclose(n(tcache.v_scale), n(jcache.v_scale),
                                   rtol=1e-5)
    jl, jcache = jdec.decode_chunk(jp, jcache, jnp.asarray(chunk), jc)
    tl, tcache = tdec.decode_chunk(tp, tcache, t(chunk), tc)
    np.testing.assert_allclose(n(tl), n(jl), atol=FP32_ATOL)
    assert n(tcache.length).tolist() == n(jcache.length).tolist()
    tok = np.argmax(n(jl)[:, -1], axis=-1).astype(np.int32)
    jl, _ = jdec.decode_step(jp, jcache, jnp.asarray(tok), jc)
    tl, _ = tdec.decode_step(tp, tcache, t(tok), tc)
    np.testing.assert_allclose(n(tl), n(jl), atol=FP32_ATOL)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_greedy_matches_jax_ragged(gqa, gold, kv_quant):
    """A ragged batch (right-padded, prompt_lens) in one generate call:
    every row equals the JAX package's tokens."""
    _, _, tc, tp = gqa
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, ln).tolist() for ln in (3, 9, 17, 1)]
    want = gold(prompts, 10, kv_quant=kv_quant)
    width = max(map(len, prompts))
    toks = np.zeros((len(prompts), width), np.int32)
    for r, p in enumerate(prompts):
        toks[r, :len(p)] = p
    got = tdec.generate(tp, t(toks), tc, 10, kv_quant=kv_quant,
                        prompt_lens=t(np.array([len(p) for p in prompts])))
    assert got.dtype == torch.int32
    assert got.tolist() == want


def test_generate_uniform_batch_matches_jax(gqa):
    jc, jp, tc, tp = gqa
    toks = _tokens(12, 2, 6)
    want = jdec.generate(jp, jnp.asarray(toks), jc, max_new_tokens=8)
    got = tdec.generate(tp, t(toks), tc, 8)
    assert got.tolist() == n(want).tolist()


def test_generate_flash_config_matches_reference(gqa):
    """attn_impl="flash" prefill (the kernel's plain twin on the CPU)
    generates the same tokens as the reference einsum."""
    _, _, tc, tp = gqa
    toks = _tokens(13, 2, 16)
    ref = tdec.generate(tp, t(toks), tc, 8)
    fl = tdec.generate(tp, t(toks),
                       dataclasses.replace(tc, attn_impl="flash"), 8)
    assert fl.tolist() == ref.tolist()


def test_filters_match_jax_exactly():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((6, 64)).astype(np.float32)
    logits[0, :5] = 2.5  # ties at the k-th value
    logits[1] = 0.0      # a flat row
    for k in (1, 3, 5, 64, 100):
        np.testing.assert_array_equal(
            n(tdec.filter_top_k(t(logits), k)),
            n(jdec.filter_top_k(jnp.asarray(logits), k)))
    for p in (0.01, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            n(tdec.filter_top_p(t(logits), p)),
            n(jdec.filter_top_p(jnp.asarray(logits), p)))


def test_sample_categorical_is_the_inverse_cdf():
    logits = torch.tensor([[0.0, -torch.inf, 0.0, 0.0],
                           [5.0, 0.0, -torch.inf, -torch.inf]])
    cdf = torch.softmax(logits.double(), -1).cumsum(-1)
    for u in (0.0, 0.2, 0.34, 0.67, 0.9999):
        got = tdec.sample_categorical(logits, torch.tensor([u, u]))
        want = [int((cdf[r] > u).nonzero()[0]) for r in range(2)]
        assert got.tolist() == want
        assert 1 not in got[:1].tolist()  # -inf is never drawn


def test_sampled_generate_is_seeded_and_respects_top_k(gqa):
    _, _, tc, tp = gqa
    toks = t(_tokens(15, 1, 5))
    kw = dict(temperature=0.9, top_k=3, seed=7)
    a = tdec.generate(tp, toks, tc, 10, **kw)
    assert a.tolist() == tdec.generate(tp, toks, tc, 10, **kw).tolist()
    assert a.tolist() != tdec.generate(tp, toks, tc, 10, temperature=0.9,
                                       top_k=3, seed=8).tolist()
    # Every draw lies in the top-3 of the logits it was drawn from.
    logits, cache = tdec.prefill(tp, toks, tc)
    for tok in a[0].tolist():
        assert tok in torch.topk(logits[0], 3).indices.tolist()
        logits, cache = tdec.decode_step(tp, cache, torch.tensor([tok]), tc)


def test_generate_rejects_like_jax(gqa):
    jc, jp, tc, tp = gqa
    toks = np.zeros((1, 120), np.int32)
    for call in (
        lambda: jdec.generate(jp, jnp.asarray(toks), jc, 20),
        lambda: tdec.generate(tp, t(toks), tc, 20),
    ):
        with pytest.raises(ValueError, match="capacity"):
            call()
    with pytest.raises(ValueError, match="top_k"):
        tdec.generate(tp, t(toks[:, :4]), tc, 2, temperature=1.0, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        tdec.generate(tp, t(toks[:, :4]), tc, 2, temperature=1.0, top_p=1.5)
    with pytest.raises(ValueError, match="prompt_lens"):
        tdec.prefill(tp, t(toks[:, :4]), tc, prompt_lens=t(np.array([5])))
