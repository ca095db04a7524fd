"""Port parity for the MoE family: routing, the expert FFN, forward, loss
and gradients, its decode, paged, serving and quantized paths, and the
router's dtype across ``convert``, each against the JAX package on the
same numpy weights (or against the port's own solo run where the JAX
test holds the JAX package to its own).

Tolerances, each with its reason:
- routing tensors, fp32: dispatch and aux equal (the same ops in the
  same order on the same logits); combine within a few ulps (rtol
  1e-6): XLA's CPU exp and torch's differ by an ulp on some inputs, and
  the top-2 gates are ratios of exps;
- ``_moe_ffn`` and ``forward`` logits, fp32: atol 1e-4 (other summation
  order in the matmuls); bf16 ``_moe_ffn`` on identical bf16 inputs:
  atol 2e-2 (a bf16 ulp of the output, rounded once on both sides);
- aux and loss, fp32: rtol 1e-5;
- gradients, fp32: ``err <= 1e-4 * max(1, max|ref|)`` per leaf;
- decode against the full forward: 1e-3, as tests/test_decode.py;
- greedy tokens (generate, paged, engine, prefix): equal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import moe_configs, moe_world, n, t, to_numpy
from tpu_composer.models import moe as jmoe
from tpu_composer.models import quant as jquant
from tpu_composer.models.decode import generate as jax_generate
from tpu_composer_torch.convert import params_from_jax
from tpu_composer_torch.models import moe as tmoe
from tpu_composer_torch.models import transformer as ttr
from tpu_composer_torch.models.decode import decode_step, generate, prefill
from tpu_composer_torch.models.paged import paged_generate
from tpu_composer_torch.models.quant import QTensor, quantize_decode_params
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.parallel.train import tree_leaves, tree_map

torch.set_num_threads(1)


def _tokens(seed, b, s, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaf_close(got, want, rel=1e-4):
    got, want = n(got), n(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


# -- twins of tests/test_moe.py -------------------------------------------------

def test_forward_shapes_and_finite():
    _, _, c, params = moe_world(0)
    tokens = t(_tokens(1, 2, 16))
    logits, aux = tmoe.forward(params, tokens, c)
    assert logits.shape == (2, 16, c.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_param_specs_match_params():
    jc, c = moe_configs()
    params = tmoe.init_params(c, seed=0, device="cpu")
    specs = tmoe.param_specs(c)
    assert params.keys() == specs.keys()
    for layer, spec in zip(params["layers"], specs["layers"]):
        assert layer.keys() == spec.keys()
        assert all(spec[k] == () or len(spec[k]) == w.dim()
                   for k, w in layer.items())
    want = jax.tree_util.tree_map(
        tuple, jmoe.param_specs(jc),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert specs == want


def test_init_params_layout_and_dtypes_match_jax():
    jc, jp, c, _ = moe_world(0, dtype="bfloat16")
    mine = tmoe.init_params(c, seed=3, device="cpu")
    again = tmoe.init_params(c, seed=3, device="cpu")
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl, tdef = jax.tree_util.tree_flatten(mine)
    assert tdef == jdef
    for a, b, b2 in zip(jl, tl, tree_leaves(again)):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).replace("torch.", "") == str(a.dtype)
        assert torch.equal(b, b2)  # seeded
    assert mine["layers"][1]["w_router"].dtype == torch.float32


def test_routing_capacity_and_normalized_gates():
    logits = torch.randn(2, 8, 4, generator=torch.Generator().manual_seed(2))
    dispatch, combine, _ = tmoe._top_k_routing(logits, top_k=2, capacity=8)
    np.testing.assert_allclose(n(combine.sum(dim=(2, 3))), 1.0, atol=1e-5)
    np.testing.assert_allclose(n(dispatch.sum(dim=(2, 3))), 2.0, atol=1e-6)
    assert bool((dispatch.sum(dim=1) <= 1.0 + 1e-6).all())


def test_routing_drops_past_capacity():
    logits = torch.zeros(1, 6, 3)
    logits[..., 0] = 10.0
    dispatch, _, _ = tmoe._top_k_routing(logits, top_k=1, capacity=2)
    np.testing.assert_allclose(n(dispatch[0, :, 0, :].sum(-1)),
                               [1, 1, 0, 0, 0, 0], atol=1e-6)


def test_identical_experts_equal_dense_ffn():
    c = tmoe.MoEConfig(**{**dict(vocab_size=128, d_model=32, n_heads=4,
                                 d_ff=64, max_seq=64),
                          "n_layers": 1, "moe_period": 1, "n_experts": 4,
                          "top_k": 2, "capacity_factor": 2.0,
                          "dtype": torch.float32})
    dc = c.dense()
    dparams = ttr.init_params(dc, seed=3, device="cpu")
    mparams = tmoe.init_params(c, seed=4, device="cpu")
    layer = mparams["layers"][0]
    for name in ("ln1", "wqkv", "wo", "ln2"):
        layer[name] = dparams["layers"][0][name]
    for name in ("w_gate", "w_up", "w_down"):
        w = dparams["layers"][0][name]
        layer[name] = w[None].expand((c.n_experts,) + w.shape).contiguous()
    mparams["embed"], mparams["ln_f"] = dparams["embed"], dparams["ln_f"]
    tokens = t(_tokens(4, 2, 16))
    want = ttr.forward(dparams, tokens, dc)
    got, _ = tmoe.forward(mparams, tokens, c)
    np.testing.assert_allclose(n(got), n(want), atol=2e-4)


def test_loss_and_grads_finite():
    _, _, c, params = moe_world(7)
    live = tree_map(lambda p: p.requires_grad_(), params)
    loss = tmoe.loss_fn(live, t(_tokens(8, 2, 16)), c)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in tree_leaves(live))
    assert float(live["layers"][1]["w_router"].grad.abs().sum()) > 0


# -- routing and the expert FFN against the JAX package -------------------------

@pytest.mark.parametrize("top_k,capacity", [(1, 8), (2, 8), (2, 3), (1, 2)],
                         ids=["top1", "top2", "top2-past-capacity",
                              "top1-past-capacity"])
def test_routing_tensors_equal_jax(top_k, capacity):
    logits = np.random.default_rng(11).standard_normal((2, 12, 4)).astype(
        np.float32)
    want = jmoe._top_k_routing(jnp.asarray(logits), top_k, capacity)
    got = tmoe._top_k_routing(t(logits), top_k, capacity)
    np.testing.assert_array_equal(n(got[0]), n(want[0]))
    np.testing.assert_allclose(n(got[1]), n(want[1]), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    if capacity < 12 * top_k / 4:
        assert float(n(got[0]).sum()) < 2 * 12 * top_k  # something dropped


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("capacity", [None, 3], ids=["rule", "past-capacity"])
def test_moe_ffn_matches_jax(dtype, atol, capacity):
    jc, jp, tc, tp = moe_world(5, dtype=dtype)
    # The same bf16-representable inputs on both sides.
    x = np.random.default_rng(6).standard_normal((2, 12, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, jc.dtype)
    want, jaux = jmoe._moe_ffn(jx, jp["layers"][1], jc, capacity=capacity)
    got, taux = tmoe._moe_ffn(t(n(jx)).to(tc.dtype), tp["layers"][1], tc,
                              capacity=capacity)
    assert got.dtype == tc.dtype
    np.testing.assert_allclose(n(got), n(want), atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("n_kv_heads,attn_impl",
                         [(None, "reference"), (2, "flash")])
def test_forward_logits_and_aux_match_jax(n_kv_heads, attn_impl):
    jc, jp, tc, tp = moe_world(9, n_kv_heads=n_kv_heads, attn_impl=attn_impl)
    toks = _tokens(10, 2, 16)
    want, jaux = jmoe.forward(jp, jnp.asarray(toks), jc)
    got, taux = tmoe.forward(tp, t(toks), tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_loss_and_grads_match_jax(attn_impl):
    jc, jp, tc, tp = moe_world(12, attn_impl=attn_impl, moe_period=1)
    toks = _tokens(13, 2, 16)
    jl, jg = jax.value_and_grad(jmoe.loss_fn)(jp, jnp.asarray(toks), jc)
    live = tree_map(lambda p: p.requires_grad_(), tp)
    tl = tmoe.loss_fn(live, t(toks), tc)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jg)
    got = [p.grad for p in tree_leaves(live)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _leaf_close(g, w)


def test_bf16_tree_keeps_the_router_in_fp32():
    """convert reads each leaf's dtype from the JAX tree: the router of a
    bf16 MoE model stays fp32, the expert stacks stay bf16."""
    _, jp, tc, tp = moe_world(0, dtype="bfloat16")
    layer = tp["layers"][1]
    assert layer["w_router"].dtype == torch.float32
    assert layer["w_gate"].dtype == torch.bfloat16
    assert tp["layers"][0]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(n(layer["w_router"]),
                                  n(jp["layers"][1]["w_router"]))
    upcast = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    to_numpy(jp))
    with pytest.raises(ValueError, match="own dtypes"):
        params_from_jax(upcast, tc, device="cpu")


# -- decode, paged and quantized paths ------------------------------------------

@pytest.fixture(scope="module")
def decode_world():
    """tests/test_decode.py::TestMoEDecode's model."""
    return moe_world(0, d_model=64, d_ff=128, max_seq=32)


def test_moe_decode_matches_full_forward(decode_world):
    jc, jp, c, params = decode_world
    seq = t(_tokens(7, 2, 10))
    prompt, rest = seq[:, :4], seq[:, 4:]
    # Every prefix routes drop-free here (capacity_factor 2.0 gives
    # capacity(S) = S), so the JAX forward over the whole sequence holds
    # each step's logits at its position.
    want, _ = jmoe.forward(jp, jnp.asarray(n(seq)), jc)
    _, cache = prefill(params, prompt, c)
    for i in range(rest.shape[1]):
        logits, cache = decode_step(params, cache, rest[:, i], c)
        full, _ = tmoe.forward(params, seq[:, :4 + i + 1], c)
        err = float((full[:, -1] - logits).abs().max())
        assert err < 1e-3, f"step {i}: {err}"
        assert float(np.abs(n(logits) - n(want)[:, 4 + i]).max()) < 1e-3


def test_moe_generate_runs_jitted(decode_world):
    """The twin of the JAX test: a fixed shape, the same tokens twice, and
    the JAX package's jitted tokens (greedy, fp32)."""
    jc, jp, c, params = decode_world
    prompt = _tokens(8, 2, 4)
    out = generate(params, t(prompt), c, max_new_tokens=5)
    assert out.shape == (2, 5)
    assert torch.equal(out, generate(params, t(prompt), c, max_new_tokens=5))
    gen = jax.jit(functools.partial(jax_generate, config=jc,
                                    max_new_tokens=5))
    assert n(out).tolist() == np.asarray(gen(jp, prompt)).tolist()


def test_rejects_ragged_moe_prompts():
    _, _, c, params = moe_world(0, d_model=64, d_ff=96, n_experts=2, top_k=1,
                                vocab_size=64, max_seq=32)
    padded = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dense-only"):
        prefill(params, padded, c, max_seq=16, prompt_lens=[2, 3])
    from tpu_composer_torch.models.paged import (
        init_paged_cache,
        paged_prefill,
    )

    cache = init_paged_cache(c, 2, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="dense-only"):
        paged_prefill(params, padded, c, cache, prompt_lens=[2, 3])


def test_moe_paged_decode_matches_dense():
    jc, jp, c, params = moe_world(0, vocab_size=64, n_kv_heads=2)
    prompt = _tokens(4, 2, 6, vocab=64)
    dense = generate(params, t(prompt), c, max_new_tokens=8)
    paged = paged_generate(params, t(prompt), c, max_new_tokens=8,
                           num_blocks=16, block_size=8)
    assert torch.equal(dense, paged)
    assert n(dense).tolist() == np.asarray(
        jax_generate(jp, jnp.asarray(prompt), jc, max_new_tokens=8)).tolist()


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_moe_quantized_generate(n_kv_heads):
    """tests/test_quant.py's and tests/test_gqa.py's MoE cases: expert
    stacks quantize per (expert, channel) as the JAX package does, the
    router stays fp32, and int8 decode runs; the quantized tree equals
    the JAX package's."""
    jc, jp, c, params = moe_world(0, d_model=64, d_ff=96, n_experts=2,
                                  top_k=1, capacity_factor=4.0, max_seq=32,
                                  n_kv_heads=n_kv_heads)
    qp = quantize_decode_params(params)
    moe_layer = qp["layers"][1]
    assert isinstance(moe_layer["w_gate"], QTensor)
    assert moe_layer["w_gate"].scale.shape == (c.n_experts, 1, c.d_ff)
    assert not isinstance(moe_layer["w_router"], QTensor)
    jq = to_numpy(jquant.quantize_decode_params(jp))
    jl = jax.tree_util.tree_leaves(jq)
    tl = jax.tree_util.tree_leaves(
        qp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(n(b), n(a))
    prompt = t(_tokens(1, 1, 6))
    toks = generate(qp, prompt, c, max_new_tokens=4, max_seq=16,
                    kv_quant=True)
    assert toks.shape == (1, 4)
    plain = generate(params, prompt, c, max_new_tokens=4, max_seq=16)
    assert plain.shape == (1, 4)


# -- serving ------------------------------------------------------------------

def _engine_world():
    """tests/test_serving.py's MoE engine model (capacity_factor 4.0, so
    the solo prefill drops nothing)."""
    return moe_world(3, vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                     n_kv_heads=2, d_ff=64, max_seq=128, n_experts=4,
                     top_k=2, capacity_factor=4.0)


def test_moe_requires_chunked_admission():
    _, _, mc, mp = moe_world(0, vocab_size=64, n_layers=1, n_kv_heads=2,
                             n_experts=2, top_k=1)
    with pytest.raises(ValueError, match="chunked admission"):
        ContinuousBatchingEngine(mp, mc, slots=1, num_blocks=4)


def test_moe_serves_exactly_via_chunked_admission():
    """Chunked admission routes drop-free, so chunk pads cannot displace
    real tokens; with capacity_factor 4.0 the solo prefill drops nothing
    either, and every request equals its solo run (the port's generate,
    held to the JAX package's above; the last prompt also to JAX's)."""
    jc, jp, mc, mp = _engine_world()
    eng = ContinuousBatchingEngine(mp, mc, slots=2, num_blocks=32,
                                   block_size=8, prefill_chunk=8)
    prompts = [list(range(1, 14)), [9, 9, 9], [4, 5, 6, 7, 8]]
    reqs = [eng.submit(pr, 6) for pr in prompts]
    eng.run()
    for req, pr in zip(reqs, prompts):
        solo = generate(mp, torch.tensor([pr]), mc, max_new_tokens=6)
        assert req.tokens == solo[0].tolist(), (
            f"MoE request {req.req_id} diverged from its solo run")
    gold = jax_generate(jp, jnp.asarray([prompts[-1]], jnp.int32), jc,
                        max_new_tokens=6)
    assert reqs[-1].tokens == np.asarray(gold)[0].tolist()
    assert int(eng.cache.free_top) == 32


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moe_prefix_is_shared_and_exact(kv_quant):
    """An MoE prefix staged through admit + chunks, shared by two requests
    and then closed: each request equals its solo run, the prefix's
    blocks are held once, and the pool drains."""
    _, _, mc, mp = _engine_world()
    eng = ContinuousBatchingEngine(mp, mc, slots=3, num_blocks=40,
                                   block_size=8, prefill_chunk=8,
                                   kv_quant=kv_quant)
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, 64, 16).tolist()
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        ContinuousBatchingEngine(mp, mc, slots=1, num_blocks=8, block_size=4,
                                 prefill_chunk=8).register_prefix(
            prefix[:12])
    handle = eng.register_prefix(prefix)
    assert handle.n_blocks == 2 and int(eng.cache.free_top) == 38
    prompts = [prefix + rng.integers(1, 64, n).tolist() for n in (5, 11)]
    reqs = [eng.submit(p, 6, prefix=handle) for p in prompts]
    plain = eng.submit(rng.integers(1, 64, 9).tolist(), 6)
    eng.run()
    for req in reqs + [plain]:
        solo = generate(mp, torch.tensor([req.prompt]), mc, max_new_tokens=6,
                        kv_quant=kv_quant)[0].tolist()
        assert req.tokens == solo, req.req_id
    eng.close_prefix(handle)
    assert int(eng.cache.free_top) == 40
