"""Port parity for training on one card: loss_fn and its gradients,
AdamW, the train step, gradient accumulation, the JAX train-state
carry-over, the collective probe and qualify_slice, each against the JAX
package on the same numpy weights and tokens (JAX params carried over
through ``convert``).

Tolerances, each with its reason:
- loss, fp32: 1e-5 relative (same math, other summation order);
- gradients, fp32: ``err <= 1e-4 * max(1, max|ref|)`` per leaf;
- AdamW over 5 steps: fp32 rtol 1e-6, atol 1e-9 (elementwise, same
  order of operations); bf16 exactly equal (every op and every constant
  rounds to bf16 in both frameworks);
- the train step: loss and grad_norm rtol 1e-5 over 3 steps; params after
  a JAX state carried 2 steps in, atol 1e-6 (one fp32 AdamW update of
  lr 3e-4 differs by float association only);
- gradient accumulation: the tolerances of tests/test_parallel.py
  (loss rtol 1e-5, grad_norm rtol 1e-4, params rtol 2e-4 atol 2e-6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_parity import configs, n, t, to_numpy, world
from tpu_composer.models import transformer as jtr
from tpu_composer.parallel.mesh import make_mesh
from tpu_composer.parallel.train import TrainConfig as JaxTrainConfig
from tpu_composer.parallel.train import make_train_state as jax_train_state
from tpu_composer.parallel.train import make_train_step as jax_train_step
from tpu_composer.workload import acceptance as jacc
from tpu_composer_torch.convert import train_state_from_jax
from tpu_composer_torch.models import transformer as ttr
from tpu_composer_torch.parallel import train as ttrain
from tpu_composer_torch.parallel.collectives import allreduce_bandwidth_gbps
from tpu_composer_torch.workload import acceptance as tacc

torch.set_num_threads(1)

B, S = 2, 16


def _tokens(seed, b=B, s=S, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaf_close(got, want, rel):
    got, want = n(got), n(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def _jax_mesh():
    return make_mesh({"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])


# -- the model's training half -----------------------------------------------

@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_loss_and_grads_match_jax(n_kv_heads, attn_impl):
    jc, jp, tc, tp = world(0, n_kv_heads=n_kv_heads, attn_impl=attn_impl)
    toks = _tokens(1)
    jl, jg = jax.value_and_grad(jtr.loss_fn)(jp, jnp.asarray(toks), jc)
    live = ttrain.tree_map(lambda p: p.requires_grad_(), tp)
    tl = ttr.loss_fn(live, torch.from_numpy(toks), tc)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jg)
    got = [p.grad for p in ttrain.tree_leaves(live)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _leaf_close(g, w, 1e-4)


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_param_specs_match_jax_layout(n_kv_heads):
    jc, tc = configs(n_kv_heads=n_kv_heads)
    want = jax.tree_util.tree_map(
        tuple, jtr.param_specs(jc),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert ttr.param_specs(tc) == want


# -- AdamW against optax -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(dtype):
    _, jp, tc, tp = world(2, dtype=dtype)
    lr, wd = 3e-3, 0.01
    opt = optax.adamw(lr, weight_decay=wd)
    jstate = opt.init(jp)
    topt = ttrain.init_opt_state(tp)
    rng = np.random.default_rng(3)
    leaves = jax.tree_util.tree_leaves(jp)
    tleaves = ttrain.tree_leaves(tp)
    for _ in range(5):
        g_np = [rng.standard_normal(x.shape).astype(np.float32) * 0.01
                for x in leaves]
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(g, x.dtype) for g, x in zip(g_np, leaves)])
        updates, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [t(n(x)).to(p.dtype) for x, p in
              zip(jax.tree_util.tree_leaves(jg), tleaves)]
        ttrain.adamw_update(tleaves, tg, topt, lr, wd)
        leaves = jax.tree_util.tree_leaves(jp)
    assert int(topt["count"]) == int(jstate[0].count) == 5
    pairs = list(zip(tleaves, leaves))
    pairs += list(zip(ttrain.tree_leaves(topt["mu"]),
                      jax.tree_util.tree_leaves(jstate[0].mu)))
    pairs += list(zip(ttrain.tree_leaves(topt["nu"]),
                      jax.tree_util.tree_leaves(jstate[0].nu)))
    for got, want in pairs:
        assert got.dtype == getattr(torch, str(want.dtype)), (got.dtype,
                                                              want.dtype)
        if got.dtype == torch.float32:
            np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_array_equal(n(got), n(want))


# -- the train step --------------------------------------------------------------

def _jax_setup(attn_impl="reference", **kw):
    jc, tc = configs(attn_impl=attn_impl, **kw)
    jtc, ttc = JaxTrainConfig(model=jc), ttrain.TrainConfig(model=tc)
    mesh = _jax_mesh()
    jstate = jax_train_state(jtc, jax.random.key(0), mesh)
    jstep, sharding = jax_train_step(jtc, mesh)
    return jtc, ttc, jstate, jstep, sharding


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_train_step_matches_jax_over_three_steps(attn_impl):
    jtc, ttc, jstate, jstep, sharding = _jax_setup(attn_impl, n_kv_heads=2)
    tstate = train_state_from_jax(to_numpy(jstate), ttc, "cpu")
    tstep = ttrain.make_train_step(ttc)
    for i in range(3):
        toks = _tokens(10 + i)
        jstate, jm = jstep(jstate, jax.device_put(toks, sharding))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tstate["opt"]["count"]) == 3


def test_train_step_params_match_after_carrying_a_jax_state():
    """Two JAX steps, the state carried into the port, then step 3 in both
    frameworks from the same state: every param, mu and nu agree."""
    jtc, ttc, jstate, jstep, sharding = _jax_setup(n_kv_heads=2)
    for i in range(2):
        jstate, _ = jstep(jstate, jax.device_put(_tokens(20 + i), sharding))
    tstate = train_state_from_jax(to_numpy(jstate), ttc, "cpu")
    assert int(tstate["opt"]["count"]) == 2
    toks = _tokens(22)
    jstate, _ = jstep(jstate, jax.device_put(toks, sharding))
    tstate, _ = ttrain.make_train_step(ttc)(tstate, torch.from_numpy(toks))
    want = to_numpy(jstate)
    for part in ("params", "mu", "nu"):
        got = (tstate["params"] if part == "params"
               else tstate["opt"][part])
        ref = want["params"] if part == "params" else getattr(
            want["opt"][0], part)
        for g, w in zip(ttrain.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(n(g), w, atol=1e-6, rtol=0)


def test_train_state_from_jax_keeps_dtypes():
    jtc, ttc, jstate, _, _ = _jax_setup(dtype="bfloat16")
    state = train_state_from_jax(to_numpy(jstate), ttc, "cpu")
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["mu"]["layers"][0]["w_up"].dtype == torch.bfloat16
    assert state["opt"]["nu"]["ln_f"].dtype == torch.float32
    assert state["opt"]["count"].dtype == torch.int32


def test_grad_accumulation_matches_full_batch():
    _, tc = configs()
    toks = torch.from_numpy(_tokens(30, b=8))
    out = {}
    for accum in (1, 4):
        ttc = ttrain.TrainConfig(model=tc, grad_accum_steps=accum)
        state = ttrain.make_train_state(ttc, seed=0, device="cpu")
        out[accum] = ttrain.make_train_step(ttc)(state, toks)
    (s1, m1), (s4, m4) = out[1], out[4]
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m4["grad_norm"]), rtol=1e-4)
    for a, b in zip(ttrain.tree_leaves(s1["params"]),
                    ttrain.tree_leaves(s4["params"])):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-4, atol=2e-6)


def test_grad_accumulation_in_bf16_keeps_param_dtypes():
    _, tc = configs("bfloat16")
    ttc = ttrain.TrainConfig(model=tc, grad_accum_steps=2)
    state = ttrain.make_train_state(ttc, seed=0, device="cpu")
    state, m = ttrain.make_train_step(ttc)(
        state, torch.from_numpy(_tokens(31, b=4)))
    assert np.isfinite(float(m["loss"]))
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["params"]["ln_f"].dtype == torch.float32


def test_grad_accum_must_divide_batch():
    _, tc = configs()
    ttc = ttrain.TrainConfig(model=tc, grad_accum_steps=3)
    state = ttrain.make_train_state(ttc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.make_train_step(ttc)(state, torch.from_numpy(_tokens(32, b=4)))


@pytest.mark.parametrize("kw,exc", [
    ({"sp_impl": "zigzag"}, NotImplementedError),
    ({"sp_inner": "flash"}, NotImplementedError),
    ({"pipeline_microbatches": 2}, NotImplementedError),
    ({"sp_impl": "bogus"}, ValueError),
    ({"grad_accum_steps": 0}, ValueError),
])
def test_multi_device_fields_are_refused(kw, exc):
    _, tc = configs()
    ttc = ttrain.TrainConfig(model=tc, **kw)
    match = "slice 4" if exc is NotImplementedError else "sp_impl|grad_accum"
    with pytest.raises(exc, match=match):
        ttrain.make_train_step(ttc)
    with pytest.raises(exc, match=match):
        ttrain.make_train_state(ttc, device="cpu")


def test_train_config_defaults_match_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)
               if f.name != "model"}
    tfields = {f.name: f.default for f in dataclasses.fields(
        ttrain.TrainConfig) if f.name != "model"}
    assert tfields == jfields


# -- the collective probe and qualification ------------------------------------

def test_allreduce_probe_on_one_device_reports_zero():
    assert allreduce_bandwidth_gbps(["cpu"]) == 0.0
    with pytest.raises(NotImplementedError, match="slice 4"):
        allreduce_bandwidth_gbps(["cuda:0", "cuda:1"])


def test_model_flops_per_token_matches_jax():
    for kw in ({}, {"n_kv_heads": 2}):
        jc, tc = configs(**kw)
        assert tacc._model_flops_per_token(tc) == \
            jacc._model_flops_per_token(jc)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0),
    ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H100 NVL", 835.0),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table_matches_h100_names(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: name)
    assert tacc._bf16_peak_tflops(torch.device("cuda")) == peak
    assert tacc._bf16_peak_tflops(torch.device("cpu")) is None


def test_qualify_slice_on_cpu():
    _, tc = configs(attn_impl="flash", n_kv_heads=2)
    res = tacc.qualify_slice(device="cpu", batch=2, seq=16, model_config=tc,
                             allreduce_mb=1.0, steps=2)
    for key in ("n_devices", "allreduce_gbps", "attn_impl", "train_step_ms",
                "train_loss", "tokens_per_s", "tflops"):
        assert key in res, key
    assert res["n_devices"] == 1.0
    assert res["allreduce_gbps"] == 0.0
    assert res["attn_impl"] == "flash"
    assert "attn_fallback" not in res
    assert "mfu" not in res  # no peak for the CPU
    assert np.isfinite(res["train_loss"]) and res["tokens_per_s"] > 0
