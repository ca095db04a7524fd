"""Port parity for the train step over a device mesh: dense (dp, sp, tp)
and MoE (dp, ep, sp, tp) meshes, every sequence-parallel strategy and
inner, gradient accumulation, ``fit``, ``qualify_slice`` and
``examples/train_lm.py`` under ``torchrun``.

The port side runs on one gloo world of 4 CPU ranks
(``tests/torch_dist.py``), started once for this file. The JAX side is
the JAX package's train step on a mesh of the same shape over the host
devices (``tests/conftest.py`` forces 8), from the same params (the JAX
state's, carried over as numpy) on the same tokens; the flash inner runs
the Pallas kernels in interpret mode as ``tests/test_parallel.py`` does.

Tolerances:
- fp32 losses 2e-5 relative (the same function, summed in another
  order); grad norms 1e-4 relative; the first step's gradients, gathered
  whole, 1e-4 × max(1, max|ref|) per leaf against ``jax.grad`` of the
  JAX loss on one device;
- MoE: losses 1e-4 relative (a router near-tie may resolve the other
  way, as in ``tests/test_torch_train.py``); the sharded forward's logits
  2e-4 and aux 1e-5 absolute, as ``tests/test_moe.py`` holds the JAX
  sharded forward;
- bf16: losses 3e-2 relative;
- ``fit`` over the mesh against the port's one-device ``fit`` 2e-5
  relative; resumed against straight 1e-6 (the same steps on the same
  mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist import World
from tpu_composer.models import moe as jmoe
from tpu_composer.models import transformer as jtr
from tpu_composer.models.moe import MoEConfig as JaxMoEConfig
from tpu_composer.models.transformer import ModelConfig as JaxConfig
from tpu_composer.parallel.mesh import make_mesh as jax_make_mesh
from tpu_composer.parallel.train import TrainConfig as JaxTrainConfig
from tpu_composer.parallel.train import make_train_state as jax_train_state
from tpu_composer.parallel.train import make_train_step as jax_train_step
from tpu_composer_torch.parallel import train as ttrain

torch.set_num_threads(1)

N = 4
DENSE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=64)
MOE = dict(DENSE, n_experts=4, top_k=2, capacity_factor=2.0, moe_period=2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _tokens(seed=1, b=4, s=32, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_run(axes, model, moe, train, tokens, steps=2, dtype="float32"):
    """The JAX step over ``axes`` on the host devices: (params as float32
    numpy, losses, grad norms, the first step's gradients on one
    device)."""
    fields = {**model, "dtype": getattr(jnp, dtype)}
    jc = JaxMoEConfig(**fields) if moe else JaxConfig(**fields)
    jtc = JaxTrainConfig(model=jc, **train)
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    state = jax_train_state(jtc, jax.random.key(0), mesh)
    # Copies (the step donates the state), each leaf in its own dtype.
    raw = jax.tree_util.tree_map(np.array, state["params"])
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), raw)
    loss_fn = (jmoe if moe else jtr).loss_fn
    grads = jax.tree_util.tree_leaves(jax.jit(jax.grad(
        lambda p, t: loss_fn(p, t, jc)))(
            jax.tree_util.tree_map(jnp.asarray, raw), jnp.asarray(tokens)))
    step, batch_sharding = jax_train_step(jtc, mesh)
    toks = jax.device_put(jnp.asarray(tokens), batch_sharding)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, toks)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return params, losses, norms, [np.asarray(g, np.float32) for g in grads]


def _model(fields, dtype="float32"):
    return {**fields, "dtype": dtype}


def _check_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), err


DENSE_CASES = [
    # mesh, model overrides, train config
    ({"dp": 2, "sp": 2, "tp": 1}, {"n_kv_heads": 2}, {}),
    ({"dp": 1, "sp": 2, "tp": 2}, {"n_kv_heads": 2}, {"sp_inner": "flash"}),
    ({"dp": 2, "sp": 1, "tp": 2}, {"n_kv_heads": 1}, {}),  # MQA: wkv whole
    ({"dp": 4, "sp": 1, "tp": 1}, {}, {}),
    ({"dp": 1, "sp": 4, "tp": 1}, {}, {"sp_impl": "zigzag",
                                      "sp_inner": "flash"}),
]


@pytest.mark.parametrize("axes,over,train", DENSE_CASES)
def test_dense_step_matches_jax_on_mesh(world, axes, over, train):
    model = {**DENSE, **over}
    tokens = _tokens()
    params, losses, norms, grads = _jax_run(axes, model, False, train,
                                            tokens)
    for got_losses, got_norms, got_grads in world.run(
            "train_steps", axes, _model(model), False, train, params,
            tokens, 2):
        np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
        np.testing.assert_allclose(got_norms, norms, rtol=1e-4)
        _check_grads(got_grads, grads)


@pytest.mark.parametrize("impl,inner", [
    ("ring", "flash"), ("zigzag", "einsum"), ("zigzag", "flash"),
    ("ulysses", "einsum"), ("ulysses", "flash"),
])
def test_every_sp_impl_gives_the_rings_loss(world, impl, inner):
    axes = {"dp": 1, "sp": 2, "tp": 2}
    tokens = _tokens(3)
    params, ring, _, _ = _jax_run(axes, DENSE, False, {}, tokens, steps=1)
    got = world.run("train_steps", axes, _model(DENSE), False,
                    {"sp_impl": impl, "sp_inner": inner}, params, tokens, 1)
    for losses, _, _ in got:
        np.testing.assert_allclose(losses, ring, rtol=2e-5)


MOE_CASES = [
    ({"dp": 1, "ep": 2, "sp": 1, "tp": 2}, {}),
    ({"dp": 2, "ep": 2, "sp": 1, "tp": 1}, {}),
    ({"dp": 1, "ep": 2, "sp": 2, "tp": 1}, {"sp_impl": "ulysses",
                                           "sp_inner": "flash"}),
]


@pytest.mark.parametrize("axes,train", MOE_CASES)
def test_moe_step_matches_jax_on_mesh(world, axes, train):
    tokens = _tokens(5)
    params, losses, norms, grads = _jax_run(axes, MOE, True, train, tokens)
    for got_losses, got_norms, got_grads in world.run(
            "train_steps", axes, _model(MOE), True, train, params, tokens,
            2):
        np.testing.assert_allclose(got_losses, losses, rtol=1e-4)
        np.testing.assert_allclose(got_norms, norms, rtol=1e-4)
        _check_grads(got_grads, grads)


@pytest.mark.parametrize("axes", [{"dp": 1, "ep": 2, "tp": 2},
                                  {"dp": 2, "ep": 2, "tp": 1}])
def test_moe_sharded_forward_matches_single_device(world, axes):
    jc = JaxMoEConfig(dtype=jnp.float32, **MOE)
    params = jmoe.init_params(jc, jax.random.key(5))
    tokens = _tokens(6, b=4, s=16)
    logits, aux = jmoe.forward(params, jnp.asarray(tokens), jc)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    blocks = axes["dp"] * axes["ep"]
    aux_by_block = {}
    for got, got_aux, index in world.run("moe_forward", axes, _model(MOE),
                                         params_np, tokens):
        want = np.split(np.asarray(logits), blocks)[index]
        np.testing.assert_allclose(got, want, atol=2e-4)
        aux_by_block[index] = got_aux
    # Each rank's aux is the mean over its rows; the mean over the row
    # blocks (as the step averages equal shards) is the global aux.
    assert sorted(aux_by_block) == list(range(blocks))
    np.testing.assert_allclose(np.mean(list(aux_by_block.values())),
                               float(aux), atol=1e-5)


def test_bf16_step_matches_jax(world):
    axes = {"dp": 1, "sp": 2, "tp": 2}
    tokens = _tokens(7)
    params, losses, _, _ = _jax_run(axes, DENSE, False, {"sp_inner": "flash"},
                                    tokens, dtype="bfloat16")
    for got, _, _ in world.run("train_steps", axes,
                               _model(DENSE, "bfloat16"), False,
                               {"sp_inner": "flash"}, params, tokens, 2):
        np.testing.assert_allclose(got, losses, rtol=3e-2)


def test_grad_accumulation_on_mesh(world):
    axes = {"dp": 2, "sp": 1, "tp": 2}
    tokens = _tokens(9, b=8)
    params, losses, norms, _ = _jax_run(axes, DENSE, False,
                                        {"grad_accum_steps": 2}, tokens)
    for accum in (1, 2):
        for got_losses, got_norms, _ in world.run(
                "train_steps", axes, _model(DENSE), False,
                {"grad_accum_steps": accum}, params, tokens, 2):
            np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
            np.testing.assert_allclose(got_norms, norms, rtol=1e-4)


def test_fit_on_mesh_resumes_and_matches_one_device(world, tmp_path):
    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.workload.trainer import fit

    axes = {"dp": 2, "sp": 1, "tp": 2}
    model = {**DENSE, "n_kv_heads": 2}
    res = world.run("fit_resume", axes, _model(model), str(tmp_path), 4, 4,
                    16)
    cfg = ModelConfig(dtype=torch.float32, **model)
    ds = PackedLMDataset(zipf_documents(0, n_docs=64, vocab=128), seq_len=16,
                         seed=0)
    single = fit(ttrain.TrainConfig(model=cfg), ds, total_steps=4,
                 global_batch=4, log_every=1, device="cpu")
    want = [r["loss"] for r in single.history]
    for whole, resumed, resumed_from in res:
        np.testing.assert_allclose(whole, want, rtol=2e-5)
        assert resumed_from == 2
        for step, loss in resumed.items():
            np.testing.assert_allclose(loss, whole[step - 1], rtol=1e-6)


def test_fit_refuses_a_batch_the_data_axes_do_not_divide(world):
    for msg in world.run("fit_indivisible", {"dp": 4}, _model(DENSE), 6):
        assert msg is not None and "data-axis product 4" in msg


def test_qualify_slice_on_cpu_mesh(world):
    small = dict(DENSE, max_seq=32)
    for res in world.run("qualify", {"dp": 2, "sp": 1, "tp": 2},
                         _model(small), 2, 32):
        assert res["n_devices"] == 4.0
        assert res["allreduce_gbps"] > 0 and res["transport"] == "gloo"
        assert res["tokens_per_s"] > 0
        assert np.isfinite(res["train_loss"])
    # Without a mesh the world's own size picks one (solve_mesh_axes(4)).
    for res in world.run("qualify", None, _model(small), 2, 32):
        assert res["n_devices"] == 4.0


def _run_train_lm(args, launcher, timeout=240):
    """``examples/train_lm.py`` as a subprocess in its own session, so a
    timeout kills the launcher and every rank it started."""
    import os
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    module = ["-m", "tpu_composer_torch.examples.train_lm"]
    cmd = [sys.executable, *(["-m", *launcher] if launcher else []),
           *module, "--device", "cpu",
           "--seq-len", "32", "--global-batch", "2", *args]
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def test_train_lm_under_torchrun():
    rc, out, err = _run_train_lm(
        ["--sp", "2", "--steps", "2"],
        ["torch.distributed.run", "--standalone", "--nproc_per_node=2"])
    assert rc == 0, err[-3000:]
    assert "'sp': 2" in out and "transport: gloo" in out
    assert out.count("done: step 2") == 1  # rank 0 reports


def test_train_lm_refuses_a_mesh_larger_than_the_world():
    rc, _, err = _run_train_lm(["--sp", "2", "--steps", "1"], [])
    assert rc == 2 and "torchrun" in err
