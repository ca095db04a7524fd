"""Port parity for GPipe over 'pp' (``tpu_composer_torch/parallel/
pipeline.py`` and the 'pp' path of the train step): twins of
``tests/test_pipeline.py`` and of the pipeline cases of
``tests/test_train_integration.py``.

The port side runs on one gloo world of 4 CPU ranks
(``tests/torch_dist.py``), started once for this file. The JAX side is
the JAX package's ``pipelined_forward`` and pipelined train step on a
mesh of the same shape over the host devices (``tests/conftest.py``
forces 8), from the same params (the JAX state's stacked tree, carried
over as numpy) on the same tokens. JAX's (dp, pp, tp) = 8-device case
does not fit a world of 4: pp = 2 × tp = 2 and pp = 2 × dp = 2 take its
place.

Tolerances (fp32):
- logits 2e-4 absolute (``tests/test_pipeline.py``);
- losses 2e-5 relative, grad norms 1e-4 relative, and the first step's
  gradients, gathered whole, 1e-4 × max(1, max|ref|) per leaf against
  ``jax.grad`` of the unpipelined JAX loss on one device, the embedding
  included (``tests/test_torch_train_mesh.py``'s limits);
- the pipelined step's first loss against the one-device port step's,
  2e-5 relative (``test_train_integration.py`` holds JAX's to 1e-4
  absolute).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dist import World
from tpu_composer.models import transformer as jtr
from tpu_composer.models.transformer import ModelConfig as JaxConfig
from tpu_composer.parallel import pipeline as jpipe
from tpu_composer.parallel.mesh import make_mesh as jax_make_mesh
from tpu_composer.parallel.train import TrainConfig as JaxTrainConfig
from tpu_composer.parallel.train import make_train_state as jax_train_state
from tpu_composer.parallel.train import make_train_step as jax_train_step
from tpu_composer_torch.convert import params_from_jax
from tpu_composer_torch.models import transformer as ttr
from tpu_composer_torch.parallel import pipeline as tpipe
from tpu_composer_torch.parallel import train as ttrain

torch.set_num_threads(1)

N = 4
# tests/test_pipeline.py's model (4 layers: one a stage at pp = 4).
PIPE = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, d_ff=64,
            max_seq=16)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _tokens(seed=1, b=4, s=16, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_setup(axes, model, train):
    """(JAX config, train config, mesh, state) over ``axes``."""
    jc = JaxConfig(dtype=jnp.float32, **model)
    jtc = JaxTrainConfig(model=jc, **train)
    n = int(np.prod(list(axes.values())))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:n])
    return jc, jtc, mesh, jax_train_state(jtc, jax.random.key(0), mesh)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _unstack(params):
    """The JAX stacked tree as the layer list of the unpipelined model."""
    layers = params["layers"]
    depth = len(next(iter(layers.values())))
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": [{w: a[i] for w, a in layers.items()}
                       for i in range(depth)]}


def _model(fields):
    return {**fields, "dtype": "float32"}


def test_stack_layers_roundtrip():
    jc = JaxConfig(dtype=jnp.float32, **PIPE)
    params = jtr.init_params(jc, jax.random.key(0))
    cfg = ttr.ModelConfig(dtype=torch.float32, **PIPE)
    tp = params_from_jax(_numpy(params), cfg, device="cpu")
    stacked = tpipe.stack_layers(tp["layers"])
    want = jpipe.stack_layers(params["layers"])
    assert sorted(stacked) == sorted(want)
    assert stacked["wqkv"].shape[0] == len(tp["layers"])
    for name, got in stacked.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(stacked["w_up"][2].numpy(),
                                  tp["layers"][2]["w_up"].numpy())


def test_stacked_layer_specs_drop_what_the_mesh_lacks():
    spec = ttr.param_specs(ttr.ModelConfig(**PIPE))["layers"][0]
    got = tpipe.stacked_layer_specs(spec)
    assert got["wo"] == ("pp", "tp", None, None) and got["ln1"] == ("pp",)

    class PPOnly:  # the one attribute the specs read off a mesh
        mesh_dim_names = ("pp",)

    got = tpipe.stacked_layer_specs(spec, mesh=PPOnly())
    assert got["wo"] == ("pp", None, None, None)
    assert got["w_gate"] == ("pp", None, None)


def test_train_state_from_jax_takes_the_stacked_layout():
    """A JAX train state built on a pipelined mesh (bf16, stacked layers)
    converts leaf for leaf, each in its JAX dtype, mu and nu too."""
    from tpu_composer_torch.convert import train_state_from_jax

    axes = _axes(pp=2)
    jc = JaxConfig(dtype=jnp.bfloat16, **PIPE)
    jtc = JaxTrainConfig(model=jc, pipeline_microbatches=2)
    mesh = jax_make_mesh(axes, devices=jax.devices()[:2])
    state = jax_train_state(jtc, jax.random.key(0), mesh)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    tc = ttrain.TrainConfig(model=ttr.ModelConfig(dtype=torch.bfloat16,
                                                  **PIPE),
                            pipeline_microbatches=2)
    got = train_state_from_jax(state_np, tc, device="cpu")
    assert isinstance(got["params"]["layers"], dict)
    assert got["params"]["layers"]["wqkv"].shape[0] == PIPE["n_layers"]
    want = jax.tree_util.tree_leaves(
        {"params": state_np["params"],
         "opt": {"mu": state_np["opt"][0].mu, "nu": state_np["opt"][0].nu}})
    have = ttrain.tree_leaves({"params": got["params"],
                               "opt": {"mu": got["opt"]["mu"],
                                       "nu": got["opt"]["nu"]}})
    assert len(have) == len(want)
    for h, w in zip(have, want):
        assert str(h.dtype).replace("torch.", "") == w.dtype.name
        np.testing.assert_array_equal(h.float().numpy(),
                                      w.astype(np.float32))


def test_pp1_falls_back_to_the_plain_stack():
    """Without a pp dim the stack applies directly, every microbatch
    count alike."""
    jc = JaxConfig(dtype=jnp.float32, **{**PIPE, "n_layers": 2})
    params = jtr.init_params(jc, jax.random.key(0))
    tokens = _tokens()
    want = np.asarray(jtr.forward(params, jnp.asarray(tokens), jc))
    cfg = ttr.ModelConfig(dtype=torch.float32, **{**PIPE, "n_layers": 2})
    tp = params_from_jax(_numpy(params), cfg, device="cpu")
    stacked = {**tp, "layers": tpipe.stack_layers(tp["layers"])}
    with torch.no_grad():
        got = tpipe.pipelined_forward(stacked, torch.from_numpy(tokens), cfg,
                                      None, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _axes(**sizes):
    """A mesh with every dim the JAX step names (dp, pp, sp, tp)."""
    return {"dp": sizes.get("dp", 1), "pp": sizes["pp"],
            "sp": sizes.get("sp", 1), "tp": sizes.get("tp", 1)}


FORWARD_CASES = [
    (_axes(pp=4), 1), (_axes(pp=4), 2), (_axes(pp=4), 4),
    (_axes(pp=2, tp=2), 2),
    (_axes(dp=2, pp=2), 2),
]


@pytest.mark.parametrize("axes,n_micro", FORWARD_CASES)
def test_pipelined_forward_matches_jax(world, axes, n_micro):
    train = {"pipeline_microbatches": n_micro}
    jc, _, mesh, state = _jax_setup(axes, PIPE, train)
    tokens = _tokens()
    want = np.asarray(jax.jit(
        lambda p, t: jpipe.pipelined_forward(p, t, jc, mesh, n_micro))(
            state["params"], jnp.asarray(tokens)))
    # The unpipelined forward agrees too (tests/test_pipeline.py).
    dense = np.asarray(jtr.forward(_unstack(state["params"]),
                                   jnp.asarray(tokens), jc))
    np.testing.assert_allclose(want, dense, atol=2e-4)
    blocks = axes["dp"]
    seen = set()
    for got, index in world.run("pipeline_forward", axes, _model(PIPE),
                                train, _numpy(state["params"]), tokens):
        np.testing.assert_allclose(got, np.split(want, blocks)[index],
                                   atol=2e-4)
        seen.add(index)
    assert seen == set(range(blocks))


def _jax_step(axes, model, train, tokens, steps=2):
    """(stacked params as numpy, losses, grad norms, first-step gradients
    of the unpipelined loss on one device, restacked)."""
    jc, jtc, mesh, state = _jax_setup(axes, model, train)
    params = _numpy(state["params"])
    grads = jax.jit(jax.grad(lambda p, t: jtr.loss_fn(p, t, jc)))(
        _unstack(state["params"]), jnp.asarray(tokens))
    stacked = {"embed": grads["embed"], "ln_f": grads["ln_f"],
               "layers": jpipe.stack_layers(grads["layers"])}
    step, batch_sharding = jax_train_step(jtc, mesh)
    toks = jax.device_put(jnp.asarray(tokens), batch_sharding)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, toks)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return (params, losses, norms,
            [np.asarray(g, np.float32)
             for g in jax.tree_util.tree_leaves(stacked)])


STEP_CASES = [
    # mesh, train config: M = 1 and M = 4 at pp = 4, where the bubble is
    # largest; pp x tp, pp x dp, and sp nested in the stages.
    (_axes(pp=4), {"pipeline_microbatches": 1}),
    (_axes(pp=4), {"pipeline_microbatches": 4}),
    (_axes(pp=2, tp=2), {"pipeline_microbatches": 2}),
    (_axes(dp=2, pp=2), {"pipeline_microbatches": 2}),
    (_axes(pp=2, sp=2), {"pipeline_microbatches": 2}),
]


@pytest.mark.parametrize("axes,train", STEP_CASES)
def test_pipelined_step_matches_jax(world, axes, train):
    tokens = _tokens(3)
    params, losses, norms, grads = _jax_step(axes, PIPE, train, tokens)
    one = ttrain.TrainConfig(model=ttr.ModelConfig(dtype=torch.float32,
                                                   **PIPE))
    state = ttrain.make_train_state(one, device="cpu")
    state["params"] = _unstack_port(params, one.model)
    first = float(ttrain.make_train_step(one)(state, torch.from_numpy(
        tokens))[1]["loss"])
    np.testing.assert_allclose(losses[0], first, rtol=2e-5)
    assert losses[1] < losses[0]
    for got_losses, got_norms, got_grads in world.run(
            "train_steps", axes, _model(PIPE), False, train, params,
            tokens, 2):
        np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
        np.testing.assert_allclose(got_norms, norms, rtol=1e-4)
        assert len(got_grads) == len(grads)
        for g, w in zip(got_grads, grads):
            err = float(np.abs(g - w).max())
            assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), err


def _unstack_port(params_np, cfg):
    return params_from_jax(_unstack(params_np), cfg, device="cpu")


def test_fit_on_pipelined_mesh_resumes_and_matches_one_device(world,
                                                              tmp_path):
    """``fit`` over pp = 2 x dp = 2: rank 0 saves the gathered (stacked)
    state, the resumed run restores each rank's stage and continues on
    the straight run's losses (1e-6 relative: the same steps on the same
    mesh), which equal the one-device ``fit``'s (2e-5 relative)."""
    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.workload.trainer import fit

    train = {"pipeline_microbatches": 2}
    res = world.run("fit_resume", _axes(dp=2, pp=2), _model(PIPE),
                    str(tmp_path), 4, 4, 16, train)
    cfg = ttr.ModelConfig(dtype=torch.float32, **PIPE)
    ds = PackedLMDataset(zipf_documents(0, n_docs=64, vocab=128),
                         seq_len=16, seed=0)
    single = fit(ttrain.TrainConfig(model=cfg, **train), ds, total_steps=4,
                 global_batch=4, log_every=1, device="cpu")
    want = [r["loss"] for r in single.history]
    for whole, resumed, resumed_from in res:
        np.testing.assert_allclose(whole, want, rtol=2e-5)
        assert resumed_from == 2
        for step, loss in resumed.items():
            np.testing.assert_allclose(loss, whole[step - 1], rtol=1e-6)


def test_refusals_match_jax(world):
    """MoE under pp and the flash inner with pp > 1 raise ``ValueError``
    as in the JAX package; so does a depth the stages cannot split."""
    for got in world.run("pipeline_refusals", _axes(pp=2, tp=2),
                         _model(PIPE)):
        assert "dense model only" in got["moe"]
        assert "not supported with pipeline parallelism" in got["flash"]
        assert "not divisible by pp=2" in got["depth"]
