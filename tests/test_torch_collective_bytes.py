"""Collective bytes per mesh dim (``workload/collective_bytes.py``) against
their closed form, and against the JAX package's count from compiled HLO
(``workload/hlo_collectives.py``).

The port side runs on one gloo world of 4 CPU ranks
(``tests/torch_dist.py``); each rank records one train step of a small
fp32 decoder (GQA, 2 layers) and the counts are exact:

- dp = 2 × tp = 2: over dp, this rank's gradient bytes (one flat
  all-reduce), the loss and the squared gradient norm (4 bytes each);
  over tp, per layer four (B/dp, S, d) activations (the attention and
  ffn exits' all-reduce forward, their entries' cotangent sum backward),
  the embedding gathered once (V, d), and the squared norm.
- dp = 4 against JAX's dp-only step compiled on 4 host devices: both
  reduce every gradient once over dp and the loss (4 bytes). Named
  differences: the port also sums its squared gradient norm over dp (4
  bytes; JAX computes the norm from the reduced, replicated gradients),
  and XLA reduces the tied embedding's two gradient terms (the lookup's
  and the head's) each over dp before adding them, where the port adds
  them first: (V, d) more bytes on JAX's side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.torch_dist import World
from tpu_composer.models import ModelConfig as JaxConfig
from tpu_composer.parallel import TrainConfig as JaxTrainConfig
from tpu_composer.parallel import abstract_train_state, make_train_step
from tpu_composer.parallel.mesh import solve_mesh_axes as jax_solve
from tpu_composer.workload.hlo_collectives import summarize_compiled

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=16)
B, S = 8, 16
F32 = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _tokens():
    return np.random.default_rng(0).integers(
        0, MODEL["vocab_size"], (B, S)).astype(np.int32)


def _step(world, axes):
    return world.run("collective_bytes_step", axes,
                     {**MODEL, "dtype": "float32"}, _tokens())


def test_dp2_tp2_bytes_are_the_closed_form(world):
    axes = {"dp": 2, "sp": 1, "tp": 2}
    for summary, grad_bytes, rows in _step(world, axes):
        d, v, layers = MODEL["d_model"], MODEL["vocab_size"], \
            MODEL["n_layers"]
        assert rows == B // 2
        activation = rows * S * d * F32
        assert summary["per_axis_bytes"] == {
            "dp": grad_bytes + F32 + F32,
            "tp": layers * 4 * activation + v * d * F32 + F32,
        }
        assert summary["mesh_axes"] == axes
        assert summary["op_counts"] == {"all-reduce": 3 + 4 * layers + 1,
                                        "all-gather": 1}
        assert summary["total_bytes"] == sum(
            summary["per_axis_bytes"].values())
        ops = {(o["op"], o["axis"], o["bytes_per_instance"]):
               (o["group_size"], o["instances"]) for o in summary["ops"]}
        assert ops[("all-reduce", "dp", grad_bytes)] == (2, 1)
        assert ops[("all-reduce", "tp", activation)] == (2, 4 * layers)
        assert ops[("all-gather", "tp", v * d * F32)] == (2, 1)
        assert ops[("all-reduce", "dp", F32)] == (2, 2)


def _jax_dp_bytes() -> int:
    axes = jax_solve(4, dp=4)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(
        [axes[a] for a in axes]), tuple(axes))
    tc = JaxTrainConfig(model=JaxConfig(dtype=jnp.float32, **MODEL))
    step_fn, batch_sharding = make_train_step(tc, mesh)
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32, sharding=batch_sharding)
    compiled = step_fn.lower(abstract_train_state(tc, mesh), tokens).compile()
    summary = summarize_compiled(compiled, axes, mesh)
    assert set(summary["per_axis_bytes"]) == {"dp"}
    return summary["per_axis_bytes"]["dp"]


def test_dp4_bytes_equal_jaxs_compiled_step_but_the_named_terms(world):
    ranks = _step(world, {"dp": 4, "sp": 1, "tp": 1})
    jax_dp = _jax_dp_bytes()
    embed_bytes = MODEL["vocab_size"] * MODEL["d_model"] * F32
    for summary, grad_bytes, rows in ranks:
        assert rows == B // 4
        port_dp = summary["per_axis_bytes"]["dp"]
        assert port_dp == grad_bytes + F32 + F32
        squared_norm = F32
        assert port_dp - squared_norm == jax_dp - embed_bytes


# op, its keyword arguments, and what one call and its backward send
# over a dim of 2 ranks: (op name, bytes per instance) in any order, for
# a float32 (4, 6) input of 96 bytes.
ONE_OP = [
    ("all_reduce", {}, [("all-reduce", 96)]),
    ("enter_parallel", {}, [("all-reduce", 96)]),
    ("sum_over_", {}, [("all-reduce", 96)]),
    ("all_gather", {"axis": 0}, [("all-gather", 192)]),
    ("shard", {"axis": 0}, [("all-gather", 96)]),
    ("reduce_scatter", {"scatter_dimension": 0},
     [("reduce-scatter", 48), ("all-gather", 96)]),
    ("ring_shift", {}, [("collective-permute", 96)] * 2),
    # Rank 0 of the pair sends forward and receives the cotangent back,
    # rank 1 the reverse: each counts both.
    ("ppermute", {"perm": [(0, 1)]}, [("collective-permute", 96)] * 2),
    ("all_to_all", {"split_axis": 0, "concat_axis": 1},
     [("all-to-all", 96)] * 2),
]


@pytest.mark.parametrize("op,kw,sends", ONE_OP, ids=[c[0] for c in ONE_OP])
def test_each_collective_counts_forward_and_backward(world, op, kw, sends):
    axes = {"dp": 2, "sp": 1, "tp": 2}
    for rank, summary in enumerate(world.run(
            "recorded_collective", axes, "tp", op, (4, 6), kw)):
        got = sorted((o["op"], o["bytes_per_instance"])
                     for o in summary["ops"] for _ in range(o["instances"]))
        assert got == sorted(sends), (rank, summary)
        assert {o["axis"] for o in summary["ops"]} == {"tp"}
        assert all(o["group_size"] == 2 for o in summary["ops"])
