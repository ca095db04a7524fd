"""Port parity for the slice solver: ``tpu_composer_torch/topology`` against
``tpu_composer/topology``, and the NVIDIA H100 row by its own rules.

Exact: every TPU row solves every count 1..512 and a seeded sample of
counts up to its ``max_chips`` to the same shape as JAX's, or fails with
the same error type and message; pinned topologies likewise. The H100
row: 1-8 GPUs are one host, whole hosts beyond, anything else refused
with the valid counts near it.
"""

from __future__ import annotations

import random

import pytest

from tpu_composer.topology import TPU_MODELS as JAX_MODELS
from tpu_composer.topology import TopologyError as JaxTopologyError
from tpu_composer.topology import solve_slice as jax_solve
from tpu_composer_torch.topology import (
    GPU_MODELS,
    TPU_MODELS,
    TopologyError,
    is_gpu_model,
    is_tpu_model,
    solve_slice,
)

H100 = "nvidia-h100-sxm"


def _outcome(solve, error, model, count, topology=""):
    """(shape fields) or (error type name, message) of one solve."""
    try:
        s = solve(model, count, topology)
    except error as e:
        return ("error", type(e).__name__, str(e))
    return (s.model, s.dims, s.num_chips, s.num_hosts, s.chips_per_host,
            s.topology, s.worker_chip_indices(s.num_hosts - 1))


def _same(model, count, topology=""):
    got = _outcome(solve_slice, TopologyError, model, count, topology)
    want = _outcome(jax_solve, JaxTopologyError, model, count, topology)
    assert got == want, (model, count, topology)


def test_tpu_rows_copied_unchanged():
    assert {n: vars(m) for n, m in TPU_MODELS.items()} == {
        n: vars(m) for n, m in JAX_MODELS.items()}


@pytest.mark.parametrize("model", sorted(JAX_MODELS))
def test_every_count_to_512_solves_as_jax(model):
    for count in range(0, 513):
        _same(model, count)


@pytest.mark.parametrize("model", sorted(JAX_MODELS))
def test_sampled_counts_to_max_solve_as_jax(model):
    rng = random.Random(f"topology-{model}")
    top = JAX_MODELS[model].max_chips
    counts = [rng.randint(513, top + 8) for _ in range(40)] if top > 512 \
        else []
    step = JAX_MODELS[model].chips_per_host
    counts += [c for c in (top - step, top, top + 1) if c > 512]
    for count in counts:
        _same(model, count)


@pytest.mark.parametrize("model,count,topology", [
    ("tpu-v4", 16, "2x2x4"), ("tpu-v4", 16, "4x2x2"), ("tpu-v4", 8, "2x2x4"),
    ("tpu-v4", 16, "1x1x16"), ("tpu-v4", 4, "2x2x1"), ("tpu-v4", 4, "1x2x2"),
    ("tpu-v4", 2, "1x1x2"), ("tpu-v5p", 64, "4x4x4"), ("tpu-v5e", 16, "4x4"),
    ("tpu-v5e", 32, "2x16"), ("tpu-v5e", 32, "1x32"), ("tpu-v6e", 8, "2x4"),
    ("tpu-v6e", 8, "8"), ("tpu-v5e", 4, "4"), ("tpu-v4", 16, "2xtwo"),
    ("tpu-v4", 16, "0x4x4"),
])
def test_pinned_topology_as_jax(model, count, topology):
    _same(model, count, topology)


@pytest.mark.parametrize("count", range(1, 9))
def test_h100_one_host(count):
    s = solve_slice(H100, count)
    assert (s.dims, s.num_hosts, s.chips_per_host) == ((count, 1), 1, count)
    assert s.topology == f"{count}x1"
    assert s.worker_chip_indices(0) == list(range(count))


@pytest.mark.parametrize("count,topology", [(16, "8x2"), (24, "8x3"),
                                            (40, "8x5"), (1016, "8x127")])
def test_h100_whole_hosts_with_no_power_of_two_rule(count, topology):
    s = solve_slice(H100, count)
    assert s.topology == topology
    assert s.num_hosts == count // 8 and s.chips_per_host == 8
    assert s.worker_chip_indices(1) == list(range(8, 16))
    assert solve_slice(H100, count, topology=topology) == s


def test_h100_refuses_a_part_host_beyond_one_host():
    with pytest.raises(TopologyError) as ei:
        solve_slice(H100, 12)
    assert str(ei.value) == (
        "12 chips of nvidia-h100-sxm cannot form a slice; nearby valid"
        " counts: [1, 2, 3, 4, 5, 6, 7, 8, 16, 24]")


@pytest.mark.parametrize("count,topology,message", [
    (16, "2x8", "is not a valid nvidia-h100-sxm slice shape; valid: ['8x2']"),
    (16, "4x4", "is not a valid"),
    (16, "8x3", "has 24 chips but size is 16"),
    (4, "4", "is not a valid"),
    (1024, "", "supports at most 1016 chips"),
    (0, "", "chip count must be >= 1"),
])
def test_h100_refusals(count, topology, message):
    with pytest.raises(TopologyError, match=message.replace("[", r"\[")
                       .replace("]", r"\]")):
        solve_slice(H100, count, topology=topology)


def test_model_predicates_and_unknown_model():
    assert is_gpu_model(H100) and not is_tpu_model(H100)
    assert all(is_tpu_model(m) and not is_gpu_model(m) for m in TPU_MODELS)
    assert GPU_MODELS[H100].chips_per_host == 8
    with pytest.raises(TopologyError, match="unknown accelerator model"):
        solve_slice("nvidia-a100", 8)
