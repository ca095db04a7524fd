"""Port parity for the multi-device layer: ``parallel/mesh.py``,
``parallel/collectives.py``, ``parallel/ring_attention.py`` and
``parallel/ulysses.py``.

The port side runs on one gloo world of 4 CPU ranks
(``tests/torch_dist.py``), started once for this file; a mesh of fewer
ranks is laid over it with a 'dp' dim on top, each dp row computing the
same case. The JAX side is the JAX function under ``shard_map`` on the
host devices (``tests/conftest.py`` forces 8), on the same numpy inputs;
the flash inner goes through the Pallas path as ``tests/test_parallel.py``
runs it on the CPU.

Tolerances: fp32 forward 2e-5 absolute (other summation order);
attention gradients 1e-4 × max(1, max|ref|), held against JAX's
gradient of the same global function (``mha_reference``); collectives
exactly against JAX's, their gradients to 1e-6 against the gradient of
each op's global function (sums of two terms).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tests.torch_dist import World
from tpu_composer.ops.attention import flash_attention, mha_reference
from tpu_composer.parallel.mesh import solve_mesh_axes as jax_solve
from tpu_composer.parallel.ring_attention import (
    ring_attention as jax_ring,
    ring_attention_zigzag as jax_zigzag,
)
from tpu_composer.parallel.ulysses import ulysses_attention as jax_ulysses
from tpu_composer_torch.parallel.collectives import allreduce_bandwidth_gbps
from tpu_composer_torch.parallel.mesh import solve_mesh_axes
from tpu_composer_torch.parallel.ring_attention import ring_attention

torch.set_num_threads(1)

N = 4  # ranks in this file's world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N, str(tmp_path_factory.mktemp("world")))
    yield w
    w.close()


def _axes(**dims):
    """A mesh of the world's 4 ranks: ``dims``, with dp taking the rest."""
    n = int(np.prod(list(dims.values())))
    return {"dp": N // n, **dims}


def _jax_mesh(n: int, name: str = "sp") -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _grad_close(got, want) -> None:
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(dp=2, sp=2, tp=2)), (4, {}), (4, dict(ep=2, sp=2)),
    (16, dict(tp=4, pp=2)), (6, {}), (1, {}),
])
def test_solve_mesh_axes_matches_jax(n, kw):
    assert solve_mesh_axes(n, **kw) == jax_solve(n, **kw)
    assert list(solve_mesh_axes(n, **kw)) == list(jax_solve(n, **kw))


def test_solve_8():
    assert solve_mesh_axes(8) == {"dp": 1, "sp": 1, "tp": 8}


def test_indivisible_rejected():
    with pytest.raises(ValueError, match="does not divide"):
        solve_mesh_axes(8, tp=3)


def test_make_mesh_axes(world):
    for got in world.run("solve_and_make", {"dp": 2, "sp": 2}):
        assert got == (["dp", "sp"], [2, 2])
    for got in world.run("solve_and_make", {"dp": 1, "ep": 2, "sp": 1,
                                            "tp": 2}):
        assert got == (["dp", "ep", "sp", "tp"], [1, 2, 1, 2])


def test_make_mesh_wrong_count(world):
    for got in world.run("solve_and_make", {"dp": 16}):
        assert got.startswith("ValueError") and "needs 16" in got


# -- collectives ---------------------------------------------------------------

def _jax_collective(op, x_stack, n, kw):
    """The JAX collective on the per-rank inputs ``x_stack`` (n, ...):
    each rank's output, stacked."""
    spec = P("sp")
    if op == "all_reduce":
        def body(x):
            return jax.lax.psum(x, "sp")
    elif op == "all_gather":
        def body(x):
            return jax.lax.all_gather(x[0], "sp", axis=kw["axis"],
                                      tiled=True)[None]
    elif op == "reduce_scatter":
        def body(x):
            return jax.lax.psum_scatter(
                x[0], "sp", scatter_dimension=kw["scatter_dimension"],
                tiled=True)[None]
    elif op == "ring_shift":
        perm = [(i, (i + kw["shift"]) % n) for i in range(n)]

        def body(x):
            return jax.lax.ppermute(x, "sp", perm)
    elif op == "ppermute":
        def body(x):
            return jax.lax.ppermute(x, "sp", kw["perm"])
    elif op == "all_to_all":
        def body(x):
            return jax.lax.all_to_all(
                x[0], "sp", kw["split_axis"], kw["concat_axis"],
                tiled=True)[None]
    elif op in ("shard", "enter_parallel"):
        return None
    fn = shard_map(body, mesh=_jax_mesh(n), in_specs=spec, out_specs=spec,
                   check_vma=False)
    return np.asarray(fn(jnp.asarray(x_stack)))


def _global_grad(op, w, n, kw):
    """The gradient of the global Σ out ⊙ w with respect to each rank's
    input (stacked), where each op's global function is: all_reduce,
    partials -> their sum, replicated; enter_parallel, a replicated
    tensor -> a copy used on every rank; all_gather, shards -> the whole,
    replicated; shard, replicated -> each rank's slice; reduce_scatter,
    partials -> slices of their sum; ring_shift/ppermute and all_to_all,
    shards -> shards moved."""
    if op == "all_reduce":
        return w
    if op == "enter_parallel":
        return np.broadcast_to(w.sum(0), w.shape)
    if op == "all_gather":
        return np.stack(np.split(w[0], n, axis=kw["axis"]))
    if op in ("shard", "reduce_scatter"):
        ax = kw.get("axis", kw.get("scatter_dimension"))
        whole = np.concatenate(list(w), axis=ax)
        return np.stack([whole] * n)
    if op in ("ring_shift", "ppermute"):
        perm = (kw["perm"] if op == "ppermute"
                else [(i, (i + kw["shift"]) % n) for i in range(n)])
        dst = dict(perm)
        return np.stack([w[dst[r]] for r in range(n)])
    if op == "all_to_all":
        sa, ca = kw["split_axis"], kw["concat_axis"]
        return np.stack([np.concatenate(
            [np.split(w[r], n, axis=ca)[s] for r in range(n)], axis=sa)
            for s in range(n)])
    raise AssertionError(op)


COLLECTIVES = [
    ("all_reduce", {}, (3, 4), (3, 4)),
    ("enter_parallel", {}, (3, 4), (3, 4)),
    ("all_gather", {"axis": 1}, (3, 2), (3, 4)),
    ("shard", {"axis": 1}, (3, 4), (3, 2)),
    ("reduce_scatter", {"scatter_dimension": 1}, (3, 4), (3, 2)),
    ("ring_shift", {"shift": 1}, (3, 4), (3, 4)),
    ("ppermute", {"perm": [(0, 0), (1, 1)]}, (3, 4), (3, 4)),  # self-sends
    ("all_to_all", {"split_axis": 0, "concat_axis": 1}, (4, 2), (2, 4)),
]


@pytest.mark.parametrize("op,kw,in_shape,out_shape", COLLECTIVES,
                         ids=[c[0] for c in COLLECTIVES])
def test_collective_and_its_gradient(world, op, kw, in_shape, out_shape):
    n = 2
    rng = np.random.default_rng(0)
    replicated_in = op in ("shard", "enter_parallel")
    x = rng.standard_normal((n,) + in_shape).astype(np.float32)
    if replicated_in:
        x[:] = x[0]
    w = rng.standard_normal((n,) + out_shape).astype(np.float32)
    if op in ("all_reduce", "all_gather"):
        w[:] = w[0]  # the output is replicated: one cotangent
    axes = _axes(sp=n)
    res = world.run("collective", axes, "sp", op, x, w, kw)
    out = np.zeros((n,) + out_shape, np.float32)
    grad = np.zeros((n,) + in_shape, np.float32)
    for o, g, c in res:
        out[c["sp"]], grad[c["sp"]] = o, g
    want = _jax_collective(op, x, n, kw)
    if want is not None:
        np.testing.assert_array_equal(out, want)
    else:  # shard keeps slices, enter passes the input through
        want = (np.stack(np.split(x[0], n, axis=kw["axis"]))
                if op == "shard" else x)
        np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(grad, _global_grad(op, w, n, kw), atol=1e-6)


def test_allreduce_bandwidth(world):
    for gbps, transport in world.run("bandwidth", {"dp": N}):
        assert gbps > 0 and transport == "gloo"
    assert allreduce_bandwidth_gbps(None) == 0.0


# -- ring, zigzag and Ulysses attention ----------------------------------------

def _qkv(b, s, h, hk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, g


def _jax_sp(fn, n, q, k, v, **kw):
    spec = P(None, "sp", None, None)
    sm = shard_map(functools.partial(fn, axis_name="sp", **kw),
                   mesh=_jax_mesh(n), in_specs=(spec,) * 3, out_specs=spec,
                   check_vma=False)
    return np.asarray(jax.jit(sm)(*(jnp.asarray(a) for a in (q, k, v))))


def _run_sp(world, n, impl, inner, causal, q, k, v, g):
    """The port's output (assembled over sp) and gradients on the
    world's sp = n mesh."""
    res = world.run("sp_attention", _axes(sp=n), impl, inner, causal,
                    q, k, v, g)
    chunks = [None] * n
    for out, _, c in res:
        chunks[c["sp"]] = out
    return np.concatenate(chunks, axis=1), res[0][1]


def _reference_grads(q, k, v, g, causal):
    return jax.grad(lambda *a: (mha_reference(*a, causal=causal)
                                * jnp.asarray(g)).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


RING_CASES = [
    # impl, inner, causal, sp, (B, S, H, KV, D)
    ("ring", "einsum", False, 4, (2, 64, 4, 4, 16)),
    ("ring", "einsum", True, 4, (2, 64, 4, 4, 16)),
    ("ring", "flash", False, 4, (1, 128, 4, 4, 32)),
    ("ring", "flash", True, 4, (1, 128, 4, 4, 32)),
    ("ring", "flash", True, 2, (1, 64, 4, 2, 32)),  # GQA: K/V grouped
    ("ring", "einsum", True, 2, (1, 32, 4, 2, 16)),
    ("zigzag", "einsum", True, 2, (2, 32, 2, 2, 32)),
    ("zigzag", "einsum", True, 4, (1, 64, 2, 2, 16)),
    ("zigzag", "flash", True, 4, (1, 64, 4, 2, 16)),
    ("zigzag", "einsum", False, 2, (1, 32, 2, 2, 16)),  # delegates
]


@pytest.mark.parametrize("impl,inner,causal,sp,shape", RING_CASES)
def test_ring_matches_jax_and_reference(world, impl, inner, causal, sp,
                                        shape):
    b, s, h, hk, d = shape
    q, k, v, g = _qkv(b, s, h, hk, d, seed=sp + s)
    out, grads = _run_sp(world, sp, impl, inner, causal, q, k, v, g)
    fn = jax_ring if impl == "ring" else jax_zigzag
    want = _jax_sp(fn, sp, q, k, v, causal=causal, inner=inner)
    np.testing.assert_allclose(out, want, atol=2e-5)
    ref = np.asarray(mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    for got, w in zip(grads, _reference_grads(q, k, v, g, causal)):
        _grad_close(got, w)


def test_unknown_inner_rejected():
    with pytest.raises(ValueError, match="inner"):
        ring_attention(None, None, None, None, inner="bogus")


@pytest.mark.parametrize("inner,causal,sp,shape", [
    ("einsum", False, 4, (2, 32, 8, 8, 16)),
    ("einsum", True, 4, (2, 32, 8, 8, 16)),
    ("flash", True, 2, (2, 64, 8, 8, 16)),
    ("einsum", True, 4, (1, 32, 8, 2, 16)),  # KV 2 not divisible: repeated
    ("flash", True, 2, (1, 32, 8, 2, 16)),   # KV 2 grouped through a2a
])
def test_ulysses_matches_jax_and_reference(world, inner, causal, sp, shape):
    b, s, h, hk, d = shape
    q, k, v, g = _qkv(b, s, h, hk, d, seed=7)
    out, grads = _run_sp(world, sp, "ulysses", inner, causal, q, k, v, g)
    attn = (functools.partial(flash_attention, block_q=16, block_k=16)
            if inner == "flash" else None)
    want = _jax_sp(jax_ulysses, sp, q, k, v, causal=causal, attn_fn=attn)
    np.testing.assert_allclose(out, want, atol=2e-5)
    for got, w in zip(grads, _reference_grads(q, k, v, g, causal)):
        _grad_close(got, w)


def test_ulysses_head_divisibility_error(world):
    q, k, v, _ = _qkv(1, 32, 6, 6, 16)
    for msg in world.run("sp_attention_error", _axes(sp=4), q, k, v):
        assert msg is not None and "not divisible" in msg
