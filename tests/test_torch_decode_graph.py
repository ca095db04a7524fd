"""The serving engine's decode step without host reads, and its CUDA
graph (``models/paged.py``'s pool contract, ``models/serving.py``'s
``_DecodeGraph``).

On the CPU: the engine's step, whose idle rows write into the pool's
sink block and whose pool check stays on the device, leaves the same
bookkeeping as the JAX package's ``paged_decode_step`` on the same cache,
and the same live rows' logits and pool blocks to fp32 tolerance, over
runs where rows join and leave; a refused step changes nothing but the
sink, as JAX's refuses it, and raises at the token read; and the
benchmark's ``decode_graph_pct.batch`` reads what the spans say. The
tests marked ``cuda`` hold the replayed step to the eager one on the
card, bit for bit. Only the CPU tests import JAX (inside them); on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py -q
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from tpu_composer_torch.models import paged, serving
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.models.transformer import ModelConfig, init_params
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

STATE = ("block_tables", "length", "n_blocks", "free", "free_top",
         "refcount")
POOLS = ("k_pool", "v_pool", "k_scale", "v_scale")


def _config(device="cpu", dtype=torch.float32, d_model=64):
    c = ModelConfig(vocab_size=256, d_model=d_model, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=2 * d_model, max_seq=256,
                    dtype=dtype,
                    attn_impl="flash" if device == "cuda" else "reference")
    return c, init_params(c, seed=0, device=device)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _copy(cache):
    return cache._replace(**{f: v.clone() for f, v in cache._asdict().items()
                             if torch.is_tensor(v)})


def _pools(cache):
    return [getattr(cache, f) for f in POOLS if getattr(cache, f) is not None]


def _traffic(eng):
    """Requests that join and leave: twelve of them over three slots,
    one submitted a step, outputs of 2 to 12 tokens; run until done.
    Returns the requests."""
    sizes = [(5, 7), (17, 3), (9, 12), (30, 2), (12, 10), (3, 8), (21, 4),
             (7, 11), (14, 5), (6, 9), (25, 6), (10, 3)]
    reqs = []
    for i, (n, new) in enumerate(sizes):
        reqs.append(eng.submit(_prompt(n, i), new))
        eng.step()
    eng.run()
    return reqs


ENGINES = {
    "bucketed": dict(),
    "bucketed-int8-pool": dict(kv_quant=True),
    "chunked": dict(prefill_chunk=8),
}


def _jax_world():
    """(jax config, jax params, port config, port params): the same
    weights at :func:`_config`'s shape."""
    from tests.torch_parity import world

    return world(0, vocab_size=256, d_model=64, d_ff=128, max_seq=256)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_sink_step_equals_the_host_checked_step(monkeypatch, kind):
    """Each of the engine's decode steps, against the JAX package's
    ``paged_decode_step`` on the same cache: the same bookkeeping and
    ``ok``, and the live rows' logits and the pool's blocks (JAX's pool
    has no sink; idle rows write only into the port's) to fp32
    tolerance."""
    import jax.numpy as jnp

    from tests.torch_parity import assert_paged_matches, jax_paged
    from tpu_composer.models import paged as jpg

    jc, jp, c, params = _jax_world()
    eng = ContinuousBatchingEngine(params, c, slots=3, num_blocks=40,
                                   block_size=4, **ENGINES[kind])
    real = serving.paged_decode_step
    seen = []

    def held(params, cache, token, config, attn_impl, active):
        j_logits, j_out, j_ok = jpg.paged_decode_step(
            jp, jax_paged(cache), jnp.asarray(token.numpy()), jc,
            active=jnp.asarray(active.numpy()))
        logits, out, ok = real(params, cache, token, config,
                               attn_impl=attn_impl, active=active)
        assert torch.is_tensor(ok) and bool(ok) and bool(j_ok)
        assert_paged_matches(out, j_out, "step")
        live = (active & (cache.n_blocks > 0)).numpy()
        np.testing.assert_allclose(logits.numpy()[live],
                                   np.asarray(j_logits)[live], atol=1e-4)
        seen.append(int(live.sum()))
        return logits, out, ok

    monkeypatch.setattr(serving, "paged_decode_step", held)
    reqs = _traffic(eng)
    assert len(seen) >= 20 and min(seen) < 3 <= max(seen)
    assert all(r.done and len(r.tokens) == r.max_new_tokens for r in reqs)
    assert int(eng.cache.free_top) == eng.num_blocks
    assert sorted(eng.cache.free.tolist()) == list(range(eng.num_blocks))


def _full(kind):
    """A cache whose live rows need blocks that they cannot have: two
    rows want a block each and the pool holds one (``pool``), or the one
    row's table is full (``table``). Returns the JAX world too."""
    jc, jp, c, params = _jax_world()
    if kind == "pool":
        cache = paged.init_paged_cache(c, 2, 3, 4, device="cpu")
        toks = torch.tensor([[5, 6, 7, 8], [9, 10, 11, 12]])
        slots = [0, 1]
    else:
        cache = paged.init_paged_cache(c, 2, 8, 4, blocks_per_row=1,
                                       device="cpu")
        toks = torch.tensor([[5, 6, 7, 8]])
        slots = [0]
    _, cache, ok = paged.paged_prefill_rows(params, toks, c, cache, slots)
    assert ok
    return (jc, jp), c, params, cache


@pytest.mark.parametrize("kind", ["pool", "table"])
def test_a_refused_sink_step_changes_nothing_but_the_sink(kind):
    import jax.numpy as jnp

    from tests.torch_parity import jax_paged
    from tpu_composer.models import paged as jpg

    (jc, jp), c, params, cache = _full(kind)
    sink = cache.sink
    before = _copy(cache)
    token = torch.tensor([1, 2], dtype=torch.int32)
    _, out, ok = paged.paged_decode_step(params, cache, token, c,
                                         active=torch.tensor([True, True]))
    assert torch.is_tensor(ok) and not bool(ok)
    for f in STATE:
        assert torch.equal(getattr(out, f), getattr(before, f)), f
    for new, old in zip(_pools(out), _pools(before)):
        assert torch.equal(new[:, :sink], old[:, :sink])
        assert not torch.equal(new[:, sink], old[:, sink])
    # The JAX package refuses the same step.
    _, _, j_ok = jpg.paged_decode_step(jp, jax_paged(before),
                                       jnp.asarray(token.numpy()), jc)
    assert not bool(j_ok)


def test_the_engine_raises_at_the_token_read_and_keeps_its_cache():
    c, params = _config()
    eng = ContinuousBatchingEngine(params, c, slots=2, num_blocks=16,
                                   block_size=4)
    req = eng.submit(_prompt(8, 1), 9)
    eng.step()
    # Step until the row's next token opens a block; then take the pool
    # away from it.
    while int(eng.cache.length[0]) != 4 * int(eng.cache.n_blocks[0]):
        eng.step()
    eng.cache = eng.cache._replace(free_top=torch.tensor(0, dtype=torch.int32))
    before, tokens = _copy(eng.cache), list(req.tokens)
    with pytest.raises(RuntimeError, match="pool exhausted despite"):
        eng.step()
    assert req.tokens == tokens
    for f in STATE:
        assert torch.equal(getattr(eng.cache, f), getattr(before, f)), f
    sink = eng.num_blocks
    for new, old in zip(_pools(eng.cache), _pools(before)):
        assert torch.equal(new[:, :sink], old[:, :sink])


def _read_graph_pct(steps):
    from types import SimpleNamespace

    from h100bench import run as R

    return R.metric_reader("decode_graph_pct.batch").read(
        SimpleNamespace(steps=steps))


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_the_graph_share_reads_the_spans(ring):
    """``decode_graph_pct.batch``: 0 over a CPU engine's steps, 100 over
    steps whose decode span says ``graph=1``, nothing where the spans
    have no such arg."""
    c, params = _config()
    eng = ContinuousBatchingEngine(params, c, slots=2, num_blocks=32,
                                   block_size=4)
    for i in range(3):
        eng.submit(_prompt(6 + i, i), 4)
    steps = []
    while eng._waiting or any(r is not None for r in eng._slot_req):
        t0 = time.perf_counter()
        rows = len(eng.step())
        steps.append({"t0": t0, "t1": time.perf_counter(), "rows": rows})
    assert _read_graph_pct(steps) == 0.0

    ring.reset()
    ms = 1_000_000
    base = time.perf_counter_ns()
    booked = []
    for i, args in enumerate([{"graph": 1}, {"graph": 1}, {}]):
        t0 = base + 20 * i * ms
        ring.record([("serving.step", "serving", t0, t0 + 10 * ms, None,
                      {"rows": 2, "tokens": 2, "syncs": 3}),
                     ("serving.decode", "serving", t0 + ms, t0 + 8 * ms, 0,
                      args)])
        booked.append({"t0": (t0 - 10_000) / 1e9,
                       "t1": (t0 + 10 * ms + 10_000) / 1e9, "rows": 2})
    assert _read_graph_pct(booked[:2]) == 100.0
    assert _read_graph_pct(booked) is None


def _served(eng):
    """The engine's decode logits, step by step, and its requests'
    tokens, over rows that join and leave."""
    logits = []
    decode = eng._decode

    def kept(token, active):
        out = decode(token, active)
        logits.append(out[0].clone())
        return out

    eng._decode = kept
    reqs = _traffic(eng)
    return logits, [r.tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_replays_equal_the_eager_step_on_the_card(kv_quant):
    """A dense engine on the card replays its decode step; the same
    traffic through the eager step gives the same tokens and bit for bit
    the same logits, and the graph replays once per decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    c, params = _config("cuda", torch.bfloat16, d_model=256)
    out = {}
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                       block_size=8, attn_impl="kernel",
                                       kv_quant=kv_quant)
        assert eng._graphed
        eng._graphed = graphed
        out[graphed] = _served(eng)
        if graphed:
            assert eng._graph.replays == len(out[graphed][0]) >= 20
        else:
            assert eng._graph is None
    (g_logits, g_tokens), (e_logits, e_tokens) = out[True], out[False]
    assert g_tokens == e_tokens
    assert len(g_logits) == len(e_logits)
    for a, b in zip(g_logits, e_logits):
        assert torch.equal(a, b)
