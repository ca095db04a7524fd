"""The serving engine's bucketed admission without host reads, and its
CUDA graphs (``models/paged.py``'s ``paged_prefill_rows``,
``models/serving.py``'s ``_admit_body`` and ``_PrefillGraph``).

On the CPU: the engine's admission, which takes its slot and length from
the device and leaves ``ok`` there, leaves the same bookkeeping as the
JAX package's ``paged_prefill_rows`` on the same live cache at every
bucket, and the same logits and blocks to fp32 tolerance; so does
``paged_prefill_rows`` at one to three rows; a refused admission changes
nothing but the sink, and the engine reads that refusal with the first
token and puts the request back; and the benchmark's
``admit_graph_pct.batch`` reads what the spans say. The tests marked
``cuda`` hold the replayed admission to the eager one on the card, bit
for bit, at the buckets a serving mix pads to, and count its syncs and
its kernel launches. Only the CPU tests import JAX (inside them); on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_prefill_graph.py -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_composer_torch.models import paged, serving
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.models.transformer import ModelConfig, init_params
from tpu_composer_torch.ops.attention import flash_fwd_cuda
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

STATE = ("block_tables", "length", "n_blocks", "free", "free_top",
         "refcount")
POOLS = ("k_pool", "v_pool", "k_scale", "v_scale")
#: The buckets the serving mix's prompts pad to.
CARD_BUCKETS = (256, 512, 1024, 2048)


def _config(device="cpu", dtype=torch.float32, d_model=64, max_seq=256):
    c = ModelConfig(vocab_size=256, d_model=d_model, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=2 * d_model, max_seq=max_seq,
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


def _jax_world():
    """(jax config, jax params, port config, port params): the same
    weights at :func:`_config`'s shape."""
    from tests.torch_parity import world

    return world(0, vocab_size=256, d_model=64, d_ff=128, max_seq=256)


def _admit(params, c, cache, inputs):
    """The engine's bucketed admission (``_admit_body``) of ``inputs`` on
    ``cache``."""
    eng = SimpleNamespace(params=params, config=c, _route_kw=dict)
    return ContinuousBatchingEngine._admit_body(eng, cache, inputs)


def _inputs(prompt, pad, slot, device="cpu"):
    """The admission's one upload: the padded prompt, its slot, its
    length."""
    buf = np.zeros(pad + 2, np.int64)
    buf[:len(prompt)] = prompt
    buf[pad:] = slot, len(prompt)
    return torch.as_tensor(buf, device=device)


def _live(c, params, quant, device="cpu", num_blocks=64, block_size=4,
          lengths=(5, 11)):
    """A cache with two live rows of three slots (slot 2 free), freed
    blocks mixed back into the stack."""
    cache = paged.init_paged_cache(c, 3, num_blocks, block_size, quant=quant,
                                   device=device)
    pad = max(lengths)
    toks = torch.tensor([_prompt(pad, 7), _prompt(pad, 8)], device=device)
    _, cache, ok = paged.paged_prefill_rows(params, toks, c, cache, [0, 1],
                                            prompt_lens=list(lengths))
    assert ok
    cache = paged.release(cache, np.array([1, 0, 0], np.int32))
    toks = torch.tensor([_prompt(pad, 9)], device=device)
    _, cache, ok = paged.paged_prefill_rows(params, toks, c, cache, [1],
                                            prompt_lens=[lengths[1]])
    assert ok
    return cache


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("pad", [8, 16, 32, 64])
def test_the_slot_prefill_equals_the_host_checked_prefill(pad, quant):
    """At each bucket, the engine's admission (one row of
    ``paged_prefill_rows``) and the JAX package's ``paged_prefill_rows``
    on the same live cache: the same bookkeeping and ``ok``, a 0-dim
    tensor; the logits and the pool's blocks to fp32 tolerance."""
    import jax.numpy as jnp

    from tests.torch_parity import assert_paged_matches, jax_paged
    from tpu_composer.models import paged as jpg

    jc, jp, c, params = _jax_world()
    cache = _live(c, params, quant)
    prompt = _prompt(pad - 3, pad)
    j_logits, j_out, j_ok = jpg.paged_prefill_rows(
        jp, jnp.asarray([prompt + [0] * 3]), jc, jax_paged(cache),
        jnp.asarray([2]), prompt_lens=jnp.asarray([len(prompt)]))
    logits, out, ok = _admit(params, c, cache, _inputs(prompt, pad, 2))
    assert torch.is_tensor(ok) and ok.dim() == 0
    assert bool(ok) and bool(j_ok)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    assert_paged_matches(out, j_out, f"pad {pad}")
    assert int(out.length[2]) == len(prompt)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_a_refused_admission_changes_nothing_but_the_sink(quant):
    """A pool too short for the prompt: ``ok`` False on the device, every
    bookkeeping value as it was, and the K/V written into the sink only;
    given the slot and length as host sequences, ``paged_prefill_rows``
    refuses the same admission."""
    c, params = _config()
    cache = _live(c, params, quant, num_blocks=12)
    assert 0 < int(cache.free_top) < 8 and cache.sink == 12
    before = _copy(cache)
    _, out, ok = _admit(params, c, cache, _inputs(_prompt(30, 1), 32, 2))
    assert torch.is_tensor(ok) and not bool(ok)
    for f in STATE:
        assert torch.equal(getattr(out, f), getattr(before, f)), f
    for new, old in zip(_pools(out), _pools(before)):
        assert torch.equal(new[:, :12], old[:, :12])
        assert not torch.equal(new[:, 12], old[:, 12])
    _, same, ok = paged.paged_prefill_rows(
        params, torch.tensor([_prompt(32, 1)]), c, _copy(before), [2],
        prompt_lens=[30])
    assert not bool(ok)
    for f in STATE:
        assert torch.equal(getattr(same, f), getattr(before, f)), f


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_paged_prefill_rows_keeps_its_host_contract(rows):
    """``paged_prefill_rows`` admits any number of rows as the JAX
    package's does: the same bookkeeping, logits and blocks, and ``ok`` a
    0-dim bool tensor; a refusal, which JAX's makes too, returns the
    cache's own bookkeeping."""
    import jax.numpy as jnp

    from tests.torch_parity import assert_paged_matches, jax_paged
    from tpu_composer.models import paged as jpg

    jc, jp, c, params = _jax_world()
    cache = paged.init_paged_cache(c, 3, 3 * rows, 4, device="cpu")
    toks = [_prompt(8, r) for r in range(rows)]
    lens = [8 - r for r in range(rows)]
    j_logits, j_out, j_ok = jpg.paged_prefill_rows(
        jp, jnp.asarray(toks), jc, jax_paged(cache),
        jnp.arange(rows, dtype=jnp.int32), prompt_lens=jnp.asarray(lens))
    logits, cache, ok = paged.paged_prefill_rows(
        params, torch.tensor(toks), c, cache, list(range(rows)),
        prompt_lens=lens)
    assert torch.is_tensor(ok) and ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) and bool(j_ok) and tuple(logits.shape) == (rows, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)
    assert_paged_matches(cache, j_out, f"{rows} rows")
    assert cache.length.tolist()[:rows] == lens
    assert int(cache.free_top) == rows
    full = paged.init_paged_cache(c, 3, 2 * rows - 1, 4, blocks_per_row=2,
                                  device="cpu")
    before = _copy(full)
    _, same, ok = paged.paged_prefill_rows(params, torch.tensor(toks), c,
                                           full, list(range(rows)))
    _, _, j_ok = jpg.paged_prefill_rows(
        jp, jnp.asarray(toks), jc, jax_paged(before),
        jnp.arange(rows, dtype=jnp.int32))
    assert not bool(ok) and not bool(j_ok)
    for f in STATE:
        assert torch.equal(getattr(same, f), getattr(before, f)), f


def test_the_engine_reads_ok_with_the_first_token(monkeypatch):
    """With the pool taken away on the device behind the host's
    reservation, the admission is refused when its first token is read:
    one upload and one read, no event, the request back at the head of
    the queue with its slot free and the cache's bookkeeping unchanged;
    given the pool back, it is served as a fresh engine serves it."""
    c, params = _config()
    prompt = _prompt(13, 5)
    fresh = ContinuousBatchingEngine(params, c, slots=2, num_blocks=16,
                                     block_size=4)
    want = fresh.submit(prompt, 5, temperature=0.9, top_k=20, seed=4)
    fresh.run()
    eng = ContinuousBatchingEngine(params, c, slots=2, num_blocks=16,
                                   block_size=4)
    req = eng.submit(prompt, 5, temperature=0.9, top_k=20, seed=4)
    eng.cache = eng.cache._replace(free_top=torch.tensor(0, dtype=torch.int32))
    before = _copy(eng.cache)
    seen = []
    real = serving.host_sync

    def counted(what, fn, *args, count=1):
        seen.append(what)
        return real(what, fn, *args, count=count)

    monkeypatch.setattr(serving, "host_sync", counted)
    monkeypatch.setattr(paged, "host_sync", counted)
    assert eng.step() == []
    monkeypatch.undo()
    assert seen == ["upload", "upload", "first_token"]  # + sampling controls
    assert list(eng._waiting) == [req] and eng._slot_req == [None, None]
    assert not req.tokens and eng._slot_gen == [None, None]
    assert eng._reserved.tolist() == [0, 0]
    for f in STATE:
        assert torch.equal(getattr(eng.cache, f), getattr(before, f)), f
    eng.cache = eng.cache._replace(
        free_top=torch.tensor(16, dtype=torch.int32))
    eng.run()
    assert req.tokens == want.tokens


def _read_admit_pct(steps):
    from h100bench import run as R

    return R.metric_reader("admit_graph_pct.batch").read(
        SimpleNamespace(steps=steps))


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_the_admit_graph_share_reads_the_spans(ring):
    """``admit_graph_pct.batch``: 0 over a CPU engine's admissions, 100
    over admissions whose span says ``graph=1``, nothing where the spans
    have no such arg."""
    c, params = _config()
    eng = ContinuousBatchingEngine(params, c, slots=2, num_blocks=32,
                                   block_size=4)
    for i in range(3):
        eng.submit(_prompt(6 + i, i), 4)
    steps = []
    while eng._waiting or any(r is not None for r in eng._slot_req):
        admit = bool(eng._waiting)
        t0 = time.perf_counter()
        rows = len(eng.step())
        steps.append({"t0": t0, "t1": time.perf_counter(), "rows": rows,
                      "admit": admit})
    assert _read_admit_pct(steps) == 0.0

    ring.reset()
    ms = 1_000_000
    base = time.perf_counter_ns()
    booked = []
    for i, args in enumerate([{"graph": 1}, {"graph": 1}, {}]):
        t0 = base + 20 * i * ms
        ring.record([("serving.step", "serving", t0, t0 + 10 * ms, None,
                      {"rows": 2, "tokens": 3, "syncs": 5}),
                     ("serving.admit", "serving", t0 + ms, t0 + 6 * ms, 0,
                      dict(args, prompt=5, padded=8))])
        booked.append({"t0": (t0 - 10_000) / 1e9,
                       "t1": (t0 + 10 * ms + 10_000) / 1e9, "rows": 2,
                       "admit": True})
    assert _read_admit_pct(booked[:2]) == 100.0
    assert _read_admit_pct(booked) is None


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return _config("cuda", torch.bfloat16, d_model=256, max_seq=4096)


def _card_engine(c, params, kv_quant=False):
    return ContinuousBatchingEngine(params, c, slots=3, num_blocks=420,
                                    block_size=16, attn_impl="kernel",
                                    kv_quant=kv_quant)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pad", CARD_BUCKETS)
def test_replay_equals_the_eager_admission_on_the_card(pad, kv_quant):
    """At each bucket, beside two live rows: the admission replayed from
    its graph and the same admission run eagerly give bit for bit the
    same logits, bookkeeping and pools, and the replay raises K1's launch
    count as the eager run does."""
    c, params = _card()
    eng = _card_engine(c, params, kv_quant)
    eng._graphed = False
    for i, n in enumerate((300, 40)):
        eng.submit(_prompt(n, i), 64)
    for _ in range(3):
        eng.step()
    slot = eng._free_slot()
    inputs = _inputs(_prompt(pad - 37, pad), pad, slot, "cuda")
    snap = [p.clone() for p in _pools(eng.cache)]

    def restore():
        for p, s in zip(_pools(eng.cache), snap):
            p.copy_(s)

    k1 = flash_fwd_cuda.launches
    e_logits, e_cache, e_ok = eng._admit_body(eng.cache, inputs)
    eager_k1 = flash_fwd_cuda.launches - k1
    e_pools = [p.clone() for p in _pools(eng.cache)]
    restore()
    graph = serving._PrefillGraph(eng, eng._admit_body, (inputs,),
                                  torch.cuda.graph_pool_handle())
    restore()
    k1 = flash_fwd_cuda.launches
    g_logits, g_cache, g_ok = graph.replay(eng.cache, inputs)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches - k1 == eager_k1 == c.n_layers
    assert bool(g_ok) and bool(e_ok)
    assert torch.equal(g_logits, e_logits)
    for f in STATE:
        assert torch.equal(getattr(g_cache, f), getattr(e_cache, f)), f
    for g, e in zip(_pools(eng.cache), e_pools):
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_a_refused_replay_changes_nothing_but_the_sink_on_the_card():
    c, params = _card()
    eng = _card_engine(c, params)
    eng._graphed = False
    eng.submit(_prompt(300, 1), 64)
    eng.step()
    inputs = _inputs(_prompt(500, 2), 512, eng._free_slot(), "cuda")
    graph = serving._PrefillGraph(eng, eng._admit_body, (inputs,),
                                  torch.cuda.graph_pool_handle())
    cache = eng.cache._replace(free_top=torch.tensor(3, dtype=torch.int32,
                                                     device="cuda"))
    before = _copy(cache)
    _, out, ok = graph.replay(cache, inputs)
    assert not bool(ok)
    sink = eng.num_blocks
    for f in STATE:
        assert torch.equal(getattr(out, f), getattr(before, f)), f
    for new, old in zip(_pools(cache), _pools(before)):
        assert torch.equal(new[:, :sink], old[:, :sink])
        assert not torch.equal(new[:, sink], old[:, sink])


def _served(eng, sampled=False):
    """Requests at every bucket (half of them sampled if asked) through
    ``eng``: their tokens, each first token's logits, and K1's launches."""
    first = []
    pick = eng._pick_first

    def kept(slot, logits, ok=None):
        first.append(logits.clone())
        return pick(slot, logits, ok)

    eng._pick_first = kept
    k1 = flash_fwd_cuda.launches
    reqs = []
    for i, n in enumerate((200, 1500, 700, 300, 1100, 2000)):
        kw = (dict(temperature=0.8, top_k=40, top_p=0.9, seed=i)
              if sampled and i % 2 else {})
        reqs.append(eng.submit(_prompt(n, i), 12 + 5 * i, **kw))
        eng.step()
    eng.run()
    return [r.tokens for r in reqs], first, flash_fwd_cuda.launches - k1


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_the_engine_serves_the_same_graphed_and_eager_on_the_card(kv_quant):
    """A dense engine on the card replays every bucketed admission, one
    graph per padded length; the same traffic with both graphs off gives
    the same tokens and bit for bit the same first-token logits. The
    replays launch K1 as often as the eager admissions do, besides the
    one eager warm-up before each capture."""
    c, params = _card()
    out = {}
    for graphed in (True, False):
        eng = _card_engine(c, params, kv_quant)
        eng._graphed = graphed
        out[graphed] = _served(eng, sampled=True)
        if graphed:
            assert sorted(eng._admit_graphs) == [258, 514, 1026, 2050]
            assert sum(g.replays for g in eng._admit_graphs.values()) == 6
        else:
            assert not eng._admit_graphs
    (g_tok, g_first, g_k1), (e_tok, e_first, e_k1) = out[True], out[False]
    assert g_tok == e_tok
    assert e_k1 == 6 * c.n_layers
    assert g_k1 - e_k1 == 4 * c.n_layers  # the four warm-ups
    for a, b in zip(g_first, e_first, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_an_admitting_step_syncs_as_the_engine_counts_on_the_card():
    """CUDA's own count of synchronizing operations in a step that admits
    by replay equals the engine's: a greedy admission's one upload and
    one read, and a sampled one's sampling controls besides."""
    from test_torch_serving_trace import _counted

    c, params = _card()
    tracing.set_enabled(True)
    eng = ContinuousBatchingEngine(params, c, slots=4, num_blocks=420,
                                   block_size=16, attn_impl="kernel")
    for i, n in enumerate((300, 700)):
        eng.submit(_prompt(n, i), 40)
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    for n, kw, what in ((400, {}, 2 + 3),
                        (600, dict(temperature=0.7, top_k=10, seed=1),
                         6 + 7)):
        replays = sum(g.replays for g in eng._admit_graphs.values())
        eng.submit(_prompt(n, n), 40, **kw)
        _counted(eng, what)
        assert sum(g.replays for g in eng._admit_graphs.values()) == (
            replays + 1)
