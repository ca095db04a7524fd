"""Mixtral-8x7B's path through the port at a small dropless size: the
serving engine (bucketed admission, the decode step, the routing record)
against the benchmark's plain float32 reference
(``h100bench/references/moe_lm.py``), dropless routing against capacity
routing, each request against its solo ``generate`` run, and the planted
faults the benchmark's comparison must catch.

Tolerances, each with its reason:
- engine logits against the reference's full forward, both float32:
  ``1e-4 × max(1, max|ref|)`` (other summation orders: batched expert
  products, fp32 accumulation of the head);
- dropless against capacity routing where nothing drops: 1e-5, other
  matmul shapes (the capacity sets the expert products' rows);
- tokens, routing records and routing gaps: equal (gaps 0).

The tests marked ``cuda`` hold the decode step's CUDA graph to the eager
step and the engine's host syncs to CUDA's own count, with the routing
record on and off. This file imports no JAX; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_mixtral.py -q
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np
import pytest
import torch

from h100bench import judge as J
from h100bench import run as R
from h100bench.families.moe_lm import program_config
from h100bench.moe_weights import make_weights
from h100bench.references import moe_lm as ref
from h100bench.tests.small import BENCH, config, mix
from tpu_composer_torch.models import decode, moe, paged
from tpu_composer_torch.models.decode import generate, prefill
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

CELL = next(c for c in BENCH["workloads"] if c["name"] == "mixtral-8x7b.decode")
EXACT = {"max_gap": 1e-3, "route_gap_max": 1e-3}


def _cfg(dtype="float32", layers=4):
    """The configuration file at 4 layers, d_model 64, 4 query heads over
    2 KV heads, 8 experts of width 128, top-2, vocab 256."""
    cfg = config("mixtral-8x7b", dtype=dtype)
    cfg["num_hidden_layers"] = layers
    return cfg


def _world(seed=3, device="cpu", dtype="float32"):
    cfg = _cfg(dtype)
    return cfg, program_config(cfg), make_weights(cfg, seed, device)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


SIZES = [(13, 6), (5, 9), (30, 4), (9, 7), (21, 5)]


def _serve(eng, sizes=SIZES):
    reqs = []
    for i, (n, new) in enumerate(sizes):
        reqs.append(eng.submit(_prompt(n, i), new))
        eng.step()
    eng.run()
    return reqs


def _engine(c, params, **kw):
    return ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                    block_size=4, **kw)


def _logged(eng):
    """Each request's logits as the engine picked from them, by req_id:
    its first token's from the bucketed prefill, then one row of each
    decode step."""
    seen = defaultdict(list)
    first, dec = eng._pick_first, eng._decode

    def pick_first(slot, logits, ok=None):
        seen[eng._slot_req[slot].req_id].append(logits[0].clone())
        return first(slot, logits, ok)

    def decode_step(token, active):
        out = dec(token, active)
        for s in np.nonzero(active.numpy())[0]:
            seen[eng._slot_req[s].req_id].append(out[0][s].clone())
        return out

    eng._pick_first, eng._decode = pick_first, decode_step
    return seen


def _teacher_forced(req):
    return torch.tensor(req.prompt + req.tokens[:-1])


def test_engine_logits_match_the_reference_forward():
    """Bucketed prefill then decode through the paged cache: every logit
    the engine picked from equals the reference's full forward, whose
    own routing agrees with the program's everywhere (gaps 0), alone
    and under the engine's routing record."""
    cfg, c, params = _world()
    eng = _engine(c, params, record_routes=True)
    seen = _logged(eng)
    reqs = _serve(eng)
    for req in reqs:
        seq = _teacher_forced(req)
        start = len(req.prompt) - 1
        for routes in (None, [req.routes]):
            read = ref.logits(cfg, params, [seq], [start], routes=routes)
            want = read.logits[0]
            got = torch.stack(seen[req.req_id])
            assert got.shape == want.shape
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol
            assert float(read.gaps[0].max()) == 0.0
            assert bool(read.own[0].all())
        assert torch.equal(read.experts[0].to(torch.uint8), req.routes)


def test_the_record_holds_the_ids_dispatch_used(monkeypatch):
    """One slot, two requests in turn: every layer's (1, S, 2) expert ids
    as routing handed them to dispatch, prefill then each decode step,
    are the finished requests' records position by position."""
    cfg, c, params = _world()
    calls = []
    route = moe._route

    def kept(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        calls.append(out[0][0].to(torch.uint8))
        return out

    monkeypatch.setattr(moe, "_route", kept)
    eng = ContinuousBatchingEngine(params, c, slots=1, num_blocks=32,
                                   block_size=4, record_routes=True)
    layers = c.n_layers
    for n, new in [(11, 5), (6, 4)]:
        calls.clear()
        req = eng.submit(_prompt(n, n), new)
        eng.run()
        # The prefill's layers cover the padded prompt; each decode step
        # then adds one position (the last token is never fed back).
        want = [torch.stack(calls[:layers])[:, :n]]
        for t in range(new - 1):
            step = calls[layers * (t + 1):layers * (t + 2)]
            want.append(torch.stack(step))
        want = torch.cat(want, dim=1)
        assert len(calls) == layers * new
        assert req.routes.shape == (layers, n + new - 1, 2)
        assert torch.equal(req.routes, want)


def test_a_dense_engine_keeps_no_record_and_no_moe_span(ring):
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    c = ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=256,
                    dtype=torch.float32)
    params = init_params(c, seed=0, device="cpu")
    with pytest.raises(ValueError, match="record_routes"):
        _engine(c, params, record_routes=True)
    eng = _engine(c, params)
    req = eng.submit(_prompt(9, 1), 3)
    eng.run()
    assert eng._routes is None and req.routes is None
    names = {e["name"] for e in ring.snapshot(cat="serving")}
    assert "serving.decode" in names
    assert not {n for n in names if n.startswith("moe.")}
    decodes = [e for e in ring.snapshot(cat="serving")
               if e["name"] == "serving.decode"]
    assert all(set(e["args"]) <= {"graph", "parent_span", "swiglu_fused"}
               for e in decodes)


def _dropped(c, params, tokens):
    """Whether capacity routing drops a choice anywhere in the forward."""
    drops = []
    route = moe._route

    def seen(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        drops.append(bool((out[1] < 0).any()))
        return out

    moe._route = seen
    try:
        moe.forward(params, tokens, c)
    finally:
        moe._route = route
    return any(drops)


@pytest.mark.parametrize("factor", [3.0, 0.5])
def test_dropless_equals_capacity_routing_where_nothing_drops(factor):
    """The training forward and ``decode.prefill`` with a dropless config
    against a capacity config on the same weights: equal wherever the
    capacity drops nothing (factor 3.0), apart where it does (0.5)."""
    cfg, c, params = _world()
    assert c.dropless and c.capacity(37) == 37
    capped = type(c)(**{**c.__dict__, "capacity_factor": factor})
    tokens = torch.tensor([_prompt(24, 7), _prompt(24, 8)])
    drops = _dropped(capped, params, tokens)
    assert drops == (factor < 1)
    free, _ = moe.forward(params, tokens, c)
    cap, _ = moe.forward(params, tokens, capped)
    last, _ = prefill(params, tokens, c, max_seq=64)
    assert torch.allclose(last, free[:, -1], atol=1e-5, rtol=0)
    if drops:
        assert not torch.allclose(free, cap, atol=1e-3, rtol=0)
    else:
        assert torch.allclose(free, cap, atol=1e-5, rtol=0)


def test_dropless_prefill_takes_ragged_rows_and_capacity_refuses_them():
    cfg, c, params = _world()
    tokens = torch.tensor([_prompt(16, 1), _prompt(9, 2) + [0] * 7])
    logits, cache = prefill(params, tokens, c, max_seq=64,
                            prompt_lens=[16, 9])
    alone, _ = prefill(params, tokens[1:, :9], c, max_seq=64)
    assert torch.allclose(logits[1], alone[0], atol=1e-5, rtol=0)
    capped = type(c)(**{**c.__dict__, "capacity_factor": 2.0})
    with pytest.raises(ValueError, match="dense-only"):
        prefill(params, tokens, capped, max_seq=64, prompt_lens=[16, 9])
    with pytest.raises(ValueError, match="chunked admission"):
        _engine(capped, params)


@pytest.mark.parametrize("record", [False, True], ids=["plain", "recorded"])
def test_each_request_equals_its_solo_generate(record):
    """A dropless MoE engine admits by bucketed prefill without
    ``prefill_chunk``; every request equals its solo run, and the pool
    drains."""
    cfg, c, params = _world()
    eng = _engine(c, params, record_routes=record)
    assert eng.prefill_chunk is None
    reqs = _serve(eng)
    for req in reqs:
        solo = generate(params, torch.tensor([req.prompt]), c,
                        max_new_tokens=req.max_new_tokens, max_seq=64)
        assert req.tokens == solo[0].tolist()
        assert (req.routes is not None) == record
    assert int(eng.cache.free_top) == eng.num_blocks


def test_prefixes_refused_while_recording():
    cfg, c, params = _world()
    eng = ContinuousBatchingEngine(params, c, slots=2, num_blocks=32,
                                   block_size=4, prefill_chunk=8,
                                   record_routes=True)
    with pytest.raises(ValueError, match="routing"):
        eng.register_prefix(_prompt(8, 1))


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_moe_spans_nest_under_admit_and_the_eager_decode(ring):
    """Each MoE layer of an admission and of an eager decode step records
    route, dispatch, experts (rows E × B × C, real B × S × k) and
    combine, in order, under ``serving.admit`` and ``serving.decode``."""
    cfg, c, params = _world()
    eng = _engine(c, params)
    eng.submit(_prompt(11, 1), 3)
    eng.step()
    events = ring.snapshot(cat="serving")
    by_id = {e["id"]: e for e in events}
    for parent, rows, real in (("serving.admit", 8 * 1 * 16, 16 * 2),
                               ("serving.decode", 8 * 3 * 1, 3 * 2)):
        kids = [e for e in events if e["name"].startswith("moe.")
                and by_id[e["args"]["parent_span"]]["name"] == parent]
        assert [e["name"] for e in kids] == c.n_layers * [
            "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
        for e in kids:
            if e["name"] == "moe.experts":
                assert (e["args"]["rows"], e["args"]["real"]) == (rows, real)


# -- planted faults: each one fails the benchmark's comparison ---------------

def _second_choice_is_third(monkeypatch):
    """Layer 1 takes each token's third-best expert for its second."""
    ffn, route = decode.ffn_delta, moe._route

    def demoted(logits, top_k, capacity):
        top = logits.topk(3, dim=-1)
        logits = logits.scatter(-1, top.indices[..., 1:2],
                                top.values[..., 2:3] - 1.0)
        return route(logits, top_k, capacity)

    def layer(h, lw, li, c, **kw):
        if li != 1:
            return ffn(h, lw, li, c, **kw)
        moe._route = demoted
        try:
            return ffn(h, lw, li, c, **kw)
        finally:
            moe._route = route

    monkeypatch.setattr(decode, "ffn_delta", layer)


def _expert_zeroed(monkeypatch):
    """Expert 3's output is zero in every layer."""
    resolve = moe.resolve

    def zeroed(w, dtype):
        w = resolve(w, dtype)
        if w.dim() == 3 and w.shape[1] > w.shape[2]:  # w_down (E, F, D)
            w = w.clone()
            w[3] = 0
        return w

    monkeypatch.setattr(moe, "resolve", zeroed)


def _gates_not_renormalised(monkeypatch):
    """The chosen experts' softmax probabilities as the gates."""
    route = moe._route

    def raw(logits, top_k, capacity):
        experts, slots, _, aux = route(logits, top_k, capacity)
        return experts, slots, torch.softmax(logits, -1).gather(-1, experts), aux

    monkeypatch.setattr(moe, "_route", raw)


def _kv_position_dropped(monkeypatch):
    """A prefill writes no K/V at position 2."""
    write = paged._write_kv_layer

    def dropped(cache, li, index, k, v):
        if index is None or k.shape[1] < 3:
            return write(cache, li, index, k, v)
        keep = torch.ones(k.shape[:2], dtype=torch.bool)
        keep[:, 2] = False
        keep = keep.reshape(-1)
        blk, off = index

        def flat(x):
            return x.reshape((1, -1) + x.shape[2:])[:, keep]

        return write(cache, li, (blk[keep], off[keep]), flat(k), flat(v))

    monkeypatch.setattr(paged, "_write_kv_layer", dropped)


def _small_mix():
    m = mix("decode")
    m["output"] = {"dist": "uniform", "min": 4, "max": 16}
    return m


def _run(seed=2**31 + 21):
    return R.execute(BENCH, CELL, seed, 0.6, False, "cpu",
                     cfg=_cfg(layers=2), mix=_small_mix())


@pytest.mark.parametrize("fault", [_second_choice_is_third, _expert_zeroed,
                                   _gates_not_renormalised,
                                   _kv_position_dropped])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(J, "limits", lambda name: EXACT)
    sound = _run()
    assert sound["correct"], sound["checks"]
    fault(monkeypatch)
    out = _run()
    assert not out["correct"]
    assert any(out["checks"][k]["value"] > EXACT[k] for k in EXACT)


def test_the_second_choice_fault_shows_in_the_routing_gap(monkeypatch):
    """The planted route is also what the record says, so the reference
    computes the same experts: the routing gap, not the token gap, is
    what catches it."""
    monkeypatch.setattr(J, "limits", lambda name: EXACT)
    _second_choice_is_third(monkeypatch)
    checks = _run()["checks"]
    assert checks["route_gap_max"]["value"] > 0.1
    assert checks["route_mismatch_pct"]["value"] > 0


# -- on the card --------------------------------------------------------------

SYNC_WARNING = "called a synchronizing CUDA operation"


def _card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cfg = _cfg("bfloat16")
    cfg.update(hidden_size=256, intermediate_size=512)
    return cfg, program_config(cfg), make_weights(cfg, 3, "cuda")


def _card_engine(c, params, **kw):
    return ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                    block_size=8, attn_impl="kernel", **kw)


@pytest.mark.cuda
def test_replays_equal_the_eager_moe_step_on_the_card():
    """A dropless MoE engine on the card replays its decode step; the same
    traffic through the eager step gives the same tokens, bit for bit the
    same logits and the same routing records."""
    cfg, c, params = _card_world()
    out = {}
    for graphed in (True, False):
        eng = _card_engine(c, params, record_routes=True)
        assert eng._graphed
        eng._graphed = graphed
        logits = []
        dec = eng._decode

        def kept(token, active, dec=dec):
            res = dec(token, active)
            logits.append(res[0].clone())
            return res

        eng._decode = kept
        reqs = _serve(eng, SIZES * 3)
        if graphed:
            assert eng._graph.replays == len(logits) >= 20
        out[graphed] = (logits, [r.tokens for r in reqs],
                        [r.routes for r in reqs])
    (gl, gt, gr), (el, et, er) = out[True], out[False]
    assert gt == et and len(gl) == len(el)
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    assert all(torch.equal(a, b) for a, b in zip(gr, er))


def _syncs(eng):
    """Step ``eng`` once under CUDA's sync debug mode: (CUDA's count of
    synchronizing operations, the engine's ``syncs``)."""
    tracing.reset()
    count = [0]

    def show(message, *args, **kw):
        if SYNC_WARNING in str(message):
            count[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    root, = [e for e in tracing.snapshot(cat="serving")
             if e["name"] == "serving.step"]
    return count[0], root["args"]["syncs"]


@pytest.mark.cuda
def test_syncs_per_step_are_counted_with_the_record_on_and_off(ring):
    """CUDA's count of synchronizing operations equals the engine's in a
    step that admits and in a decode-only step (a replay), and the record
    adds none: 3 in a decode-only step either way."""
    cfg, c, params = _card_world()
    counts = {}
    for record in (False, True):
        eng = _card_engine(c, params, record_routes=record)
        for i, n in enumerate((20, 40)):
            r = eng.submit(_prompt(n, i), 30)
            while not r.tokens:
                eng.step()
        eng.step()
        torch.cuda.synchronize()
        eng.submit(_prompt(20, 5), 30)
        admit = _syncs(eng)
        replays = eng._graph.replays
        decode_only = _syncs(eng)
        assert eng._graph.replays == replays + 1
        assert admit[0] == admit[1] and decode_only == (3, 3)
        counts[record] = (admit, decode_only)
    assert counts[False] == counts[True]
