"""Moonlight-16B-A3B's path through the port (DeepSeek-V3's block: latent
attention over a latent paged pool, sigmoid routing with a selection
bias, shared experts, a leading dense layer) at a small size: 2 layers
(one dense, one MoE), d_model 64, 4 heads, kv_lora_rank 32, nope / rope /
v 16 / 8 / 16, 8 experts of width 32 top-2 and one shared, vocab 256.
The program is held to the benchmark's plain float32 reference
(``h100bench/references/mla_moe_lm.py``): prefill logits, engine decode
through the latent pool teacher-forced over several block boundaries,
the absorbed form against the expanded one, the latent decode kernel's
plain twin against the reference's attention, the router, the routing
record, and the planted faults the benchmark's comparison must catch.
The Mixtral and Mistral forwards stay bit for bit what they were before
the DeepSeek router was added.

Tolerances, each with its reason:
- float32 program against the float32 reference: ``1e-4 × max(1,
  max|ref|)`` (other summation orders: the absorbed products, batched
  expert products, the pool's gathers);
- the absorbed form against the expanded one and the twin against the
  reference's attention, both float32: ``1e-5 × max(1, max|ref|)`` (one
  product reassociated);
- the bf16 program against the float32 reference: ``0.1 × max(1,
  max|ref|)``, bf16 activations through two layers;
- tokens, routing records and routing gaps: equal (gaps 0).

This file imports no JAX. The card's cases of K3 and of K1 at 192/128
are in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from h100bench import judge as J
from h100bench import run as R
from h100bench.families.mla_moe_lm import program_config
from h100bench import mla_weights
from h100bench.mla_weights import make_weights
from h100bench.references import mla_moe_lm as ref
from h100bench.tests.small import BENCH, config, mix
from tpu_composer_torch.models import decode, mla, moe, paged
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.ops.mla_decode import mla_decode_plain
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

CELL = next(c for c in BENCH["workloads"]
            if c["name"] == "moonlight-16b-a3b.reason")
EXACT = {"max_gap": 1e-3, "route_gap_max": 1e-3}


def _cfg(dtype="float32"):
    cfg = config("moonlight-16b-a3b", dtype=dtype)
    cfg.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=1, moe_intermediate_size=32)
    return cfg


def _world(seed=3, dtype="float32"):
    cfg = _cfg(dtype)
    return cfg, program_config(cfg), make_weights(cfg, seed, "cpu")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


SIZES = [(13, 6), (5, 9), (30, 4), (9, 7), (21, 5)]


def _engine(c, params, **kw):
    return ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                    block_size=4, **kw)


def _logged(eng):
    """Each request's logits as the engine picked from them, by req_id."""
    seen = defaultdict(list)
    first, dec = eng._pick_first, eng._decode

    def pick_first(slot, logits, ok=None):
        seen[eng._slot_req[slot].req_id].append(logits[0].clone())
        return first(slot, logits, ok)

    def decode_step(token, active):
        out = dec(token, active)
        for s in np.nonzero(active.cpu().numpy())[0]:
            seen[eng._slot_req[s].req_id].append(out[0][s].clone())
        return out

    eng._pick_first, eng._decode = pick_first, decode_step
    return seen


def _serve(eng, sizes=SIZES):
    reqs = []
    for i, (n, new) in enumerate(sizes):
        reqs.append(eng.submit(_prompt(n, i), new))
        eng.step()
    eng.run()
    return reqs


def _tol(want, scale):
    return scale * max(1.0, float(want.abs().max()))


# -- the model against the reference -----------------------------------------

@pytest.mark.parametrize("dtype,scale", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_prefill_logits_match_the_reference(dtype, scale):
    cfg, c, params = _world(dtype=dtype)
    tokens = torch.tensor([_prompt(40, 1)])
    got = mla.forward(params, tokens, c)[0]
    want = ref.logits(cfg, params, [tokens[0]], [0]).logits[0]
    assert float((got - want).abs().max()) <= _tol(want, scale)


def test_engine_decode_matches_the_reference_forward():
    """Bucketed prefill into the latent pool (blocks of 4), then decode
    through it across several block boundaries: every logit the engine
    picked from equals the reference's full forward, teacher-forced, on
    its own and under the engine's routing record (gaps 0)."""
    cfg, c, params = _world()
    eng = _engine(c, params, record_routes=True)
    assert eng.cache.v_pool is None
    assert eng.cache.k_pool.shape == (2, 49, 4, 40)
    seen = _logged(eng)
    for req in _serve(eng):
        seq = torch.tensor(req.prompt + req.tokens[:-1])
        for routes in (None, [req.routes]):
            read = ref.logits(cfg, params, [seq], [len(req.prompt) - 1],
                              routes=routes)
            want, got = read.logits[0], torch.stack(seen[req.req_id])
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= _tol(want, 1e-4)
            assert float(read.gaps[0].max()) == 0.0
            assert bool(read.own[0].all())
        # The record: the dense layer's row untouched, the MoE layer's the
        # reference's own experts at every position.
        assert req.routes.shape == (2, len(seq), 2)
        assert torch.equal(read.experts[0].to(torch.uint8), req.routes)
    assert int(eng.cache.free_top) == eng.num_blocks


@pytest.mark.parametrize("impl", [None, "gather", "kernel"])
def test_every_engine_reads_through_the_kernel_dispatchers(monkeypatch, impl):
    """Whatever ``attn_impl`` the engine is given (None: its default), an
    MLA engine admits through ``flash_attention`` and decodes through
    ``mla_decode_attention``, the entry points that launch K1 and K3 on
    the card, and its logits match the reference's forward."""
    from tpu_composer_torch.models import transformer

    calls = defaultdict(int)

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(transformer, "flash_attention", counted(
        "flash", transformer.flash_attention))
    monkeypatch.setattr(paged, "mla_decode_attention", counted(
        "k3", paged.mla_decode_attention))
    cfg, c, params = _world()
    eng = _engine(c, params, **({} if impl is None else {"attn_impl": impl}))
    seen = _logged(eng)
    reqs = _serve(eng, SIZES[:2])
    assert calls["flash"] == 2 * c.n_layers
    assert calls["k3"] % c.n_layers == 0
    assert calls["k3"] >= c.n_layers * (max(new for _, new in SIZES[:2]) - 1)
    for req in reqs:
        seq = torch.tensor(req.prompt + req.tokens[:-1])
        want = ref.logits(cfg, params, [seq], [len(req.prompt) - 1]).logits[0]
        got = torch.stack(seen[req.req_id])
        assert float((got - want).abs().max()) <= _tol(want, 1e-4)


def _layer_inputs(c, params, s=21, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(1, s, c.d_model, generator=gen)
    positions = torch.arange(s, dtype=torch.int32)[None]
    return params["layers"][1], mla.project(params["layers"][1], x,
                                            positions, c)


def test_the_absorbed_form_equals_the_expanded_form():
    """Each position's attention output read from its latent entries in
    the absorbed form (q·W_ukᵀ against the entries, the latent output
    through W_uv) equals the expanded form's causal attention."""
    cfg, c, params = _world()
    layer, (q_nope, q_pe, latent) = _layer_inputs(c, params)
    want = mla.expanded_attention(layer, q_nope, q_pe, latent, c,
                                  lambda q, k, v, causal: ref.attention(
                                      q[0], k[0], v[0])[None])
    s, width = latent.shape[1:]
    # 24 positions in blocks of 4, the row's blocks in another order.
    tables = torch.tensor([[4, 1, 5, 0, 2, 3]], dtype=torch.int32)
    pool = torch.zeros(7, 4, width)
    pool[tables[0].long()] = torch.cat(
        [latent[0], latent.new_zeros(3, width)]).view(6, 4, width)
    q = mla.absorb_query(layer, q_nope, q_pe, c)[0]
    for t in range(s):
        o_lat = mla_decode_plain(q[t:t + 1], pool, tables,
                                 torch.tensor([t + 1], dtype=torch.int32),
                                 c.qk_head_dim ** -0.5, c.kv_lora_rank)
        got = mla.absorbed_output(layer, o_lat, c)
        assert float((got[0] - want[0, t]).abs().max()) <= _tol(want, 1e-5)


def test_the_twin_of_the_latent_kernel_equals_the_reference_attention():
    """The kernel's plain twin over shuffled blocks and ragged rows (a
    0-length row gives zeros) against the reference's attention on the
    same entries lifted to per-head k and v."""
    cfg, c, params = _world()
    layer, (q_nope, q_pe, latent) = _layer_inputs(c, params, s=30)
    r, dn = c.kv_lora_rank, c.qk_nope_head_dim
    wkvb = layer["wkvb"]
    kvb = torch.einsum("sr,rhk->shk", latent[0, :, :r], wkvb)
    k = torch.cat([kvb[..., :dn], latent[0, :, None, r:].expand(
        30, c.n_heads, c.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope[0], q_pe[0]], -1)
    want = ref.attention(q, k, kvb[..., dn:])  # (S, H, v)
    lengths = [30, 1, 0, 17, 4, 5]
    perm = torch.randperm(8 * len(lengths),
                          generator=torch.Generator().manual_seed(1))
    tables = perm.to(torch.int32).view(len(lengths), 8)
    pool = torch.zeros(8 * len(lengths) + 1, 4, latent.shape[2])
    for row, n in enumerate(lengths):
        ent = torch.cat([latent[0, :n], latent.new_zeros(32 - n,
                                                         latent.shape[2])])
        pool[tables[row].long()] = ent.view(8, 4, -1)
    qa = mla.absorb_query(layer, q_nope, q_pe, c)[0]
    q_rows = torch.stack([qa[max(n - 1, 0)] for n in lengths])
    o_lat = mla_decode_plain(q_rows, pool, tables,
                             torch.tensor(lengths, dtype=torch.int32),
                             c.qk_head_dim ** -0.5, r)
    got = mla.absorbed_output(layer, o_lat, c)
    for row, n in enumerate(lengths):
        if n == 0:
            assert bool((o_lat[row] == 0).all())
        else:
            assert float((got[row] - want[n - 1]).abs().max()) <= _tol(
                want, 1e-5)


# -- the router and the block -------------------------------------------------

def test_the_bias_moves_selection_and_not_gates():
    """The top-k of s + bias are chosen, the gates are the chosen s over
    their sum times the scale, and a bias that lifts an expert into the
    top-k changes which are chosen but not how each chosen s weighs."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(1, 16, 8, generator=gen)
    scores = torch.sigmoid(logits)
    flat = torch.zeros(8)
    experts, slots, gates, aux = moe._route_sigmoid(logits, flat, 2, 16,
                                                    2.446)
    assert torch.equal(experts, scores.topk(2, -1).indices)
    chosen = scores.gather(-1, experts)
    assert torch.allclose(gates, chosen / chosen.sum(-1, keepdim=True)
                          * 2.446, atol=0, rtol=0)
    assert torch.allclose(gates.sum(-1), torch.full((1, 16), 2.446),
                          atol=1e-6)
    assert float(aux) == 0.0 and bool((slots >= 0).all())
    lifted = torch.zeros(8)
    lifted[5] = 10.0
    experts, _, gates, _ = moe._route_sigmoid(logits, lifted, 2, 16, 2.446)
    assert bool((experts[..., 0] == 5).all())
    other = scores.masked_fill(F.one_hot(torch.tensor(5), 8).bool(),
                               -1.0).argmax(-1)
    assert torch.equal(experts[..., 1], other)
    chosen = scores.gather(-1, experts)
    assert torch.allclose(gates, chosen / chosen.sum(-1, keepdim=True)
                          * 2.446, atol=0, rtol=0)


def test_the_shared_expert_adds_to_the_routed_ones():
    """An MoE layer's output is its routed experts' gate-weighted sum plus
    the shared SwiGLU of every token: with the shared weights zeroed the
    difference is that SwiGLU."""
    cfg, c, params = _world()
    layer = params["layers"][1]
    h = torch.randn(2, 7, c.d_model, generator=torch.Generator().manual_seed(2))
    full, _ = moe._moe_ffn(h, layer, c, capacity=7)
    routed, _ = moe._moe_ffn(h, {**layer, "shared_w_down": torch.zeros_like(
        layer["shared_w_down"])}, c, capacity=7)
    shared = F.silu(h @ layer["shared_w_gate"]) * (h @ layer["shared_w_up"])
    assert torch.allclose(full - routed, shared @ layer["shared_w_down"],
                          atol=1e-5, rtol=0)


def test_the_first_layer_is_dense():
    cfg, c, params = _world()
    assert [c.is_moe_layer(i) for i in range(2)] == [False, True]
    assert params["layers"][0]["w_gate"].shape == (64, 128)
    assert params["layers"][1]["w_gate"].shape == (8, 64, 32)


def _route_before(logits, top_k, capacity):
    """``moe._route`` as it was before the DeepSeek router was added, for
    the check that the Mixtral path's bits did not move."""
    b, s, e = logits.shape
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    masked = probs
    experts, gates, masks = [], [], []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        mask = F.one_hot(idx, e).to(torch.float32)
        experts.append(idx)
        gates.append((probs * mask).sum(dim=-1))
        masks.append(mask)
        masked = masked * (1.0 - mask)
    denom = sum(gates) + 1e-9
    claimed = torch.zeros((b, 1, e), dtype=torch.float32,
                          device=logits.device)
    slots = []
    for mask in masks:
        pos = torch.cumsum(mask, dim=1) - mask + claimed
        claimed = claimed + mask.sum(dim=1, keepdim=True)
        queue = (pos * mask).sum(dim=-1)
        slots.append(torch.where(queue < capacity, queue.long(), -1))
    frac = masks[0].mean(dim=1)
    pmass = probs.mean(dim=1)
    aux = e * (frac * pmass).sum(dim=-1).mean()
    return (torch.stack(experts, -1), torch.stack(slots, -1),
            torch.stack([g / denom for g in gates], -1), aux)


def _mixtral_and_mistral_logits():
    """Both families at the small sizes (bf16, so every rounding shows):
    the forward's logits, and an engine's picked logits through bucketed
    prefill and decode."""
    from h100bench import moe_weights, weights
    from h100bench.families import decoder_lm, moe_lm
    from tpu_composer_torch.models import transformer

    out = []
    for name, family, make in (("mistral-7b", decoder_lm, weights),
                               ("mixtral-8x7b", moe_lm, moe_weights)):
        cfg = config(name, dtype="bfloat16")
        c = family.program_config(cfg)
        params = make.make_weights(cfg, 5, "cpu")
        tokens = torch.tensor([_prompt(24, 4), _prompt(24, 9)])
        fwd = (moe.forward(params, tokens, c)[0] if name == "mixtral-8x7b"
               else transformer.forward(params, tokens, c))
        eng = _engine(c, params)
        seen = _logged(eng)
        _serve(eng, SIZES[:3])
        out += [fwd] + [torch.stack(v) for _, v in sorted(seen.items())]
    return out


def test_mixtral_and_mistral_forwards_are_unchanged(monkeypatch):
    """The routing now dispatches on the config's scoring and the queue
    slots are a function of their own; with the previous ``_route``
    patched back in, every logit of both families is the same bits."""
    now = _mixtral_and_mistral_logits()
    monkeypatch.setattr(moe, "_route", _route_before)
    before = _mixtral_and_mistral_logits()
    assert len(now) == len(before) == 8
    assert all(torch.equal(a, b) for a, b in zip(now, before))


# -- the engine's spans and refusals -----------------------------------------

@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_spans_of_an_admission_and_an_eager_decode(ring):
    """``mla.attend`` expands under ``serving.admit`` (positions: the
    padded prompt) and absorbs under ``serving.decode`` (positions: the
    entries read); the MoE layer's ``moe.route`` says ``sigmoid`` and a
    ``moe.shared`` follows its combine; ``serving.decode`` carries the
    latent entries read over both layers and its K3 launches (0 here)."""
    cfg, c, params = _world()
    eng = _engine(c, params)
    eng.submit(_prompt(11, 1), 3)
    eng.step()
    eng.submit(_prompt(6, 2), 3)
    eng.step()
    events = ring.snapshot(cat="serving")
    by_id = {e["id"]: e for e in events}

    def under(parent, name):
        return [e for e in events if e["name"] == name
                and by_id[e["args"]["parent_span"]]["name"] == parent]

    attends = under("serving.admit", "mla.attend")
    assert [e["args"]["path"] for e in attends] == ["expand"] * 4
    assert [e["args"]["positions"] for e in attends] == [16, 16, 8, 8]
    attends = under("serving.decode", "mla.attend")
    assert [e["args"]["path"] for e in attends] == ["absorb"] * 4
    assert [e["args"]["positions"] for e in attends] == [12, 12, 20, 20]
    routes = [e for e in events if e["name"] == "moe.route"]
    assert routes and all(e["args"]["score"] == "sigmoid" for e in routes)
    phases = [e["name"] for e in events if e["name"].startswith("moe.")
              and by_id[e["args"]["parent_span"]]["name"] == "serving.decode"]
    assert phases == 2 * ["moe.route", "moe.dispatch", "moe.experts",
                          "moe.combine", "moe.shared"]
    dec = [e for e in events if e["name"] == "serving.decode"]
    assert [(e["args"]["latent_positions"], e["args"]["k3"])
            for e in dec] == [(2 * 12, 0), (2 * (13 + 7), 0)]


@pytest.mark.parametrize("what", ["kv_quant", "prefill_chunk", "attn_impl",
                                  "generate",
                                  "chunk"])
def test_what_the_latent_pool_does_not_take_is_refused(what):
    cfg, c, params = _world()
    tokens = torch.tensor([_prompt(8, 1)])
    with pytest.raises(ValueError, match="MLA"):
        if what == "kv_quant":
            _engine(c, params, kv_quant=True)
        elif what == "prefill_chunk":
            _engine(c, params, prefill_chunk=8)
        elif what == "attn_impl":
            dataclasses.replace(c, attn_impl="reference")
        elif what == "generate":
            decode.generate(params, tokens, c, max_new_tokens=2, max_seq=32)
        else:
            cache = paged.init_paged_cache(c, 1, 8, 4, device="cpu")
            paged.paged_decode_chunk(params, cache, tokens[:, :2], c)


# -- planted faults: each one fails the benchmark's comparison ---------------

def _no_k_pe_rope(monkeypatch):
    """The shared k_pe enters the pool unrotated."""
    rope = mla._rope
    monkeypatch.setattr(mla, "_rope", lambda x, pos, theta: (
        x if x.shape[-2] == 1 else rope(x, pos, theta)))


def _no_kv_norm(monkeypatch):
    """c_kv enters the pool without its RMSNorm."""
    norm = mla._rmsnorm
    monkeypatch.setattr(mla, "_rmsnorm", lambda x, g: (
        x if g.shape[0] == 32 else norm(x, g)))


def _shared_dropped(monkeypatch):
    """The shared expert adds nothing."""
    ffn = moe.swiglu_ffn
    monkeypatch.setattr(moe, "swiglu_ffn", lambda h, layer, dtype, mesh=None:
                        torch.zeros_like(h) if len(layer) == 3
                        else ffn(h, layer, dtype, mesh))


def _gates_from_selection(monkeypatch):
    """The gates normalise s + bias, not s."""
    def route(logits, bias, top_k, capacity, scale):
        experts, slots, _, aux = moe_route(logits, bias, top_k, capacity,
                                           scale)
        chosen = (torch.sigmoid(logits) + bias).gather(-1, experts)
        return experts, slots, chosen / chosen.sum(-1, keepdim=True) * scale, aux

    moe_route = moe._route_sigmoid
    monkeypatch.setattr(moe, "_route_sigmoid", route)


def _scaling_left_out(monkeypatch):
    """The gates are not scaled by routed_scaling_factor."""
    route = moe._route_sigmoid
    monkeypatch.setattr(moe, "_route_sigmoid", lambda logits, bias, k, cap,
                        scale: route(logits, bias, k, cap, 1.0))


def _small_mix():
    m = mix("reason")
    m["output"] = {"dist": "uniform", "min": 4, "max": 16}
    return m


def _run(seed=2**31 + 21):
    return R.execute(BENCH, CELL, seed, 0.6, False, "cpu", cfg=_cfg(),
                     mix=_small_mix())


@pytest.mark.parametrize("fault", [_no_k_pe_rope, _no_kv_norm,
                                   _shared_dropped, _gates_from_selection,
                                   _scaling_left_out])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """At this size the router's scores sit near 0 or 1 (N(0, 0.5)
    weights), so the selection bias is drawn as wide as they spread, for
    the gates-from-selection fault to show in the logits."""
    monkeypatch.setattr(J, "limits", lambda name: EXACT)
    monkeypatch.setattr(mla_weights, "BIAS_STD", 1.0)
    sound = _run()
    assert sound["correct"], sound["checks"]
    fault(monkeypatch)
    out = _run()
    assert not out["correct"]
    assert any(out["checks"][k]["value"] > EXACT[k] for k in EXACT)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_the_engine_on_the_card_runs_k1_192_and_k3_in_its_graph(ring):
    """At K3's widths (16 heads, entries 512 + 64, nope 128, v 128) in
    bf16: admissions launch K1's 192 instance, the decode step replays
    K3 from its graph (``serving.decode`` counts 2 launches, one a
    layer), and the graphed engine's tokens and logits equal an eager
    engine's on the same requests."""
    from tpu_composer_torch.ops.attention import flash_fwd_cuda

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cfg = config("moonlight-16b-a3b", dtype="bfloat16", std=0.02)
    cfg.update(hidden_size=256, num_attention_heads=16, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=1,
               moe_intermediate_size=64)
    c = program_config(cfg)
    params = make_weights(cfg, 3, "cuda")
    runs = []
    for graphed in (True, False):
        eng = ContinuousBatchingEngine(params, c, slots=3, num_blocks=48,
                                       block_size=16, attn_impl="kernel",
                                       record_routes=True)
        eng._graphed = graphed
        seen = _logged(eng)
        before = flash_fwd_cuda.launches
        reqs = _serve(eng, [(40, 6), (17, 9), (70, 5)])
        assert flash_fwd_cuda.launches - before == 3 * 2
        runs.append(([r.tokens for r in reqs], seen))
    assert runs[0][0] == runs[1][0]
    for rid, logits in runs[0][1].items():
        assert all(torch.equal(a, b) for a, b in zip(logits, runs[1][1][rid]))
    decodes = [e["args"] for e in ring.snapshot(cat="serving")
               if e["name"] == "serving.decode"]
    assert {a["k3"] for a in decodes} == {2}

