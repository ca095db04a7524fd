"""The serving engine's spans (``models/serving.py`` through
``runtime/tracing.py``): one ``serving.step`` tree per step, its phases
nested and in order, every host sync counted by site, nothing recorded
and nothing changed with recording off, and ring timestamps on the clock
``torch.profiler`` stamps its events with.

The test marked ``cuda`` holds the engine's count of host syncs to what
CUDA itself reports under ``torch.cuda.set_sync_debug_mode("warn")``, so
no sync on the serving path goes uncounted. This file imports no JAX; on
the card:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_trace.py -q
"""

from __future__ import annotations

import traceback
import warnings

import numpy as np
import pytest
import torch

from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.models.transformer import ModelConfig, init_params
from tpu_composer_torch.runtime import tracing

torch.set_num_threads(1)

#: A decode-only step's sync leaves: the next tokens and the active mask
#: in one upload (two copies), then the tokens read with the pool's ok.
DECODE_SYNCS = [("upload", 2), ("tokens", 1)]
#: What CUDA's sync debug mode says at each synchronizing operation.
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def ring():
    """Recording on, an empty ring; the switch and capacity restored."""
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.configure(10_000)
    yield tracing
    tracing.set_enabled(was)
    tracing.configure(10_000)


def _engine(device="cpu", dtype=torch.float32, attn="reference",
            engine_attn="gather", d_model=64, slots=4):
    c = ModelConfig(vocab_size=256, d_model=d_model, n_layers=2,
                    n_heads=4, n_kv_heads=2, d_ff=2 * d_model, max_seq=256,
                    dtype=dtype, attn_impl=attn)
    params = init_params(c, seed=0, device=device)
    return ContinuousBatchingEngine(params, c, slots=slots, num_blocks=64,
                                    block_size=8, attn_impl=engine_attn)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _trees():
    """{root id: (root, [its descendants])} of the ring's serving spans."""
    events = tracing.snapshot(cat="serving")
    by_id = {e["id"]: e for e in events}
    roots = {e["id"]: (e, []) for e in events if e["name"] == "serving.step"}
    for e in events:
        up = e["args"].get("parent_span")
        while up is not None and up not in roots:
            up = by_id[up]["args"].get("parent_span")
        if e["name"] != "serving.step":
            assert up is not None, e
            roots[up][1].append(e)
    return list(roots.values())


def _children(tree, parent):
    return [e for e in tree[1] if e["args"]["parent_span"] == parent["id"]]


def _end(e):
    return e["ts"] + e["dur"]


def _run(eng, steps, prompts, max_new):
    reqs = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    for _ in range(steps):
        eng.step()
    return reqs


def test_each_step_records_one_tree_of_nested_ordered_phases(ring):
    eng = _engine()
    _run(eng, 7, [_prompt(20, 1), _prompt(9, 2), _prompt(33, 3)], [5, 3, 6])
    trees = _trees()
    assert len(trees) == 7
    names = set()
    for tree in trees:
        root, spans = tree
        assert "parent_span" not in root["args"]
        assert root["args"]["syncs"] == sum(
            e["args"].get("count", 1) for e in spans
            if e["name"] == "serving.sync")
        for parent in [root] + spans:
            kids = sorted(_children(tree, parent), key=lambda e: e["ts"])
            for kid in kids:
                assert parent["ts"] <= kid["ts"] <= _end(kid) <= _end(parent)
            for a, b in zip(kids, kids[1:]):
                assert _end(a) <= b["ts"]
        phases = [e["name"] for e in sorted(_children(tree, root),
                                            key=lambda e: e["ts"])
                  if e["name"] != "serving.sync"]
        assert phases in (["serving.admit", "serving.decode", "serving.emit"],
                          ["serving.decode", "serving.emit"]), phases
        names.update(e["name"] for e in spans)
    assert names == {"serving.admit", "serving.decode", "serving.emit",
                     "serving.sync"}


def test_a_decode_only_step_counts_five_syncs_by_site(ring):
    eng = _engine()
    _run(eng, 2, [_prompt(12, 1), _prompt(12, 2)], [8, 8])
    ring.reset()
    events = eng.step()
    (root, spans), = _trees()
    assert len(events) == root["args"]["rows"] == root["args"]["tokens"] == 2
    assert root["args"]["syncs"] == 3
    syncs = sorted((e for e in spans if e["name"] == "serving.sync"),
                   key=lambda e: e["ts"])
    assert [(e["args"]["what"], e["args"].get("count", 1))
            for e in syncs] == DECODE_SYNCS
    decode, = [e for e in spans if e["name"] == "serving.decode"]
    assert decode["args"]["graph"] == 0  # a CPU engine runs it eagerly
    assert [e["args"]["parent_span"] for e in syncs] == [decode["id"],
                                                         root["id"]]
    assert len(spans) + 1 <= 12


def test_a_finishing_slot_adds_one_upload_under_emit(ring):
    eng = _engine()
    _run(eng, 1, [_prompt(12, 1)], [3])
    ring.reset()
    eng.step()
    (root, spans), = _trees()
    emit, = [e for e in spans if e["name"] == "serving.emit"]
    under = [e["args"]["what"] for e in _children((root, spans), emit)]
    assert under == ["upload"] and root["args"]["syncs"] == 4


def test_a_bucketed_admission_records_real_and_padded_lengths(ring):
    eng = _engine()
    eng.submit(_prompt(20), 4)
    eng.step()
    (root, spans), = _trees()
    admit, = [e for e in spans if e["name"] == "serving.admit"]
    assert (admit["args"]["prompt"], admit["args"]["padded"]) == (20, 32)
    assert admit["args"]["req_id"] == 0
    assert root["args"]["tokens"] == 2 and root["args"]["rows"] == 1
    whats = [e["args"]["what"] for e in sorted(
        _children((root, spans), admit), key=lambda e: e["ts"])]
    # The padded prompt with its slot and length, then the first token
    # read with the pool's ok.
    assert whats == ["upload", "first_token"]
    assert root["args"]["syncs"] == 2 + 3


@pytest.mark.parametrize("kw, whats", [
    ({}, [("upload", 1), ("first_token", 1)]),
    (dict(temperature=0.8, top_k=20, seed=3),
     [("upload", 1), ("upload", 4), ("first_token", 1)]),
], ids=["greedy", "sampled"])
def test_a_bucketed_admission_uploads_once_and_reads_once(ring, kw, whats):
    """The padded prompt, its slot and its length go up in one copy, and
    the first token comes back with the pool's ok in one read; a sampled
    request's four sampling controls go up besides. A CPU engine's
    admission runs eagerly (``graph`` 0)."""
    eng = _engine()
    _run(eng, 2, [_prompt(12, 1)], [8])
    ring.reset()
    eng.submit(_prompt(40, 2), 4, **kw)
    eng.step()
    (root, spans), = _trees()
    admit, = [e for e in spans if e["name"] == "serving.admit"]
    assert admit["args"]["graph"] == 0 and admit["args"]["padded"] == 64
    assert [(e["args"]["what"], e["args"].get("count", 1)) for e in sorted(
        _children((root, spans), admit), key=lambda e: e["ts"])] == whats


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_admit_spans_say_eager_on_the_cpu(ring, chunk):
    """Every admission span of a CPU engine, bucketed or chunked, carries
    ``graph`` 0."""
    c = ModelConfig(vocab_size=256, d_model=64, n_layers=1, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=256, dtype=torch.float32)
    eng = ContinuousBatchingEngine(init_params(c, 0, device="cpu"), c,
                                   slots=2, num_blocks=32, block_size=8,
                                   prefill_chunk=chunk)
    eng.submit(_prompt(20), 2)
    eng.submit(_prompt(9, 1), 2)
    eng.run()
    flags = [e["args"]["graph"] for _, spans in _trees() for e in spans
             if e["name"] == "serving.admit"]
    assert flags == [0] * (2 if chunk is None else 5)


def test_a_chunked_admission_records_one_span_per_chunk(ring):
    c = ModelConfig(vocab_size=256, d_model=64, n_layers=1, n_heads=4,
                    n_kv_heads=2, d_ff=128, max_seq=256, dtype=torch.float32)
    eng = ContinuousBatchingEngine(init_params(c, 0, device="cpu"), c,
                                   slots=2, num_blocks=32, block_size=8,
                                   prefill_chunk=8)
    eng.submit(_prompt(20), 2)
    for _ in range(3):
        eng.step()
    admits = [e["args"] for _, spans in _trees() for e in spans
              if e["name"] == "serving.admit"]
    assert [(a["prompt"], a["padded"]) for a in admits] == [
        (8, 8), (8, 8), (4, 8)]


def test_recording_off_records_nothing_and_changes_no_token(ring):
    prompts = [_prompt(n, s) for n, s in ((20, 1), (9, 2), (33, 3), (5, 4))]
    out = {}
    for on in (True, False):
        ring.set_enabled(on)
        ring.reset()
        eng = _engine(slots=3)
        reqs = [eng.submit(p, m) for p, m in zip(prompts, (5, 9, 3, 7))]
        reqs.append(eng.submit(prompts[0], 6, temperature=0.8, top_k=20,
                               seed=3))
        eng.run()
        out[on] = [r.tokens for r in reqs]
        assert bool(ring.snapshot(cat="serving")) == on
    assert out[True] == out[False]


def test_ring_times_convert_onto_the_profilers_clock(ring):
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = _engine()
    eng.submit(_prompt(20), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            eng.step()
    outer, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "outer"]
    (root, _), = _trees()
    start, end = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    ms = 1_000_000
    assert start - ms <= ring.unix_ns(root["ts"]) <= ring.unix_ns(
        _end(root)) <= end + ms
    assert ring.chrome_doc()["metadata"]["ts0_unix_ns"] == ring.unix_ns(0.0)


def test_record_keeps_parent_ids_and_the_rings_bound(ring):
    base = ring._clock()
    ids = ring.record([("a", "t", base, base + 4000, None, {"k": 1}),
                       ("b", "t", base + 1000, base + 2000, 0, {}),
                       ("c", "t", base + 1500, base + 1800, 1, {})])
    a, b, c = ring.snapshot(cat="t")
    assert [a["id"], b["id"], c["id"]] == list(ids) == list(range(
        ids[0], ids[0] + 3))
    assert "parent_span" not in a["args"] and a["args"]["k"] == 1
    assert (b["args"]["parent_span"], c["args"]["parent_span"]) == (
        a["id"], b["id"])
    assert (a["dur"], b["dur"], c["dur"]) == (4.0, 1.0, 0.3)
    assert b["ts"] - a["ts"] == pytest.approx(1.0)
    # The bound counts calls: one call's spans stay or go together.
    ring.configure(5)
    for i in range(8):
        ring.record([(f"s{i}", "t", base, base + i, None, {})])
    ring.record([("x", "t", base, base + 9, None, {}), ("y", "t", base,
                                                       base + 9, 0, {})])
    assert [e["name"] for e in ring.snapshot()] == [
        "s4", "s5", "s6", "s7", "x", "y"]
    ring.set_enabled(False)
    assert not ring.record([("x", "t", base, base, None, {})])
    assert ring.open_tree("x", "t") is None


def test_a_host_sync_outside_a_tree_is_only_the_call(ring):
    assert ring.host_sync("tokens", int, torch.tensor(7)) == 7
    assert ring.snapshot() == []


def _counted(eng, what):
    """Step ``eng`` once under CUDA's sync debug mode; fail with the stack
    of every synchronizing operation unless CUDA's count, the engine's and
    ``what`` agree."""
    tracing.reset()
    stacks = []

    def show(message, *args, **kw):
        if SYNC_WARNING in str(message):
            stacks.append("".join(traceback.format_stack(limit=7)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    (root, spans), = _trees()
    ours = [e["args"]["what"] for e in sorted(spans, key=lambda e: e["ts"])
            if e["name"] == "serving.sync"]
    if not len(stacks) == root["args"]["syncs"] == what:
        pytest.fail(f"CUDA counted {len(stacks)}, the engine "
                    f"{root['args']['syncs']} ({ours}), expected {what}:"
                    "\n\n" + "\n".join(stacks))


def _replayed(eng, what):
    """:func:`_counted`, and the step's decode was one replay of the
    engine's CUDA graph."""
    replays = eng._graph.replays
    _counted(eng, what)
    assert eng._graph.replays == replays + 1


@pytest.mark.cuda
def test_every_sync_on_the_card_is_counted():
    """CUDA's own count of synchronizing operations in a decode-only step,
    a sampled decode step and a step that admits equals the engine's; and
    so in a chunked engine's admissions, one of them onto a shared
    prefix. Each step's decode is a replay of the engine's CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    tracing.set_enabled(True)
    eng = _engine(device="cuda", dtype=torch.bfloat16, attn="flash",
                  engine_attn="kernel", d_model=256, slots=4)
    # Kernels built, every shape warm and the decode graph captured before
    # counting.
    _run(eng, 4, [_prompt(20, 1), _prompt(40, 2)], [30, 30])
    torch.cuda.synchronize()
    _replayed(eng, 3)
    # A sampled request's admission (its inputs, its 4 sampling controls
    # and its first token: 6 syncs) and the step's decode, which now
    # samples: 3, and 4 uploads of the sampling controls.
    eng.submit(_prompt(20, 3), 30, temperature=0.7, top_k=10, seed=1)
    _replayed(eng, 13)
    _replayed(eng, 7)

    c = ModelConfig(vocab_size=256, d_model=256, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=512, max_seq=256, dtype=torch.bfloat16,
                    attn_impl="flash")
    eng = ContinuousBatchingEngine(init_params(c, 0, device="cuda"), c,
                                   slots=4, num_blocks=64, block_size=8,
                                   attn_impl="kernel", prefill_chunk=16)
    r = eng.submit(_prompt(20, 1), 30)
    while not r.tokens:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    prefix = _prompt(16, 2)
    handle = eng.register_prefix(prefix)
    # The attach reads its ok (1), its one chunk uploads its tokens and
    # active rows and reads its ok (3), the last chunk uploads the length
    # and reads the first token (2), and the decode step's 3.
    eng.submit(prefix + _prompt(10, 3), 30, prefix=handle)
    _replayed(eng, 9)
    eng.submit(_prompt(40, 4), 30)
    for what in (9, 6, 8, 3):  # reservation and chunk, chunk, last chunk
        _replayed(eng, what)
