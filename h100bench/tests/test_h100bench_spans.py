"""The readers of the program's serving spans (``h100bench/spans.py``): a
traced run at small sizes on the CPU reports all six, and a reader
reports nothing where the ring lacks a step it reads."""

import time
from types import SimpleNamespace

import pytest

from h100bench import judge as J
from h100bench import run as R
from h100bench.tests.small import BENCH, EXACT, cell, config, mix
from tpu_composer_torch.runtime import tracing

SPANS = ("decode_dispatch_ms.batch", "host_sync_ms.batch",
         "host_syncs_per_step.batch", "engine_self_ms.batch",
         "admit_ms.batch", "prefill_pad_pct.batch")
MS = 1_000_000  # ns


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_a_traced_run_reports_every_span_metric(ring, monkeypatch):
    monkeypatch.setattr(J, "limits", lambda name: EXACT)
    m = mix()
    m["trace_seconds"] = 0.5
    out = R.execute(BENCH, cell(), 2**31 + 5, 2.0, True, "cpu",
                    cfg=config(), mix=m)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPANS) <= set(got), sorted(got)
    assert got["host_syncs_per_step.batch"] >= 5
    assert 0 < got["prefill_pad_pct.batch"] < 100
    assert got["admit_ms.batch"] > 0
    # The three parts of a decode-only step add up to its span, which the
    # benchmark's host clock brackets.
    parts = sum(got[k] for k in ("decode_dispatch_ms.batch",
                                 "host_sync_ms.batch", "engine_self_ms.batch"))
    assert parts == pytest.approx(got["decode_step_ms.batch"], rel=0.05)


def _step(t0):
    """A decode-only step's tree recorded at ``t0`` (perf_counter ns) and
    the benchmark's booking of it: 10 ms, 7 of them in the decode call, 1 of
    which a host sync."""
    tracing.record([
        ("serving.step", "serving", t0, t0 + 10 * MS, None,
         {"rows": 4, "tokens": 4, "syncs": 5}),
        ("serving.decode", "serving", t0 + MS, t0 + 8 * MS, 0, {}),
        ("serving.sync", "serving", t0 + 7 * MS, t0 + 8 * MS, 1,
         {"what": "write_rows"}),
        ("serving.emit", "serving", t0 + 8 * MS, t0 + 9 * MS, 0, {})])
    return {"t0": (t0 - 10_000) / 1e9, "t1": (t0 + 10 * MS + 10_000) / 1e9,
            "admit": False, "rows": 4, "traced": False}


def _read(steps):
    run = SimpleNamespace(steps=steps)
    return [R.metric_reader(m).read(run) for m in SPANS[:4]]


def test_a_step_missing_from_the_ring_reads_as_nothing(ring):
    assert _read([{"t0": 0.0, "t1": 1.0, "admit": False, "rows": 4,
                   "traced": False}]) == [None] * 4
    t0 = time.perf_counter_ns()
    steps = [_step(t0 + i * 20 * MS) for i in range(3)]
    assert _read(steps) == pytest.approx([6.0, 1.0, 5, 3.0])
    ring.reset()
    _step(t0)
    _step(t0 + 40 * MS)
    assert _read(steps) == [None] * 4
