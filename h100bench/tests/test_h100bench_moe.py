"""The MoE cell's harness (``drivers/serve_moe.py``, ``judge_moe.py``,
``references/moe_lm.py``, ``moe_weights.py``, ``moe_counts.py``, its
readers and its control) on the CPU at a small size. The planted faults
of the program are tier-1 tests (``tests/test_torch_mixtral.py``)."""

import json

import pytest
import torch

from h100bench import judge as J
from h100bench import moe_counts as C
from h100bench import run as R
from h100bench.control_moe import ControlJudge
from h100bench.drivers import serve_moe
from h100bench.families import moe_lm as family
from h100bench.moe_weights import make_layer, make_weights
from h100bench.tests.small import BENCH, HERE, cell, config, mix
from tpu_composer_torch.runtime import tracing

NAME = "mixtral-8x7b.decode"
EXACT = {"max_gap": 1e-3, "route_gap_max": 1e-3}


def small_mix(**kw):
    m = mix("decode")
    m["output"] = {"dist": "uniform", "min": 4, "max": 16}
    m.update(kw)
    return m


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setattr(J, "limits", lambda name: EXACT)


@pytest.mark.parametrize("seed", [2**31 + 77, 12345])
def test_served_tokens_and_routes_match_the_reference(exact, seed):
    out = R.execute(BENCH, cell(NAME), seed, 0.6, False, "cpu",
                    cfg=config("mixtral-8x7b"), mix=small_mix())
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["max_gap"] < 1e-4 and checks["route_gap_max"] == 0.0
    assert checks["route_mismatch_pct"] == 0.0
    assert checks["route_checks"] >= 2 * checks["tokens"] >= 64
    assert set(out["metrics"]) == {"gen_tok_s", "setup_s"}


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_a_traced_run_reports_the_cells_span_and_clock_readers(ring, exact):
    out = R.execute(BENCH, cell(NAME), 2**31 + 5, 2.0, True, "cpu",
                    cfg=config("mixtral-8x7b"),
                    mix=small_mix(trace_seconds=0.5))
    got = {k: v["value"] for k, v in out["metrics"].items()}
    listed = {m["name"] for m in BENCH["per_layer"]
              if NAME in m.get("workloads", [NAME])}
    assert set(got) <= listed
    # What a CPU run can read: the spans and the host clock (the device
    # readers need the card's peaks, memory and kernels).
    assert {"moe_rows_pct.moe", "moe_admit_ms.moe", "decode_step_ms.moe",
            "admit_share.moe", "decode_graph_pct.moe"} <= set(got)
    assert got["moe_rows_pct.moe"] == pytest.approx(25.0)
    assert got["moe_admit_ms.moe"] > 0
    assert got["decode_graph_pct.moe"] == 0.0


def test_rows_share_reads_the_graphed_decode_span(ring):
    """A replayed step carries its sums on ``serving.decode``; an eager
    admission carries them on its ``moe.experts`` spans."""
    from types import SimpleNamespace

    ms = 1_000_000
    t0 = tracing._clock()
    ring.record([
        ("serving.step", "serving", t0, t0 + 10 * ms, None,
         {"rows": 4, "tokens": 4, "syncs": 3}),
        ("serving.admit", "serving", t0, t0 + 5 * ms, 0, {}),
        ("moe.experts", "serving", t0 + ms, t0 + 2 * ms, 1,
         {"rows": 80, "real": 40}),
        ("serving.decode", "serving", t0 + 6 * ms, t0 + 8 * ms, 0,
         {"graph": 1, "rows": 120, "real": 30})])
    step = {"t0": (t0 - 10_000) / 1e9, "t1": (t0 + 10 * ms) / 1e9,
            "admit": True, "rows": 4, "traced": False}
    run = SimpleNamespace(steps=[step])
    assert R.metric_reader("moe_rows_pct.moe").read(run) == pytest.approx(35.0)
    assert R.metric_reader("moe_admit_ms.moe").read(run) == pytest.approx(1.0)


def test_counts_closed_form():
    d = C.MoEDims(json.loads((HERE / "configs" / "mixtral-8x7b.json").read_text()))
    attn = 4096 * 32 * 128 + 2 * 4096 * 8 * 128 + 32 * 128 * 4096
    expert = 3 * 4096 * 14336
    assert d.layer_matmul_params() == attn + 4096 * 8 + 2 * expert
    assert d.matmul_params() == 16 * (attn + 4096 * 8 + 2 * expert) + 32000 * 4096
    held = 16 * ((attn + 8 * expert) * 2 + 4 * 4096 * 8) + 32000 * 4096 * 2
    assert d.held_bytes() == held and 46.5e9 < held < 46.9e9
    assert d.kv_bytes_per_position() == 64 * 1024
    assert C.decode_floor_bytes(d, 128, 1000) == (
        held + 128 * 2 * 32 * 128 * 2 * 16 + 1000 * 64 * 1024)


def test_weights_have_the_programs_layout_and_remake_alone():
    cfg = config("mixtral-8x7b", dtype="bfloat16")
    w = make_weights(cfg, 9, "cpu")
    layer = w["layers"][1]
    assert layer["w_gate"].shape == (8, 64, 128)
    assert layer["w_down"].shape == (8, 128, 64)
    assert layer["w_router"].shape == (64, 8)
    assert layer["w_router"].dtype == torch.float32
    assert layer["w_up"].dtype == torch.bfloat16
    again = make_layer(cfg, 9, 1, "cpu")
    assert all(torch.equal(layer[k], again[k]) for k in layer)
    assert not torch.equal(layer["w_gate"], w["layers"][0]["w_gate"])


def test_a_program_without_dropless_routing_refuses_the_family(monkeypatch):
    monkeypatch.delattr(family.MoEConfig, "dropless")
    with pytest.raises(SystemExit):
        family.program_config(config("mixtral-8x7b"))


@pytest.mark.parametrize("seed", [3, 4])
def test_control_reads_wider_than_the_program(seed):
    ctx = R.Ctx(cell(NAME), config("mixtral-8x7b", dtype="bfloat16", std=0.2),
                small_mix(), seed, 0.5, False, "cpu")
    judge = ControlJudge()
    serve_moe.run(ctx, judge=judge)
    prog, ctrl = judge.out["program"], judge.out["control"]
    assert ctrl["max_gap"] > prog["max_gap"]
    assert ctrl["route_gap_max"] > 3 * prog["route_gap_max"]
