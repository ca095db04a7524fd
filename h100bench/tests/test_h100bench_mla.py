"""The latent-attention MoE cell's harness (``drivers/serve_mla.py``,
``references/mla_moe_lm.py``, ``mla_weights.py``, ``mla_counts.py``, its
readers) on the CPU at a small size, and its counts at the published
widths. The program's own planted faults are tier-1 tests
(``tests/test_torch_moonlight.py``)."""

import json

import pytest
import torch

from h100bench import judge as J
from h100bench import mla_counts as C
from h100bench import run as R
from h100bench.tests.small import BENCH, HERE, cell, config, mix
from tpu_composer_torch.models import moe
from tpu_composer_torch.runtime import tracing

NAME = "moonlight-16b-a3b.reason"
EXACT = {"max_gap": 1e-3, "route_gap_max": 1e-3}


def published():
    return json.loads((HERE / "configs" / "moonlight-16b-a3b.json").read_text())


def small_cfg():
    cfg = config("moonlight-16b-a3b")
    cfg.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=1, moe_intermediate_size=32)
    return cfg


def small_mix():
    m = mix("reason")
    m["output"] = {"dist": "uniform", "min": 4, "max": 16}
    return m


def test_counts_at_the_published_widths():
    """15.62 B parameters with the head tied, 31,104 bytes of latent a
    position, and a 13.1 ms bytes floor at 128 rows of 3,189 positions
    (31.26 GB of weights, 12.70 GB of latent, 0.12 GB of queries and
    latent outputs: 13.16 ms)."""
    d = C.MLADims(published())
    assert round(d.params() / 1e9, 2) == 15.62
    assert d.latent_bytes_per_position() == 27 * 576 * 2 == 31104
    floor_ms = C.decode_floor_bytes(d, 128, 128 * 3189) / 3.35e12 * 1e3
    assert 13.1 <= floor_ms < 13.2
    assert d.pair_flops() == 2 * 16 * (192 + 128) * 27


@pytest.fixture
def exact(monkeypatch):
    monkeypatch.setattr(J, "limits", lambda name: EXACT)


@pytest.mark.parametrize("seed", [2**31 + 77, 12345])
def test_served_tokens_and_routes_match_the_reference(exact, seed):
    out = R.execute(BENCH, cell(NAME), seed, 0.6, False, "cpu",
                    cfg=small_cfg(), mix=small_mix())
    assert out["correct"], out["checks"]
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["max_gap"] < 1e-4 and checks["route_gap_max"] == 0.0
    assert checks["route_checks"] >= checks["tokens"] > 0
    assert set(out["metrics"]) == {"gen_tok_s", "setup_s"}


def test_planted_faults_are_not_correct(exact, monkeypatch):
    """The gates left unscaled, then the shared expert dropped."""
    route, ffn = moe._route_sigmoid, moe.swiglu_ffn
    monkeypatch.setattr(moe, "_route_sigmoid", lambda logits, bias, k, cap,
                        scale: route(logits, bias, k, cap, 1.0))
    out = R.execute(BENCH, cell(NAME), 2**31 + 5, 0.6, False, "cpu",
                    cfg=small_cfg(), mix=small_mix())
    assert not out["correct"]
    monkeypatch.setattr(moe, "_route_sigmoid", route)
    monkeypatch.setattr(moe, "swiglu_ffn", lambda h, layer, dtype, mesh=None:
                        torch.zeros_like(h) if len(layer) == 3
                        else ffn(h, layer, dtype, mesh))
    out = R.execute(BENCH, cell(NAME), 2**31 + 5, 0.6, False, "cpu",
                    cfg=small_cfg(), mix=small_mix())
    assert not out["correct"]


@pytest.fixture
def ring():
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    yield tracing
    tracing.set_enabled(was)
    tracing.reset()


def test_a_traced_run_reports_the_cells_span_and_clock_readers(ring, exact):
    """On the CPU the device readers (rooflines, floor, MFU, idle, memory)
    find nothing and report nothing; the span and clock readers read,
    the cell's own and the dense and MoE cells' that list it too. The
    window's last half second is traced, so that untraced admissions and
    requests finished before the trace are in it, as on the card."""
    m = small_mix()
    m["trace_seconds"] = 0.5
    out = R.execute(BENCH, cell(NAME), 2**31 + 5, 2.0, True, "cpu",
                    cfg=small_cfg(), mix=m)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {"moe_rows_pct.mla", "decode_step_ms.mla",
                      "admit_share.mla", "decode_graph_pct.mla",
                      "kv_used_pct.serve", "host_syncs_per_step.batch",
                      "host_sync_ms.batch", "engine_self_ms.batch",
                      "admit_ms.batch", "prefill_pad_pct.batch",
                      "tpot_p90_ms.batch", "moe_admit_ms.moe"}
    assert 0 < m["kv_used_pct.serve"] < 100
    assert 0 < m["prefill_pad_pct.batch"] < 100
    assert m["moe_admit_ms.moe"] > 0
    assert m["moe_rows_pct.mla"] == pytest.approx(25.0)
    assert m["decode_graph_pct.mla"] == 0.0


def test_the_span_readers_read_a_program_without_latent_spans_as_nothing():
    """The K3 reader finds no ``latent_positions`` where the program does
    not write them, and reports nothing."""
    from types import SimpleNamespace

    reader = R.metric_reader("k3_roofline.mla")
    trace = SimpleNamespace(kernel_seconds=lambda parts: 0.0)
    run = SimpleNamespace(peaks={"hbm_bytes_s": 3.35e12}, trace=trace,
                          traced_steps=[], cfg=published())
    assert reader.read(run) is None
