"""The plain reference against the program on the CPU at a small size:
the served tokens agree to rounding in float32, and the comparison
machinery reports it."""

import pytest

from h100bench import judge as J
from h100bench import run as R
from h100bench.tests.small import BENCH, EXACT, cell, config, mix


@pytest.fixture
def exact(monkeypatch):
    """Limits for a float32 run: the program and the reference then agree
    to rounding."""
    monkeypatch.setattr(J, "limits", lambda name: EXACT)


def run_small(trace=False, seed=2**31 + 77):
    return R.execute(BENCH, cell(), seed, 0.6, trace, "cpu", cfg=config(),
                     mix=mix())


@pytest.mark.parametrize("seed", [2**31 + 77, 12345])
def test_served_tokens_match_the_reference(exact, seed):
    out = run_small(seed=seed)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_gap"]["value"] < 1e-4
    assert out["checks"]["tokens"]["value"] >= 32
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {"gen_tok_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reports_the_cells_per_layer_metrics(exact):
    out = run_small(trace=True)
    assert set(out["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}
    assert "admit_share.serve" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
