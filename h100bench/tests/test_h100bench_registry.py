"""The harness finds every configuration, mix, driver, reference and
metric by the names in BENCHMARK.json, and the files agree with it."""

import importlib
import json

import pytest

from h100bench import run as R
from h100bench.tests.small import BENCH, HERE


def test_every_cell_resolves_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        cfg = json.loads((HERE.parent / configs[cell["config"]]["file"]).read_text())
        mix = R.load_json(HERE / "mixes" / f"{cell['traffic']}.json")
        importlib.import_module(f"h100bench.drivers.{mix['kind']}")
        importlib.import_module(f"h100bench.families.{cfg['family']}")
        importlib.import_module(f"h100bench.references.{cfg['reference']}")
        assert (HERE / "limits" / f"{cell['name']}.json").exists()


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((HERE.parent / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert sorted(cfg["source_values"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
        for key, was in cfg["source_values"].items():
            assert cfg[key] != was


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_declares_what_benchmark_says(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = R.metric_reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[entry["moves"]]
    for cell in entry["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        R.cell_spec(BENCH, "no-such-cell")


def test_run_refuses_without_enough_cards(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_step_readers_leave_out_the_traced_part():
    from types import SimpleNamespace

    steps = [{"t0": 0.0, "t1": 0.1, "admit": False, "rows": 4, "traced": False},
             {"t0": 0.1, "t1": 0.4, "admit": True, "rows": 4, "traced": False},
             {"t0": 5.0, "t1": 5.5, "admit": False, "rows": 4, "traced": True}]
    reqs = [{"first": 0.0, "last": 1.0, "tokens": 11},    # 100 ms a token
            {"first": 0.5, "last": 2.5, "tokens": 11},    # 200 ms a token
            {"first": 1.0, "last": 1.1, "tokens": 1},     # one token: no TPOT
            {"first": 2.0, "last": 6.0, "tokens": 2}]     # ends in the trace
    run = SimpleNamespace(steps=steps, requests=reqs)
    tpot = R.metric_reader("tpot_p90_ms.batch").read(run)
    assert tpot == pytest.approx(1e3 * (0.1 + 0.9 * 0.1))
    assert R.metric_reader("decode_step_ms.batch").read(run) == pytest.approx(100.0)
    run.requests = reqs[2:3]
    assert R.metric_reader("tpot_p90_ms.batch").read(run) is None
