"""The control: the reference one precision below bfloat16 (float8
operands) put in the program's place reads far wider gaps than the
bfloat16 program. On the CPU at a small size, and on the card at the
cell's own size (marked ``cuda``)."""

import json
import subprocess
import sys

import pytest

from h100bench import judge as J
from h100bench.control import ControlJudge
from h100bench.drivers import serve
from h100bench.run import ROOT, Ctx
from h100bench.tests.small import BENCH, cell, config, mix


def control_small(seed):
    ctx = Ctx(cell(), config(dtype="bfloat16", std=0.2), mix(), seed, 0.5,
              False, "cpu")
    ctx.judge = ControlJudge()
    serve.run(ctx)
    return ctx.judge.out


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_control_reads_wider_than_the_program(seed):
    out = control_small(seed)
    assert out["control"]["mean_gap"] > 3 * out["program"]["mean_gap"]
    assert out["control"]["max_gap"] > out["program"]["max_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["workloads"]])
def test_control_fails_the_limit_at_the_cells_size(card, name):
    limit = J.limits(name)["max_gap"]
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.control", "--workload", name,
         "--seeds", "2147480001", "--seconds", "10"],
        cwd=ROOT, text=True, capture_output=True, timeout=900, check=True)
    read = json.loads(out.stdout.strip().splitlines()[-1])
    assert read["program"]["max_gap"] <= limit < read["control"]["max_gap"]
