"""Readings that set an MoE cell's limits, at the cell's own size.

    python3 -m h100bench.control_moe --workload <cell> --seeds 5,6,7 --seconds 10

runs the cell's program once per seed in one process, as a benchmark run
does, and prints one JSON line per seed with two sets of readings, each
by the judge's own measure (``h100bench/judge_moe.py``):

- ``program``: the program against the reference under the program's
  routing (a sound run's reading; the largest over a dozen seeds or more
  is the lower reading);
- ``control``: the reference one precision below the configuration's
  bfloat16 (float8 e4m3 operands in every weight matmul, the router's
  included) routes itself; its routing is forced on the float32
  reference, which is read at the tokens float8 puts first.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Dict, List

from h100bench import judge as J
from h100bench.judge_moe import serve_readings
from h100bench.run import HERE, ROOT, Ctx, cell_spec, load_json


class ControlJudge:
    def __init__(self):
        self.out: Dict = {}

    def serve(self, ctx, weights, served) -> List[Dict]:
        self.out = serve_readings(ctx.cfg, weights, served, "fp8")
        return J.compare(ctx.cell["name"], self.out["program"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_spec(bench, args.workload)
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"h100bench.drivers.{mix['kind']}")
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = Ctx(cell, cfg, mix, seed, args.seconds, False, "cuda")
        judge = ControlJudge()
        out = driver.run(ctx, judge=judge)
        print(json.dumps({"seed": seed, "e2e": out["e2e"], **judge.out}),
              flush=True)
        del out, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
