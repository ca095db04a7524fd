"""Run one cell of the benchmark once and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``tpu_composer_torch``)
and ``BENCHMARK.json``. The cell names a configuration
(``h100bench/configs/<config>.json``) and a mix
(``h100bench/mixes/<traffic>.json``, whose ``kind`` picks
``h100bench/drivers/<kind>.py``); each per-layer metric that lists the
cell is read by ``h100bench/metrics/<metric>.py``. Nothing else is named
in code, so a cell, a mix or a metric is added by adding its files.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also close standard error. The run exits non-zero without a
result where CUDA is missing or has fewer cards than the cell asks for,
or where JAX or the JAX package was imported.
"""

from __future__ import annotations

import time


def _since_process_start() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0.0
    import os

    return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _since_process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_composer")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``tpu_composer_torch`` is not ``tpu_composer``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def cell_spec(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """What a driver needs from the harness: the cell, its configuration
    and mix, the seed and the window's length, the device, the clock, the
    tracer and the judge."""

    def __init__(self, cell: Dict, cfg: Dict, mix: Dict, seed: int,
                 seconds: float, trace: bool, device: str,
                 log: Callable[[str], None] = None):
        import torch

        from h100bench.judge import Judge
        from h100bench.trace import Tracer

        self.torch = torch
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.tracer = Tracer(trace, self.cuda)
        self.judge = Judge()
        self.clock = time.perf_counter
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
        self.t_open: Optional[float] = None
        self.memory_peak: Optional[int] = None
        self.family = importlib.import_module(
            f"h100bench.families.{cfg['family']}")

    def program_config(self):
        return self.family.program_config(self.cfg)

    def make_weights(self) -> Dict:
        from h100bench.weights import make_weights

        return make_weights(self.cfg, self.seed, self.device)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def open_window(self) -> float:
        import gc

        # Set-up's garbage is collected now and its survivors frozen, so
        # no collection of it falls into the window.
        gc.collect()
        gc.freeze()
        self.t_open = self.clock()
        return self.t_open

    def close_window(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
            self.memory_peak = self.torch.cuda.max_memory_allocated()

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


class Run:
    """What a per-layer metric's reader reads: the cell, its configuration
    and mix, the window's steps as the driver booked them, the requests
    finished in the window (submit, first and last token times on the
    host clock, tokens, prompt length), the window's seconds, the trace
    summary, the device's name, memory and peaks."""

    def __init__(self, ctx: Ctx, out: Dict, device: Dict):
        from h100bench.counts import Dims, peaks

        self.cell, self.cfg, self.mix = ctx.cell, ctx.cfg, ctx.mix
        self.dims = Dims(ctx.cfg)
        self.steps: List[Dict] = out["steps"]
        self.requests: List[Dict] = out.get("requests", [])
        self.window_s: float = out["window_s"]
        self.trace = ctx.tracer.summary
        self.device = device
        self.peaks = peaks(device["kind"]) if ctx.cuda else None
        self.chips = int(ctx.cell.get("chips", 1))

    @property
    def traced_steps(self) -> List[Dict]:
        return [s for s in self.steps if s["traced"]]


def device_info(ctx: Ctx, chips: int) -> Dict:
    torch = ctx.torch
    if not ctx.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    props = torch.cuda.get_device_properties(0)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(ctx.memory_peak or 0),
            "memory_total_bytes": int(props.total_memory)}


def execute(bench: Dict, cell: Dict, seed: int, seconds: float, trace: bool,
            device: str, cfg: Optional[Dict] = None,
            mix: Optional[Dict] = None) -> Dict:
    """Run the cell and return its result object (the JSON line). ``cfg``
    and ``mix`` replace the cell's files (the tests' small sizes)."""
    cfg = cfg or load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    ctx = Ctx(cell, cfg, mix, seed, seconds, trace, device)
    driver = importlib.import_module(f"h100bench.drivers.{mix['kind']}")
    out = driver.run(ctx)
    dev = device_info(ctx, int(cell.get("chips", 1)))
    run = Run(ctx, out, dev)
    setup_s = ctx.t_open - T_START
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {}
        for m in bench["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]) \
                    and m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    from h100bench.judge import verdict

    result = {"correct": verdict(cell["name"], out["checks"])
              and out["failed"] == 0,
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Every cache the program or its libraries may write stays inside the
    # checkout, at fixed paths, so only the first run there builds.
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process with one PyTorch CPU thread: the host only dispatches
    # the program's work, and the bounds were measured so.
    os.environ["OMP_NUM_THREADS"] = "1"
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_spec(bench, args.workload)

    import torch

    torch.set_num_threads(1)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine"
              f" has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda")
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {name} {c['value']!r} {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
