"""Small sizes of the benchmark's cells for CPU tests: the published
configuration and mix with their widths, depths and loads cut down."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
# Limits for float32 runs at these sizes, where the program and the
# reference agree to rounding.
EXACT = {"max_gap": 1e-3}
SMALL = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, num_hidden_layers=2, vocab_size=256)


def config(name: str = "mistral-7b", dtype: str = "float32",
           std: float = 0.5) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(SMALL, torch_dtype=dtype, initializer_range=std)
    return cfg


def mix(name: str = "batch") -> dict:
    m = json.loads((HERE / "mixes" / f"{name}.json").read_text())
    m.update(stratum=8, check_tokens=64, clients=4)
    m["engine"].update(slots=4, blocks_per_slot=12)
    m["prompt"] = {"dist": "lognormal", "median": 24, "sigma": 0.6,
                   "min": 8, "max": 64}
    m["output"] = {"dist": "uniform", "min": 4, "max": 16}
    return m


def cell(name: str = "mistral-7b.batch") -> dict:
    for c in BENCH["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(name)
