"""The 90th percentile of time per output token, (last token − first
token) / (tokens − 1) on the host clock, over the requests that finished
in the window before its traced part began, so that the profiler's cost
is in none of them."""

import numpy as np

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    t_trace = min((s["t0"] for s in run.steps if s["traced"]),
                  default=float("inf"))
    per = [(r["last"] - r["first"]) / (r["tokens"] - 1) for r in run.requests
           if r["tokens"] > 1 and r["last"] < t_trace]
    return 1e3 * float(np.percentile(per, 90)) if per else None
