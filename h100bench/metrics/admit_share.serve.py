"""Share of the window's wall time spent in engine steps that carried an
admission (a bucketed prefill)."""

LAYER = "engine (models/serving.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    if not run.steps:
        return None
    busy = sum(s["t1"] - s["t0"] for s in run.steps if s["admit"])
    return 100.0 * busy / run.window_s
