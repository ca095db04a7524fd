"""Mean host-clock ms of the window's untraced engine steps that carried
no admission (no submitted request waited for its first token when the
step began) and decoded at least one row."""

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    ms = [(s["t1"] - s["t0"]) * 1e3 for s in run.steps
          if not s["admit"] and s["rows"] and not s["traced"]]
    return sum(ms) / len(ms) if ms else None
