"""Share of the positions the window's admissions ran that were padding:
the sum of ``padded`` − ``prompt`` over the sum of ``padded``, over the
``serving.admit`` spans of every step of the window that carried an
admission (``h100bench/spans.py``)."""

from h100bench.spans import trees

LAYER = "engine (models/serving.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    ts = trees([s for s in run.steps if s["admit"]])
    if ts is None:
        return None
    admits = [e["args"] for t in ts for e in t.named("serving.admit")]
    padded = sum(a["padded"] for a in admits)
    if not padded:
        return None
    return 100.0 * sum(a["padded"] - a["prompt"] for a in admits) / padded
