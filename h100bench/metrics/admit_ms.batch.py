"""Mean ``serving.admit`` ms (a bucketed prefill up to the first token)
over the untraced steps that carried one, from the program's own spans
(``h100bench/spans.py``)."""

from h100bench.spans import mean, trees

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    ts = trees([s for s in run.steps if s["admit"] and not s["traced"]])
    if ts is None:
        return None
    return mean([sum(e["dur"] for e in admits) / 1e3
                 for admits in (t.named("serving.admit") for t in ts)
                 if admits])
