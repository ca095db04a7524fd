"""Share of the window's bucketed admissions whose forward was a replay
of one of the engine's CUDA graphs: the ``graph`` arg of each
``serving.admit`` span (1 a replay, 0 a forward run eagerly), from the
program's own spans (``h100bench/spans.py``). Where the spans carry no
such arg, the reader reports nothing."""

from h100bench.spans import trees

LAYER = "engine (models/serving.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    ts = trees([s for s in run.steps if s["admit"]])
    if ts is None:
        return None
    flags = [e["args"].get("graph") for t in ts
             for e in t.named("serving.admit")]
    if not flags or None in flags:
        return None
    return 100.0 * sum(flags) / len(flags)
