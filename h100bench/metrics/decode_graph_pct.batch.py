"""Share of the window's decode steps whose decode forward was a replay
of the engine's CUDA graph: the ``graph`` arg of each step's
``serving.decode`` span (1 a replay, 0 a forward run eagerly), from the
program's own spans (``h100bench/spans.py``). Where the spans carry no
such arg, the reader reports nothing."""

from h100bench.spans import trees

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    ts = trees([s for s in run.steps if s["rows"]])
    if ts is None:
        return None
    flags = [e["args"].get("graph") for t in ts
             for e in t.named("serving.decode")]
    if not flags or None in flags:
        return None
    return 100.0 * sum(flags) / len(flags)
