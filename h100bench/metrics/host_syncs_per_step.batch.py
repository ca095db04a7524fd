"""Mean count of host syncs (the ``syncs`` of ``serving.step``) per
untraced decode-only step, from the program's own spans
(``h100bench/spans.py``)."""

from h100bench.spans import decode_only, mean, trees

LAYER = "engine (models/serving.py)"
UNIT = "count"
MOVES = "gen_tok_s"


def read(run):
    ts = trees(decode_only(run))
    if ts is None:
        return None
    return mean([t.root["args"]["syncs"] for t in ts])
