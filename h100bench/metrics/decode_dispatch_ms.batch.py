"""Mean self time of ``serving.decode`` (its host syncs left out) over
the untraced decode-only steps (``decode_step_ms.batch``'s selection):
the host issuing the decode forward of every layer, from the program's
own spans (``h100bench/spans.py``)."""

from h100bench.spans import decode_only, mean, trees

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    ts = trees(decode_only(run))
    if ts is None:
        return None
    return mean([sum(t.self_ms(e) for e in t.named("serving.decode"))
                 for t in ts])
