"""Mean host bookkeeping per untraced decode-only step, with the card
idle: the self time of ``serving.step`` (masks, the token pick, lists)
plus that of ``serving.emit`` (emitting tokens, freeing slots), host
syncs left out; from the program's own spans (``h100bench/spans.py``).
With ``decode_dispatch_ms.batch`` and ``host_sync_ms.batch`` it sums to
the step's whole span."""

from h100bench.spans import decode_only, mean, trees

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    ts = trees(decode_only(run))
    if ts is None:
        return None
    return mean([t.self_ms(t.root)
                 + sum(t.self_ms(e) for e in t.named("serving.emit"))
                 for t in ts])
