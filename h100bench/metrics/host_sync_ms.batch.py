"""Mean summed ``serving.sync`` ms per untraced decode-only step: the
host blocked on the device stream (device-to-host reads, uploads of host
memory), from the program's own spans (``h100bench/spans.py``)."""

from h100bench.spans import decode_only, mean, trees

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    ts = trees(decode_only(run))
    if ts is None:
        return None
    return mean([sum(e["dur"] for e in t.named("serving.sync")) / 1e3
                 for t in ts])
