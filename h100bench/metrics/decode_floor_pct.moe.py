"""The decode-only step's bytes floor over its host-clock time, over the
window's untraced decode-only steps (``decode_step_ms.batch``'s
selection): Σ floor / Σ time. A step's floor is every weight the model
holds (at 128 rows every expert of every layer is chosen), its rows'
live K and V, q and output, all at the card's HBM bandwidth
(``h100bench/moe_counts.py``)."""

from h100bench.moe_counts import MoEDims, decode_floor_bytes
from h100bench.spans import decode_only

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    steps = decode_only(run)
    if run.peaks is None or not steps:
        return None
    d = MoEDims(run.cfg)
    floor_s = sum(decode_floor_bytes(d, s["rows"], s["keys"])
                  for s in steps) / run.peaks["hbm_bytes_s"]
    return 100.0 * floor_s / sum(s["t1"] - s["t0"] for s in steps)
