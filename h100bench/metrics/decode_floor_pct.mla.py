"""The decode-only step's bytes floor over its host-clock time, over the
window's untraced decode-only steps (``decode_step_ms.batch``'s
selection): Σ floor / Σ time. A step's floor is every weight the model
holds (all 64 experts of every MoE layer, since at 128 rows each is
chosen by some row; the float32 routers and biases, the dense layer, the
tied head), its rows' live latent entries and each row's absorbed query
and latent output, all at the card's HBM bandwidth
(``h100bench/mla_counts.py``)."""

from h100bench.mla_counts import MLADims, decode_floor_bytes
from h100bench.spans import decode_only

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    steps = decode_only(run)
    if run.peaks is None or not steps:
        return None
    d = MLADims(run.cfg)
    floor_s = sum(decode_floor_bytes(d, s["rows"], s["keys"])
                  for s in steps) / run.peaks["hbm_bytes_s"]
    return 100.0 * floor_s / sum(s["t1"] - s["t0"] for s in steps)
