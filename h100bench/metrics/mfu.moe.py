"""The model's operations on real tokens in the window over the window's
seconds at the card's bf16 peak, as ``mfu.serve`` counts them, with each
token multiplying only its layer's attention, router and the two experts
it is routed to (``h100bench/moe_counts.py``): the rows the program
computes for experts a token did not choose are not counted."""

from h100bench.counts import decode_flops, prompt_flops
from h100bench.moe_counts import MoEDims

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    if run.peaks is None or not run.steps:
        return None
    d = MoEDims(run.cfg)
    flops = 0.0
    for s in run.steps:
        if s["rows"]:
            flops += s["rows"] * decode_flops(d, 0) + d.attn_pair_flops() * s["keys"]
        for n in s["prompts"]:
            flops += prompt_flops(d, n)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"] * run.chips)
