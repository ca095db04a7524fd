"""The model's operations on real tokens in the window over the window's
seconds at the card's bf16 peak, from the configuration alone
(``h100bench/mla_counts.py``): per token 2 × the matmul parameters it
multiplies (W_q, W_kva, W_kvb, W_o, then the router, the 6 chosen and the
shared experts, or the leading dense layer's FFN, and the tied head), and
per (query, key) pair 2·H·(192 + 128) a layer, the non-absorbed MLA's
count whichever form runs. Padding, the rows of experts a token did not
choose and idle slots are not counted."""

from h100bench.mla_counts import MLADims, prompt_flops

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    if run.peaks is None or not run.steps:
        return None
    d = MLADims(run.cfg)
    flops = 0.0
    for s in run.steps:
        if s["rows"]:
            flops += 2.0 * d.token_params() * s["rows"] + d.pair_flops() * s["keys"]
        for n in s["prompts"]:
            flops += prompt_flops(d, n)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"] * run.chips)
