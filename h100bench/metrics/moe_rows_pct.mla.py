"""Share of the rows the window's expert products computed that carry a
routed (token, choice) pair: ``moe_rows_pct.moe``'s reading in the MLA
cell, 6 of 64 experts."""

from h100bench.run import metric_reader

LAYER = "MoE layer (models/moe.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("moe_rows_pct.moe").read(run)
