"""K2's share of its roofline over the traced steps, from the same byte
count (``counts.decode_attention_bytes``): ``k2_roofline.serve``'s
reading in the MoE cell, whose attention has the dense cell's shapes."""

from h100bench.run import metric_reader

LAYER = "attention kernels (ops/, csrc/)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("k2_roofline.serve").read(run)
