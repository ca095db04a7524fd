"""The process's peak of allocated device memory over the card's memory:
``mem_peak_pct.serve``'s reading in the MLA cell."""

from h100bench.run import metric_reader

LAYER = "device"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("mem_peak_pct.serve").read(run)
