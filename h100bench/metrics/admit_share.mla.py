"""Share of the window's wall time spent in engine steps that carried an
admission: ``admit_share.serve``'s reading in the MLA cell."""

from h100bench.run import metric_reader

LAYER = "engine (models/serving.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("admit_share.serve").read(run)
