"""Share of the traced window in which nothing ran on the device:
``device_idle.serve``'s reading in the MLA cell."""

from h100bench.run import metric_reader

LAYER = "device"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("device_idle.serve").read(run)
