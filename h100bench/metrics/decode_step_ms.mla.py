"""Mean host-clock ms of the window's untraced decode-only steps:
``decode_step_ms.batch``'s reading in the MLA cell."""

from h100bench.run import metric_reader

LAYER = "engine (models/serving.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("decode_step_ms.batch").read(run)
