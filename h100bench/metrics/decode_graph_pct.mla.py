"""Share of the window's decode steps replayed from the engine's CUDA
graph: ``decode_graph_pct.batch``'s reading in the MLA cell."""

from h100bench.run import metric_reader

LAYER = "model (models/transformer.py, decode.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    return metric_reader("decode_graph_pct.batch").read(run)
