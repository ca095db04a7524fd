"""Share of the rows the window's expert products computed that carry a
routed (token, choice) pair: Σ ``real`` over Σ ``rows`` of the
``moe.experts`` spans of eager forwards (admissions) and of the
``serving.decode`` spans of replayed decode steps, which carry their
step's sums, over every step of the window; from the program's own spans
(``h100bench/spans.py``). The port computes every expert over every row
of a routing group, so at 2 of 8 experts a quarter of the rows are real
work."""

from h100bench.spans import trees

LAYER = "MoE layer (models/moe.py)"
UNIT = "%"
MOVES = "gen_tok_s"


def read(run):
    ts = trees(run.steps)
    if ts is None:
        return None
    args = [e["args"] for t in ts for e in t.spans()
            if e["name"] in ("moe.experts", "serving.decode")
            and "real" in e["args"]]
    rows = sum(a["rows"] for a in args)
    if not rows:
        return None
    return 100.0 * sum(a["real"] for a in args) / rows
