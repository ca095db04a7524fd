"""Mean ms, over the window's untraced steps that carried an admission,
of the ``moe.*`` spans inside the step's ``serving.admit``: the host's
issue of every MoE layer's route, dispatch, expert products and combine
in a bucketed prefill, from the program's own spans
(``h100bench/spans.py``)."""

from h100bench.spans import mean, trees

LAYER = "MoE layer (models/moe.py)"
UNIT = "ms"
MOVES = "gen_tok_s"


def _moe_ms(tree, admit) -> float:
    total, todo = 0.0, [admit]
    while todo:
        for k in tree.children(todo.pop()):
            if k["name"].startswith("moe."):
                total += k["dur"] / 1e3
            todo.append(k)
    return total


def read(run):
    ts = trees([s for s in run.steps if s["admit"] and not s["traced"]])
    if ts is None:
        return None
    return mean([sum(_moe_ms(t, a) for a in t.named("serving.admit"))
                 for t in ts if t.named("serving.admit")])
