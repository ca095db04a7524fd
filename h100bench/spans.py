"""The program's own spans of its serving engine, paired with the
steps the benchmark booked.

While the program's tracing is on (its default; ``TPUC_TRACE=0`` turns
it off), the engine records one span tree per step in the program's
trace ring (``tpu_composer_torch/runtime/tracing.py``, category
``serving``): a ``serving.step`` root (args ``rows``, ``tokens`` and
``syncs``, the count of host syncs) over ``serving.admit`` (args
``prompt`` and ``padded``), ``serving.decode``, ``serving.emit`` and a
``serving.sync`` leaf for each host sync. The spans are stamped on
``perf_counter``, the benchmark's clock, and never enter the profiler.

:func:`trees` pairs each of the benchmark's booked steps (``t0``, ``t1``)
with the ``serving.step`` that began inside it. Where the program
records no such spans (a program without them, or recording off), or
the ring has dropped a step asked for, it gives None: a reader then
reports nothing rather than a mean over the steps that survived.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from tpu_composer_torch.runtime import tracing


def decode_only(run) -> List[Dict]:
    """The window's untraced steps that carried no admission and decoded
    rows: ``decode_step_ms.batch``'s selection."""
    return [s for s in run.steps
            if not s["admit"] and s["rows"] and not s["traced"]]


class Tree:
    """One step's ``serving.step`` event and the spans under it."""

    def __init__(self, root: Dict, kids: Dict[int, List[Dict]]):
        self.root = root
        self._kids = kids

    def children(self, e: Dict) -> List[Dict]:
        return self._kids.get(e["id"], [])

    def spans(self) -> List[Dict]:
        """Every span under the root."""
        out, todo = [], [self.root]
        while todo:
            for k in self.children(todo.pop()):
                out.append(k)
                todo.append(k)
        return out

    def named(self, name: str) -> List[Dict]:
        return [e for e in self.spans() if e["name"] == name]

    def self_ms(self, e: Dict) -> float:
        """``e``'s time outside its child spans (children never overlap)."""
        return (e["dur"] - sum(k["dur"] for k in self.children(e))) / 1e3


def trees(steps: List[Dict]) -> Optional[List[Tree]]:
    """The tree of each of ``steps``, or None where any has none."""
    events = tracing.snapshot(cat="serving")
    roots = sorted((e for e in events if e["name"] == "serving.step"),
                   key=lambda e: e["ts"])
    if not roots or not steps:
        return None
    starts = [tracing.perf_ns(e["ts"]) / 1e9 for e in roots]
    kids: Dict[int, List[Dict]] = defaultdict(list)
    for e in events:
        parent = e["args"].get("parent_span")
        if parent is not None:
            kids[parent].append(e)
    out = []
    for s in steps:
        i = bisect.bisect_left(starts, s["t0"])
        if i == len(starts) or starts[i] >= s["t1"]:
            return None
        out.append(Tree(roots[i], kids))
    return out


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
