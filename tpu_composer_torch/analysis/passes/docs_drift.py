"""Doc-drift gates: env knobs and metric series vs OPERATIONS.md.
(Port of ``tpu_composer/analysis/passes/docs_drift.py``.)

Same shape as the existing CRD-drift gate (`make validate-manifests`):
the artifact a human consumes (here docs/OPERATIONS.md, there the
generated CRD YAML) must never silently lag the source of truth.

- ``env-knob-drift``: every ``TPUC_*`` knob the CONTROL PLANE reads must
  be (a) wired in cmd/main.py — a knob only an internal module knows
  about is an undiscoverable production switch — and (b) documented in
  the OPERATIONS.md knob tables. The workload layer (workload/, ops/,
  models/, parallel/, data/ — the standalone probe/AOT harness with its
  own env contract) is out of scope by design.
- ``metric-doc-drift``: every ``tpuc_*`` series registered against the
  metrics registry must appear in OPERATIONS.md, so the runbooks' metric
  tables can be trusted to enumerate what a live operator exposes.

A wildcard mention like ``TPUC_CHAOS_STORE_*`` in OPERATIONS.md covers
every knob sharing the prefix (the chaos-store table documents the
family in one row).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional

from tpu_composer_torch.analysis.core import (
    LintFile,
    Pass,
    Violation,
    repo_root,
    string_constants,
)

_KNOB_RE = re.compile(r"^TPUC_[A-Z0-9]+(?:_[A-Z0-9]+)*$")
_METRIC_RE = re.compile(r"^tpuc_[a-z0-9_]+$")
_WILDCARD_RE = re.compile(r"(TPUC_[A-Z0-9_]+_)\*")

#: The workload layer reads its own env contract (probe stage budgets,
#: AOT interpret overrides) and never runs inside the operator process.
#: Matched under ``tpu_composer_torch/``, the port's own prefix.
_WORKLOAD_DIRS = ("workload/", "ops/", "models/", "parallel/", "data/")

_REGISTRAR_NAMES = {"counter", "gauge", "histogram"}


def _word_mentioned(name: str, doc: str) -> bool:
    """Whole-identifier match: a name that is merely a PREFIX of a longer
    documented identifier (TPUC_SLO vs TPUC_SLO_FAST_WINDOW, tpuc_slo_burn
    vs tpuc_slo_burn_rate) must NOT count as documented — substring
    containment would let the drift gate pass on an undocumented knob."""
    return (
        re.search(
            r"(?<![A-Za-z0-9_])" + re.escape(name) + r"(?![A-Za-z0-9_])", doc
        )
        is not None
    )


class _DocTargets:
    """Lazily-read wiring/doc targets, cached per pass instance so a
    full-tree run reads cmd/main.py and OPERATIONS.md once."""

    def __init__(self) -> None:
        self._main: Optional[str] = None
        self._ops: Optional[str] = None
        self._wildcards: Optional[List[str]] = None

    def main_src(self) -> str:
        if self._main is None:
            self._main = self._read(
                os.path.join("tpu_composer_torch", "cmd", "main.py")
            )
        return self._main

    def ops_doc(self) -> str:
        if self._ops is None:
            self._ops = self._read(os.path.join("docs", "OPERATIONS.md"))
            self._wildcards = _WILDCARD_RE.findall(self._ops)
        return self._ops

    def documented(self, knob: str) -> bool:
        doc = self.ops_doc()
        if _word_mentioned(knob, doc):
            return True
        return any(knob.startswith(pref) for pref in self._wildcards or [])

    def metric_documented(self, name: str) -> bool:
        return _word_mentioned(name, self.ops_doc())

    @staticmethod
    def _read(rel: str) -> str:
        path = os.path.join(repo_root(), rel)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return f.read()
        except OSError:
            return ""


class EnvKnobDriftPass(Pass):
    id = "env-knob-drift"
    invariant = (
        "every control-plane TPUC_* env knob is wired in cmd/main.py AND"
        " documented in docs/OPERATIONS.md (doc-drift gate)"
    )

    def __init__(self) -> None:
        self._targets = _DocTargets()

    def applies(self, file: LintFile) -> bool:
        rel = file.rel.replace("\\", "/")
        return not any(
            f"tpu_composer_torch/{d}" in rel for d in _WORKLOAD_DIRS
        )

    def check(self, file: LintFile) -> Iterable[Violation]:
        if not self.applies(file):
            return []
        out: List[Violation] = []
        seen: Dict[str, int] = {}
        for const in string_constants(file.tree):
            value = const.value
            if _KNOB_RE.match(value) and value not in seen:
                seen[value] = const.lineno
        is_main = file.rel.replace("\\", "/").endswith("cmd/main.py")
        for knob, line in sorted(seen.items(), key=lambda kv: kv[1]):
            if not is_main and not _word_mentioned(
                knob, self._targets.main_src()
            ):
                out.append(
                    self.violation(
                        file,
                        line,
                        f"env knob {knob} is read here but never wired in"
                        " cmd/main.py — production switches must be"
                        " discoverable from the entrypoint",
                    )
                )
            if not self._targets.documented(knob):
                out.append(
                    self.violation(
                        file,
                        line,
                        f"env knob {knob} is not documented in"
                        " docs/OPERATIONS.md — add it to the knob table"
                        " (or cover it with a TPUC_FOO_* wildcard row)",
                    )
                )
        return out


class MetricDocDriftPass(Pass):
    id = "metric-doc-drift"
    invariant = (
        "every registered tpuc_* metric series appears in"
        " docs/OPERATIONS.md (doc-drift gate)"
    )

    def __init__(self) -> None:
        self._targets = _DocTargets()

    def check(self, file: LintFile) -> Iterable[Violation]:
        out: List[Violation] = []
        for node in ast.walk(file.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else ""
            )
            if attr.lower() not in _REGISTRAR_NAMES:
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (
                isinstance(first, ast.Constant) and isinstance(first.value, str)
            ):
                continue
            name = first.value
            if not _METRIC_RE.match(name):
                continue
            if not self._targets.metric_documented(name):
                out.append(
                    self.violation(
                        file,
                        first.lineno,
                        f"metric series {name} is registered here but"
                        " absent from docs/OPERATIONS.md — the runbook"
                        " metric tables must enumerate every live series",
                    )
                )
        return out
