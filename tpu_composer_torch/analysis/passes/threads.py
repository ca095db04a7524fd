"""named-threads: every thread carries a ``name=``.
(Port of ``tpu_composer/analysis/passes/threads.py``.)

The sampling profiler attributes samples per-thread KEYED ON THE THREAD
NAME: the always-on sampler buckets ``sys._current_frames()`` stacks by
named subsystem, and the wall-vs-CPU GIL estimate
(``tpuc_gil_wait_ratio{subsystem}``) only exists for threads it can
name. An anonymous ``Thread-12`` lands in the ``other`` bucket and the
hot-spot report loses exactly the thread you were hunting. Lock-order
witness reports (analysis/lockdep.py) cite thread names too.

Checked: every ``threading.Thread(...)`` construction must pass a
``name=`` keyword. (Manager runnables are named by the manager itself
via ``_runnable_name`` — those Thread calls already carry ``name=`` and
pass this check naturally.)
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from tpu_composer_torch.analysis.core import (
    LintFile,
    Pass,
    Violation,
    call_name,
)


class NamedThreadPass(Pass):
    id = "named-threads"
    invariant = (
        "every threading.Thread is constructed with name= — profiler"
        " attribution, GIL estimates and lockdep reports key on thread"
        " names"
    )

    def check(self, file: LintFile) -> Iterable[Violation]:
        out: List[Violation] = []
        for node in ast.walk(file.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name not in ("threading.Thread", "Thread"):
                continue
            if name == "Thread" and not _imports_thread(file.tree):
                continue
            if any(kw.arg == "name" for kw in node.keywords):
                continue
            out.append(
                self.violation(
                    file,
                    node.lineno,
                    "threading.Thread(...) without name= — anonymous"
                    " threads attribute to the profiler's 'other' bucket"
                    " and lockdep reports can't cite them",
                )
            )
        return out


def _imports_thread(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "threading":
            if any(a.name == "Thread" for a in node.names):
                return True
    return False
