"""bare-except: no bare ``except:`` anywhere in the operator.
(Port of ``tpu_composer/analysis/passes/excepts.py``.)

The dispatch-loop lesson: ``Controller._dispatch_loop`` once caught a
mapper bug with a bare ``except:`` and silently killed the dispatch
thread — the queue looked healthy while nothing drained. A bare except
also swallows ``KeyboardInterrupt``/``SystemExit``, so a wedged worker
can't even be stopped cleanly. Catch the exception you mean
(``queue.Empty``, ``FabricError``, ...) or ``Exception`` with a loud
log; a handler that must really catch everything (none in-tree today)
says so with a suppression.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from tpu_composer_torch.analysis.core import LintFile, Pass, Violation


class BareExceptPass(Pass):
    id = "bare-except"
    invariant = (
        "no bare `except:` — dispatch/worker loops must catch the"
        " exception they mean and log bugs loudly instead of eating them"
        " (the dispatch-loop lesson)"
    )

    def check(self, file: LintFile) -> Iterable[Violation]:
        out: List[Violation] = []
        for node in ast.walk(file.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                out.append(
                    self.violation(
                        file,
                        node.lineno,
                        "bare `except:` — name the exception (or"
                        " `Exception` with a loud log); bare handlers eat"
                        " KeyboardInterrupt and hide worker-loop bugs",
                    )
                )
        return out
