"""Invariant analyzer suite: tpuc-lint AST passes + the lockdep witness
(port of ``tpu_composer/analysis/``).

- ``tpuc-lint`` (``python -m tpu_composer_torch.analysis``): an
  AST-walking pass framework (core.py) with one pass per invariant
  (passes/), each proven by a known-bad fixture under
  ``tests/analysis_fixtures/``. Its default scope is this package plus
  ``chip_smoke.py``, and the tree passes it (tests/test_torch_analysis.py).
- ``lockdep`` (lockdep.py): a runtime lock-order witness fed by
  ``ObservedLock`` (runtime/contention.py). Per-thread held-lock stacks
  feed a global acquisition-order graph; a cycle is a potential ABBA
  deadlock and raises in strict mode. The port's operator twins run
  under it (``tests/torch_operator.py``).
"""

from tpu_composer_torch.analysis import lockdep  # noqa: F401
from tpu_composer_torch.analysis.core import (  # noqa: F401
    LintFile,
    Pass,
    Violation,
    run_passes,
)


def all_passes():
    """The registered pass list (imported lazily so ``lockdep`` users
    never pay for the AST machinery)."""
    from tpu_composer_torch.analysis.passes import PASSES

    return list(PASSES)
