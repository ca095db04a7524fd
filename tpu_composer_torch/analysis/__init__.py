"""The lock-order witness (port of ``tpu_composer/analysis/``, its
``lockdep`` module only).

``lockdep`` (lockdep.py) is a runtime lock-order witness fed by
``ObservedLock`` (runtime/contention.py). Per-thread held-lock stacks
feed a global acquisition-order graph; a cycle is a potential ABBA
deadlock and raises in strict mode. The port's operator twins run under
it (``tests/torch_operator.py``).
"""

from tpu_composer_torch.analysis import lockdep  # noqa: F401
