"""wall-clock: lease/expiry/steal logic never reads the wall clock.
(Port of ``tpu_composer/analysis/passes/wallclock.py``.)

The observation-clock discipline: a contender steals a lease only
after the (holder, renewTime) pair sat unchanged for a full lease
duration on the contender's OWN monotonic clock — ``time.time()`` in
that logic is silently wrong (an NTP step or a VM pause can hasten a
steal, deposing a healthy leader, or block one forever). ``leases.py``
is the single module allowed to touch wall time (it renders the durable
renewTime stamps other replicas OBSERVE but never subtract).

Scope: the lease-discipline modules (runtime/shards.py,
runtime/leader.py, runtime/fleet.py — fleet staleness ages replicas out
by the same RenewObservation rule). Banned: ``time.time()``,
``datetime.now()``/``utcnow()``/``today()``. ``time.monotonic()`` /
``time.perf_counter()`` are the correct clocks and stay legal.
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

#: Modules holding steal/expiry/staleness logic. leases.py itself is the
#: deliberate exception: it OWNS the wall-clock boundary (rendering
#: renewTime stamps) and documents why.
_SCOPED = (
    "runtime/shards.py",
    "runtime/leader.py",
    "runtime/fleet.py",
)

_BANNED = {
    "time.time": "time.time()",
    "datetime.now": "datetime.now()",
    "datetime.utcnow": "datetime.utcnow()",
    "datetime.datetime.now": "datetime.now()",
    "datetime.datetime.utcnow": "datetime.utcnow()",
    "datetime.today": "datetime.today()",
}


class WallClockPass(Pass):
    id = "wall-clock"
    invariant = (
        "lease/expiry/steal logic outside leases.py uses only monotonic"
        " clocks — wall time can neither hasten nor block a failover"
        " (observation-clock discipline)"
    )

    def applies(self, file: LintFile) -> bool:
        rel = file.rel.replace("\\", "/")
        return any(rel.endswith(s) for s in _SCOPED)

    def check(self, file: LintFile) -> Iterable[Violation]:
        if not self.applies(file):
            return []
        out: List[Violation] = []
        for node in ast.walk(file.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            banned = _BANNED.get(name)
            if banned:
                out.append(
                    self.violation(
                        file,
                        node.lineno,
                        f"wall-clock read `{banned}` in lease-discipline"
                        " code — use time.monotonic() (steal/expiry"
                        " decisions) or route durable stamps through"
                        " leases.py",
                    )
                )
        return out
