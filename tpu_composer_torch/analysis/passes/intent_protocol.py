"""intent-protocol: Attaching/Detaching transitions carry a pending_op.
(Port of ``tpu_composer/analysis/passes/intent_protocol.py``.)

The crash-consistency protocol: the status write that makes an
``Attaching``/``Detaching`` transition durably visible must carry the
fabric-op intent (``status.pending_op``) in the SAME write — the
transition is strictly ordered before any fabric call, so a crash
anywhere past it leaves a record the cold-start adoption pass can
classify against ``fabric.get_resources()``. A transition written
WITHOUT the intent re-opens the crash window the adoption pass closed:
an attach could complete on the fabric with no durable trace, and the
restarted operator would double-attach.

AST shape checked: in controller code, an assignment of
``<obj>.status.state`` to ``RESOURCE_STATE_ATTACHING`` /
``RESOURCE_STATE_DETACHING`` (or the bare ``"Attaching"``/
``"Detaching"`` strings, including inside conditional expressions) must
be followed — in the same function, before the next ``update_status``
call — by an assignment to the same object's ``status.pending_op``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from tpu_composer_torch.analysis.core import (
    LintFile,
    Pass,
    Violation,
    dotted_name,
)

_STATE_NAMES = {"RESOURCE_STATE_ATTACHING", "RESOURCE_STATE_DETACHING"}
_STATE_STRINGS = {"Attaching", "Detaching"}


class IntentProtocolPass(Pass):
    id = "intent-protocol"
    invariant = (
        "an Attaching/Detaching status.state transition must assign"
        " status.pending_op before the update_status that persists it"
        " (durable fabric-op intent rides the same write)"
    )

    def applies(self, file: LintFile) -> bool:
        return "controllers/" in file.rel.replace("\\", "/")

    def check(self, file: LintFile) -> Iterable[Violation]:
        if not self.applies(file):
            return []
        out: List[Violation] = []
        for func in ast.walk(file.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            transitions = []  # (line, object prefix e.g. "res")
            pending_lines = {}  # object prefix -> [lines]
            update_lines = []
            for node in ast.walk(func):
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        name = dotted_name(target)
                        if name.endswith(".status.state") and _is_transition(
                            node.value
                        ):
                            transitions.append(
                                (node.lineno, name[: -len(".status.state")])
                            )
                        if name.endswith(".status.pending_op"):
                            pending_lines.setdefault(
                                name[: -len(".status.pending_op")], []
                            ).append(node.lineno)
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update_status"
                ):
                    update_lines.append(node.lineno)
            for line, obj in transitions:
                next_write = _next_after(update_lines, line)
                window_end = next_write if next_write is not None else 10**9
                covered = any(
                    line <= pl <= window_end
                    for pl in pending_lines.get(obj, [])
                )
                if not covered:
                    out.append(
                        self.violation(
                            file,
                            line,
                            f"`{obj}.status.state` transitions to"
                            " Attaching/Detaching without assigning"
                            f" `{obj}.status.pending_op` before the next"
                            " update_status — the durable intent must ride"
                            " the same status write",
                        )
                    )
        return out


def _is_transition(value: ast.AST) -> bool:
    """True when the assigned value can evaluate to Attaching/Detaching:
    a direct constant/name, or any such leaf inside a conditional
    expression / boolean operation."""
    for node in ast.walk(value):
        if isinstance(node, ast.Name) and node.id in _STATE_NAMES:
            return True
        if isinstance(node, ast.Constant) and node.value in _STATE_STRINGS:
            return True
    return False


def _next_after(lines: List[int], after: int) -> Optional[int]:
    following = [ln for ln in lines if ln >= after]
    return min(following) if following else None
