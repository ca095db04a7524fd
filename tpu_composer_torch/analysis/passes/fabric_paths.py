"""fabric-mutation-path: controllers mutate the fabric only through
fence-checked paths.
(Port of ``tpu_composer/analysis/passes/fabric_paths.py``.)

The invariant (enforced end-to-end): a fabric mutation issued by a
controller must be covered by shard fencing — ownership can flip
mid-reconcile, and the write boundary is the last place the invariant
can hold. The legal paths are:

- the dispatcher (``self.dispatcher.<verb>`` — fenced at execute/settle
  via its ``owns=`` gate),
- the fence-checked slice facade (``self._slice_fabric(req).<verb>``),
- a raw provider call inside a function that called
  ``self._fence_check(...)`` lexically BEFORE it (the designated
  ``_fabric_add``/``_fabric_remove`` wrappers).

Anything else — a bare ``self.fabric.add_resource(...)`` or
``provider.remove_resources(...)`` from controller code — is exactly the
bypass this pass exists to stop: it would mutate the fabric after a
shard lease was stolen, and the new owner's adoption pass would fight a
ghost. The cold-start adoption module is the one designated exception
(it runs pre-controller-start, before any fence exists) and carries a
file-level suppression saying so.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from tpu_composer_torch.analysis.core import (
    LintFile,
    Pass,
    Violation,
    dotted_name,
)

#: Every mutating verb on the FabricProvider surface (fabric/provider.py).
#: get/check/poll verbs are read-only and uncovered on purpose.
MUTATION_VERBS = {
    "add_resource",
    "remove_resource",
    "add_resources",
    "remove_resources",
    "reserve_slice",
    "release_slice",
    "resize_slice",
    "repair_slice_member",
}

#: Receivers that are themselves the fence: the dispatcher gates at
#: execute/settle, ``_slice_fabric`` raises ShardFencedError inline.
_FENCED_RECEIVER_SUFFIXES = ("dispatcher",)
_FENCED_RECEIVER_CALLS = ("_slice_fabric",)


class FabricMutationPathPass(Pass):
    id = "fabric-mutation-path"
    invariant = (
        "controllers issue fabric mutations only via the dispatcher, the"
        " _slice_fabric facade, or after a _fence_check in the same"
        " function (shard fencing at the write boundary)"
    )

    def applies(self, file: LintFile) -> bool:
        return "controllers/" in file.rel.replace("\\", "/")

    def check(self, file: LintFile) -> Iterable[Violation]:
        if not self.applies(file):
            return []
        out: List[Violation] = []
        for func, calls, fence_lines in _scoped_mutation_calls(file.tree):
            for call, verb in calls:
                if _receiver_is_fenced(call):
                    continue
                if any(line < call.lineno for line in fence_lines):
                    continue
                out.append(
                    self.violation(
                        file,
                        call.lineno,
                        f"raw fabric mutation `{ast.unparse(call.func)}(...)`"
                        f" ({verb}) outside a fenced path — route through"
                        " the dispatcher/_slice_fabric or call"
                        " self._fence_check() first",
                    )
                )
        return out


def _scoped_mutation_calls(
    tree: ast.AST,
) -> List[Tuple[ast.AST, List[Tuple[ast.Call, str]], List[int]]]:
    """(scope, [(call, verb), ...], fence_lines) where scope is each
    call's INNERMOST enclosing function and fence_lines are the
    ``_fence_check`` calls attributed to that SAME scope. The scoping
    cuts both ways: a closure does not inherit an outer function's fence
    (the deferred body runs long after the check), and a fence inside a
    possibly-never-called closure must not cover the outer function's
    raw mutations. Module-level calls attach to the Module node."""
    mutations: List[Tuple[ast.AST, ast.Call]] = []
    fences: dict = {}

    def visit(node: ast.AST, scope: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_scope = child
            if isinstance(child, ast.Call) and isinstance(
                child.func, ast.Attribute
            ):
                if child.func.attr in MUTATION_VERBS:
                    mutations.append((scope, child))
                elif child.func.attr == "_fence_check":
                    fences.setdefault(id(scope), []).append(child.lineno)
            visit(child, child_scope)

    visit(tree, tree)
    by_scope: dict = {}
    for scope, call in mutations:
        by_scope.setdefault(id(scope), (scope, [], []))[1].append(
            (call, call.func.attr)
        )
    out = []
    for scope_id, (scope, calls, _) in by_scope.items():
        out.append((scope, calls, fences.get(scope_id, [])))
    return out


def _receiver_is_fenced(call: ast.Call) -> bool:
    recv = call.func.value  # the X in X.verb(...)
    name = dotted_name(recv)
    if name and name.split(".")[-1] in _FENCED_RECEIVER_SUFFIXES:
        return True
    if isinstance(recv, ast.Call):
        inner = dotted_name(recv.func)
        if inner and inner.split(".")[-1] in _FENCED_RECEIVER_CALLS:
            return True
    return False
