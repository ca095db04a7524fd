"""tpuc-lint pass framework: parsed-file model, suppressions, runner
(port of ``tpu_composer/analysis/core.py``).

Each pass is a small class with an ``id``, a one-line ``invariant`` (the
thing the repo already paid for — cited in every violation so the fix
commit can name it), and a ``check(file) -> [Violation]``. The
runner parses every in-scope source file ONCE into a :class:`LintFile`
(source + AST + per-line suppressions) and hands the same object to all
passes, so a full-tree run costs one parse per file.

Suppression syntax (documented in docs/OPERATIONS.md):

- line level: a trailing ``# tpuc: ignore[pass-id]`` comment silences
  that pass for violations anchored on that line (or the statement
  starting there). ``# tpuc: ignore[pass-a,pass-b]`` silences several.
- file level: ``# tpuc: ignore-file[pass-id]`` anywhere in the first 10
  lines opts the whole file out of one pass — for designated-exception
  modules (e.g. the cold-start adoption pass mutates fabric directly
  because it runs before any controller or shard fence exists).

Suppressions are deliberately per-pass (never bare ``# tpuc: ignore``):
an untargeted escape hatch rots into "ignore everything".
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

_SUPPRESS_RE = re.compile(r"#\s*tpuc:\s*ignore\[([a-z0-9_,\- ]+)\]")
_SUPPRESS_FILE_RE = re.compile(r"#\s*tpuc:\s*ignore-file\[([a-z0-9_,\- ]+)\]")
_FILE_SUPPRESS_WINDOW = 10  # ignore-file must sit in the first N lines


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach, anchored to a file:line."""

    pass_id: str
    path: str  # repo-relative
    line: int
    message: str
    invariant: str  # the one-line invariant the pass encodes

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


class LintFile:
    """One parsed source file shared by every pass."""

    def __init__(self, path: str, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError as e:  # surfaced as its own violation by run_passes
            self.parse_error = e
        self._line_suppress: Dict[int, Set[str]] = {}
        self._file_suppress: Set[str] = set()
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
                self._line_suppress.setdefault(i, set()).update(ids)
            if i <= _FILE_SUPPRESS_WINDOW:
                m = _SUPPRESS_FILE_RE.search(line)
                if m:
                    self._file_suppress.update(
                        p.strip() for p in m.group(1).split(",") if p.strip()
                    )

    def suppressed(self, pass_id: str, line: int) -> bool:
        if pass_id in self._file_suppress:
            return True
        return pass_id in self._line_suppress.get(line, set())


class Pass:
    """Base class: subclasses set ``id``/``invariant`` and implement
    ``check``. ``check`` yields raw findings; the runner applies
    suppressions, so passes never reason about them."""

    id: str = ""
    invariant: str = ""

    def check(self, file: LintFile) -> Iterable[Violation]:
        raise NotImplementedError

    # Helper so passes build violations without repeating their identity.
    def violation(self, file: LintFile, line: int, message: str) -> Violation:
        return Violation(
            pass_id=self.id,
            path=file.rel,
            line=line,
            message=message,
            invariant=self.invariant,
        )


def repo_root() -> str:
    """The repo checkout root: the directory holding the
    ``tpu_composer_torch`` package (needed because the doc-drift passes
    read docs/ and cmd/main.py relative to it)."""
    here = os.path.dirname(os.path.abspath(__file__))  # .../tpu_composer_torch/analysis
    return os.path.dirname(os.path.dirname(here))


_SKIP_DIRS = {"__pycache__"}


def discover_files(
    root: Optional[str] = None, paths: Optional[Sequence[str]] = None
) -> List[LintFile]:
    """Build :class:`LintFile` objects for the analysis scope.

    Default scope is every ``.py`` under ``tpu_composer_torch/`` plus
    ``chip_smoke.py`` (the port's run on the card) — tests/ is deliberately out
    (it holds the known-bad fixtures that must keep failing the passes).
    ``paths`` overrides the scope with explicit files/directories (the
    fixture tests use this).
    """
    root = root or repo_root()
    files: List[LintFile] = []
    if paths is None:
        targets: List[str] = [os.path.join(root, "tpu_composer_torch")]
        smoke = os.path.join(root, "chip_smoke.py")
        if os.path.exists(smoke):
            targets.append(smoke)
    else:
        targets = [
            p if os.path.isabs(p) else os.path.join(root, p) for p in paths
        ]
    seen: Set[str] = set()
    for target in targets:
        if os.path.isfile(target):
            _add_file(files, seen, target, root)
            continue
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    _add_file(files, seen, os.path.join(dirpath, fn), root)
    return files


def _add_file(files: List[LintFile], seen: Set[str], path: str, root: str) -> None:
    path = os.path.abspath(path)
    if path in seen:
        return
    seen.add(path)
    rel = os.path.relpath(path, root)
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    files.append(LintFile(path, rel, source))


def run_passes(
    passes: Sequence[Pass],
    root: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    files: Optional[Sequence[LintFile]] = None,
) -> List[Violation]:
    """Run ``passes`` over the scope; returns suppression-filtered
    violations sorted by (path, line, pass)."""
    if files is None:
        files = discover_files(root=root, paths=paths)
    out: List[Violation] = []
    for f in files:
        if f.parse_error is not None:
            out.append(
                Violation(
                    pass_id="parse",
                    path=f.rel,
                    line=f.parse_error.lineno or 1,
                    message=f"syntax error: {f.parse_error.msg}",
                    invariant="source files must parse",
                )
            )
            continue
        for p in passes:
            for v in p.check(f):
                if not f.suppressed(v.pass_id, v.line):
                    out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.pass_id))
    return out


# -- shared AST helpers used by several passes ---------------------------


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``a.b.c(...)`` -> ``"a.b.c"``;
    empty string when the receiver chain is not plain names/attributes
    (subscripts, calls, etc.)."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def functions(tree: ast.AST) -> List[ast.AST]:
    """Every function/method definition in the module, including nested."""
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def string_constants(tree: ast.AST) -> List[ast.Constant]:
    """Every string-literal Constant that is NOT a docstring/bare
    expression statement (so prose mentions never count as references)."""
    docstring_ids = set()
    for n in ast.walk(tree):
        body = getattr(n, "body", None)
        if isinstance(body, list):
            for stmt in body:
                if isinstance(stmt, ast.Expr) and isinstance(
                    stmt.value, ast.Constant
                ):
                    docstring_ids.add(id(stmt.value))
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, ast.Constant)
        and isinstance(n.value, str)
        and id(n) not in docstring_ids
    ]
