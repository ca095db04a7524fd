"""tpuc-lint CLI: ``python -m tpu_composer_torch.analysis`` (port of
``tpu_composer/analysis/__main__.py``).

Exit status: 0 clean, 1 violations, 2 usage error. Default scope is the
whole ``tpu_composer_torch`` package plus ``chip_smoke.py``; ``--paths``
narrows to explicit files/dirs (the fixture tests use this). ``--json``
emits one object per violation for tooling; the human format is
``path:line: [pass-id] message`` with the invariant cited underneath.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from tpu_composer_torch.analysis import all_passes
from tpu_composer_torch.analysis.core import run_passes


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_composer_torch.analysis",
        description="tpuc-lint: repo-invariant AST passes",
    )
    parser.add_argument(
        "--list", action="store_true", help="list passes and exit"
    )
    parser.add_argument(
        "--pass",
        dest="only",
        action="append",
        metavar="PASS_ID",
        help="run only this pass (repeatable)",
    )
    parser.add_argument(
        "--paths",
        nargs="+",
        metavar="PATH",
        help="lint these files/dirs instead of the default scope",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)

    passes = all_passes()
    if args.list:
        for p in passes:
            print(f"{p.id}: {p.invariant}")
        return 0
    if args.only:
        known = {p.id for p in passes}
        unknown = [pid for pid in args.only if pid not in known]
        if unknown:
            print(
                f"unknown pass id(s): {', '.join(unknown)}"
                f" (known: {', '.join(sorted(known))})",
                file=sys.stderr,
            )
            return 2
        passes = [p for p in passes if p.id in args.only]

    violations = run_passes(passes, paths=args.paths)
    if args.json:
        for v in violations:
            print(
                json.dumps(
                    {
                        "pass": v.pass_id,
                        "path": v.path,
                        "line": v.line,
                        "message": v.message,
                        "invariant": v.invariant,
                    }
                )
            )
    else:
        for v in violations:
            print(v.format())
            print(f"    invariant: {v.invariant}")
        summary = (
            f"tpuc-lint: {len(violations)} violation(s) across"
            f" {len(passes)} pass(es)"
        )
        print(summary if violations else f"{summary} — clean")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
