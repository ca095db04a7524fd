"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole: ``tpu_composer_torch`` is not ``tpu_composer``), and the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from h100bench.run import FORBIDDEN, ROOT, forbidden_modules

HERE = Path(__file__).resolve().parent.parent

RUN_SMALL = """
import json, sys
from h100bench import judge as J, run as R
from h100bench.tests.small import BENCH, EXACT, cell, config, mix
J.limits = lambda name: EXACT
R.execute(BENCH, cell(), 5, 0.3, True, "cpu", cfg=config(), mix=mix())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN_SMALL)
    assert "tpu_composer_torch" in names
    assert not names & set(FORBIDDEN)


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_composer_torch_x", sys)
    assert "tpu_composer" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_composer.api", sys)
    assert "tpu_composer" in forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "references").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("tpu_composer", "tpu_composer_torch",
                                               "jax"), (path.name, n)
    names = loaded("import json, sys\nimport h100bench.references.decoder_lm\n"
                   "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "tpu_composer_torch" not in names and not names & set(FORBIDDEN)
