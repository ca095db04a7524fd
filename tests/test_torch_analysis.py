"""The port's tpuc-lint (tpu_composer_torch/analysis/{core,__main__}.py and
passes/) held against the JAX package's (tests/test_analysis.py's lint
half; the lockdep half is tests/test_torch_lockdep.py).

Each pass runs on the shared known-bad and fixed fixtures under
``tests/analysis_fixtures/`` (read only) through both packages, and the
violations compare equal field by field: pass id, repo-relative path,
line and message (each pass's one-line invariant is the JAX package's
without its history citations). The suppression syntax and the CLI's
exit codes and ``--json`` go through both too. The port's own scope
(``tpu_composer_torch/`` plus ``chip_smoke.py``) must be clean, and its
workload layer is exempted from ``env-knob-drift`` by the port's prefix.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest

from tests.torch_operator import JAX_ROOT, PORT_ROOT, run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")

PASS_IDS = [
    "fabric-mutation-path",
    "intent-protocol",
    "wall-clock",
    "bare-except",
    "named-threads",
    "env-knob-drift",
    "metric-doc-drift",
]


def _analysis(root):
    return importlib.import_module(f"{root}.analysis")


def _lint(tw, pass_id, paths):
    """``pass_id`` of ``tw``'s package over ``paths``, as comparable
    tuples (pass id, path, line, message); each violation must cite its
    pass's invariant."""
    analysis = _analysis(tw.root)
    [lint_pass] = [p for p in analysis.all_passes() if p.id == pass_id]
    violations = analysis.run_passes([lint_pass], paths=paths)
    assert all(v.invariant == lint_pass.invariant for v in violations)
    return [(v.pass_id, v.path, v.line, v.message) for v in violations]


def _lint_both(pass_id, paths):
    jax_v, port_v = run_both(_lint, pass_id, paths)
    assert port_v == jax_v
    return port_v


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return os.path.dirname(path)


def test_registry_matches_the_jax_package():
    jax_p, port_p = (_analysis(root).all_passes()
                     for root in (JAX_ROOT, PORT_ROOT))
    assert [p.id for p in port_p] == [p.id for p in jax_p] == PASS_IDS
    for port, jax in zip(port_p, jax_p):
        assert port.invariant and type(port).__name__ == type(jax).__name__


# ---------------------------------------------------------------------------
# every pass against its fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pass_id", PASS_IDS)
def test_pass_fails_on_known_bad_fixture(pass_id):
    violations = _lint_both(pass_id, [os.path.join(FIXTURES, pass_id, "bad")])
    assert violations, f"{pass_id} did not flag its known-bad fixture"
    for pid, path, line, message in violations:
        assert pid == pass_id and line > 0 and message
        assert path.startswith(os.path.join("tests", "analysis_fixtures"))


@pytest.mark.parametrize("pass_id", PASS_IDS)
def test_pass_accepts_fixed_fixture(pass_id):
    good = os.path.join(FIXTURES, pass_id, "good")
    assert _lint_both(pass_id, [good]) == []


CASES = {
    # A _fence_check AFTER the mutation is not a fence.
    "late_fence": ("fabric-mutation-path", "controllers/late.py",
                   "class C:\n"
                   "    def bad(self, res):\n"
                   "        out = self.fabric.add_resource(res)\n"
                   "        self._fence_check(res)\n"
                   "        return out\n", 1),
    # A deferred inner body runs long after the outer fence checked.
    "closure": ("fabric-mutation-path", "controllers/closure.py",
                "class C:\n"
                "    def outer(self, res):\n"
                "        self._fence_check(res)\n"
                "        def later():\n"
                "            return self.fabric.add_resource(res)\n"
                "        return later\n", 1),
    # A fence inside a possibly-never-called inner def does not fence
    # the outer function's raw mutation.
    "inner_fence": ("fabric-mutation-path", "controllers/inner_fence.py",
                    "class C:\n"
                    "    def reconcile(self, res):\n"
                    "        def cb():\n"
                    "            self._fence_check(res)\n"
                    "        return self.fabric.add_resource(res)\n", 1),
    # TPUC_SLO is a prefix of documented knobs, not itself documented.
    "whole_identifier": ("env-knob-drift", "knob.py",
                         'import os\n_x = os.environ.get("TPUC_SLO", "")\n',
                         2),
    "late_intent": ("intent-protocol", "controllers/late.py",
                    "class C:\n"
                    "    def handle(self, res):\n"
                    '        res.status.state = "Attaching"\n'
                    "        self.store.update_status(res)\n"
                    "        res.status.pending_op = "
                    "self._new_intent('add', res)\n", 1),
    # Prose naming a knob is not a read site.
    "docstring": ("env-knob-drift", "doc.py",
                  '"""Mentions TPUC_FIXTURE_UNDOCUMENTED_KNOB in prose'
                  ' only."""\n', 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_edge_cases(tmp_path, case):
    pass_id, rel, source, expected = CASES[case]
    d = _write(str(tmp_path / rel), source)
    assert len(_lint_both(pass_id, [d])) == expected


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

SUPPRESSIONS = {
    "line": ("try:\n    pass\n"
             "except:  # tpuc: ignore[bare-except] — fixture exception\n"
             "    pass\n", 0),
    # Suppressing one pass never silences another on the same line.
    "per_pass": ("try:\n    pass\n"
                 "except:  # tpuc: ignore[named-threads]\n    pass\n", 1),
    "file": ("# tpuc: ignore-file[bare-except] — whole-module exception\n"
             "try:\n    pass\nexcept:\n    pass\n", 0),
    "file_not_near_the_top": (
        "\n".join(["x = %d" % i for i in range(12)]
                  + ["# tpuc: ignore-file[bare-except]",
                     "try:", "    pass", "except:", "    pass"]) + "\n", 1),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSIONS))
def test_suppressions(tmp_path, case):
    source, expected = SUPPRESSIONS[case]
    d = _write(str(tmp_path / "a.py"), source)
    assert len(_lint_both("bare-except", [d])) == expected


# ---------------------------------------------------------------------------
# the port's tree is clean under its own lint
# ---------------------------------------------------------------------------


def test_default_scope_is_the_port_and_its_smoke_script():
    from tpu_composer_torch.analysis.core import discover_files, repo_root

    assert os.path.samefile(repo_root(), REPO)
    rels = {f.rel for f in discover_files()}
    assert "chip_smoke.py" in rels
    assert os.path.join("tpu_composer_torch", "analysis", "core.py") in rels
    assert all(r == "chip_smoke.py" or r.startswith("tpu_composer_torch" + os.sep)
               for r in rels)


def test_default_scope_is_clean():
    """The port's tree satisfies every pass, as the JAX tree satisfies
    its own (the adoption module carries the JAX copy's file-level
    fabric-mutation-path exemption and its reason)."""
    from tpu_composer_torch.analysis import all_passes, run_passes

    violations = run_passes(all_passes())
    assert violations == [], "\n".join(v.format() for v in violations)
    with open(os.path.join(REPO, "tpu_composer_torch", "controllers",
                           "adoption.py")) as f:
        port_head = f.read().splitlines()[:5]
    with open(os.path.join(REPO, "tpu_composer", "controllers",
                           "adoption.py")) as f:
        jax_head = f.read().splitlines()[:5]
    assert port_head == jax_head
    assert port_head[0].startswith("# tpuc: ignore-file[fabric-mutation-path]")


KNOB_READER = 'import os\n_x = os.environ.get("TPUC_FIXTURE_WORKLOAD_KNOB")\n'


@pytest.mark.parametrize("layer,flagged", [
    ("workload", False), ("ops", False), ("models", False),
    ("parallel", False), ("data", False), ("runtime", True)])
def test_the_ports_workload_layer_is_exempt_by_its_prefix(tmp_path, layer,
                                                          flagged):
    """A workload-layer file under ``tpu_composer_torch/<layer>/`` reads
    its own env contract: the port's env-knob-drift leaves it alone, and
    flags the same read in a control-plane layer (wired nowhere,
    documented nowhere: two findings)."""
    d = _write(str(tmp_path / PORT_ROOT / layer / "probe_like.py"),
               KNOB_READER)
    from tpu_composer_torch.analysis import all_passes, run_passes

    port = run_passes([p for p in all_passes() if p.id == "env-knob-drift"],
                      paths=[d])
    assert len(port) == (2 if flagged else 0)


def test_the_jax_prefix_flags_only_the_ports_workload_knobs():
    """The JAX package's lint over the port's tree: its workload prefix
    (``tpu_composer/<layer>/``) never matches the port's paths, so what it
    finds there is env-knob-drift in the port's workload layer and
    nothing else — exactly what the port's prefix exempts."""
    from tpu_composer.analysis import all_passes, run_passes

    found = run_passes(all_passes(), paths=["tpu_composer_torch",
                                            "chip_smoke.py"])
    workload = tuple(os.path.join("tpu_composer_torch", d, "")
                     for d in ("workload", "ops", "models", "parallel", "data"))
    assert found, "the JAX prefix no longer differs from the port's"
    assert all(v.pass_id == "env-knob-drift" and v.path.startswith(workload)
               for v in found), [v.format() for v in found]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(tw, argv, capsys):
    """The CLI's exit code and output, the invariants left out (the
    human format's ``invariant:`` lines, ``--json``'s key, ``--list``'s
    text after the id)."""
    main = importlib.import_module(f"{tw.root}.analysis.__main__").main
    rc = main(argv)
    lines = []
    for ln in capsys.readouterr().out.splitlines():
        if "--json" in argv:
            doc = json.loads(ln)
            assert doc.pop("invariant")
            lines.append(doc)
        elif "--list" in argv:
            lines.append(ln.split(": ", 1)[0])
        elif not ln.startswith("    invariant: "):
            lines.append(ln)
    return rc, lines


@pytest.mark.parametrize("argv,rc", [
    (["--list"], 0),
    (["--pass", "bare-except", "--paths",
      os.path.join(FIXTURES, "bare-except", "bad")], 1),
    (["--pass", "bare-except", "--paths",
      os.path.join(FIXTURES, "bare-except", "good")], 0),
    (["--pass", "named-threads", "--paths",
      os.path.join(FIXTURES, "named-threads", "bad"), "--json"], 1),
], ids=["list", "bad", "good", "json"])
def test_cli_exit_codes_and_output(capsys, argv, rc):
    jax_out, port_out = run_both(_cli, argv, capsys)
    assert port_out == jax_out
    assert port_out[0] == rc
    if "--list" in argv:
        assert port_out[1] == PASS_IDS
    if "--json" in argv:
        docs = port_out[1]
        assert docs and all(d["pass"] == "named-threads" for d in docs)
        assert all({"path", "line", "message"} <= set(d) for d in docs)


def test_unknown_pass_exits_two(capsys):
    from tpu_composer_torch.analysis.__main__ import main

    assert main(["--pass", "no-such-pass"]) == 2
    assert "unknown pass id(s): no-such-pass" in capsys.readouterr().err


def test_module_entry_point_is_clean_on_the_repo(tmp_path):
    """``python -m tpu_composer_torch.analysis`` from another directory
    lints the port's default scope and exits 0."""
    res = subprocess.run(
        [sys.executable, "-m", "tpu_composer_torch.analysis"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == (
        f"tpuc-lint: 0 violation(s) across {len(PASS_IDS)} pass(es) — clean")
