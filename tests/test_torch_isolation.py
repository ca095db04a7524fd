"""Guards of the PyTorch port's boundaries.

- The port (every ``.py`` under ``tpu_composer_torch/``) and
  ``chip_smoke.py`` import nothing of JAX and nothing of the JAX package:
  no ``jax``, ``jaxlib``, ``ml_dtypes`` or ``tpu_composer`` import.
- The port calls no finished attention kernel and no compiler
  (``scaled_dot_product_attention``, ``torch.compile``); ``chip_smoke.py``
  may time SDPA as a yardstick, the package may not.
- The entry points that create tensors default to the card and raise
  when there is none, unless the caller passes ``device="cpu"``.
- ``chip_smoke.py`` fails without a card, and alone in an empty
  directory.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpu_composer_torch"
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "ml_dtypes", "tpu_composer")
FORBIDDEN_CALLS = ("torch.compile", "F.scaled_dot_product_attention")

torch.set_num_threads(1)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_imports_nothing_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in FORBIDDEN_IMPORTS]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_package_calls_no_finished_attention_or_compiler():
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Attribute):
                continue
            name = f"{ast.unparse(node.value)}.{node.attr}"
            assert name not in FORBIDDEN_CALLS and not name.endswith(
                ".scaled_dot_product_attention"), (
                f"{path.name}:{node.lineno} uses {name}")


def test_cuda_sources_sit_beside_their_wrappers():
    for name in ("flash_fwd", "paged_decode"):
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert f'extern "C" int {name}(' in src
        assert "Replaces the Pallas kernels" in src


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from tpu_composer_torch.convert import params_from_jax
    from tpu_composer_torch.models.decode import init_kv_cache
    from tpu_composer_torch.models.paged import init_paged_cache
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    c = ModelConfig(vocab_size=16, d_model=16, n_layers=1, n_heads=2,
                    d_ff=16, max_seq=16, dtype=torch.float32)
    calls = [
        lambda **kw: init_params(c, 0, **kw),
        lambda **kw: init_kv_cache(c, 1, **kw),
        lambda **kw: init_paged_cache(c, 1, 4, 4, **kw),
        lambda **kw: params_from_jax(
            {"embed": np.zeros((16, 16), np.float32), "layers": [],
             "ln_f": np.ones(16, np.float32)}, c, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()  # the default is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device="cuda")
        call(device="cpu")  # the CPU only when asked for


def test_engine_follows_its_params_device(no_card):
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    c = ModelConfig(vocab_size=16, d_model=16, n_layers=1, n_heads=2,
                    d_ff=16, max_seq=16, dtype=torch.float32)
    eng = ContinuousBatchingEngine(init_params(c, 0, device="cpu"), c,
                                   slots=1, num_blocks=4, block_size=4)
    req = eng.submit([1, 2], 3)
    eng.run()
    assert len(req.tokens) == 3 and eng.cache.k_pool.device.type == "cpu"


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path, lone)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
