"""Guards of the PyTorch port's boundaries.

- The port (every ``.py`` under ``tpu_composer_torch/``) and
  ``chip_smoke.py`` import nothing of JAX and nothing of the JAX package:
  no ``jax``, ``jaxlib``, ``ml_dtypes`` or ``tpu_composer`` import.
- The port calls no finished attention kernel and no compiler
  (``scaled_dot_product_attention``, ``torch.compile``); ``chip_smoke.py``
  may time SDPA as a yardstick, the package may not.
- The entry points that create tensors (serving and training) default
  to the card and raise when there is none, unless the caller passes
  ``device="cpu"``.
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


def test_backward_source_holds_both_kernels():
    src = (PORT / "csrc" / "flash_bwd.cu").read_text()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert f'extern "C" int {name}(' in src
    assert "Replaces the Pallas kernels" in src
    assert "atomicAdd" not in src  # one owner per output block


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _moe_config():
    from tpu_composer_torch.models.moe import MoEConfig

    return MoEConfig(vocab_size=16, d_model=16, n_layers=2, n_heads=2,
                     d_ff=16, max_seq=16, dtype=torch.float32, n_experts=2)


def test_entry_points_raise_without_a_card(no_card):
    from tpu_composer_torch.convert import params_from_jax
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.models.decode import init_kv_cache
    from tpu_composer_torch.models.paged import init_paged_cache
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    c = ModelConfig(vocab_size=16, d_model=16, n_layers=1, n_heads=2,
                    d_ff=16, max_seq=16, dtype=torch.float32)
    mc = _moe_config()
    calls = [
        lambda **kw: init_params(c, 0, **kw),
        lambda **kw: init_kv_cache(c, 1, **kw),
        lambda **kw: init_paged_cache(c, 1, 4, 4, **kw),
        lambda **kw: moe.init_params(mc, 0, **kw),
        lambda **kw: init_kv_cache(mc, 1, **kw),
        lambda **kw: init_paged_cache(mc, 1, 4, 4, **kw),
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


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    from tpu_composer_torch.convert import train_state_from_jax
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel import checkpoint
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
    )
    from tpu_composer_torch.workload.acceptance import qualify_slice
    from tpu_composer_torch.workload.trainer import fit

    tc = TrainConfig(model=ModelConfig(
        vocab_size=16, d_model=16, n_layers=1, n_heads=2, d_ff=16,
        max_seq=8, dtype=torch.float32))
    ds = PackedLMDataset([[1, 2, 3]] * 8, seq_len=8)
    cpu_state = make_train_state(tc, 0, device="cpu")
    checkpoint.save(str(tmp_path), cpu_state, step=1)
    zeros = {"embed": np.zeros((16, 16), np.float32), "layers": [],
             "ln_f": np.ones(16, np.float32)}
    jax_state = {"params": zeros, "opt": ((np.int32(0), zeros, zeros),)}
    calls = [
        lambda **kw: make_train_state(tc, 0, **kw),
        lambda **kw: fit(tc, ds, total_steps=1, global_batch=2, **kw),
        lambda **kw: qualify_slice(batch=1, seq=8, model_config=tc.model,
                                   steps=1, **kw),
        lambda **kw: train_state_from_jax(jax_state, tc, **kw),
        lambda **kw: ShardedLoader(ds, global_batch=2, **kw),
        lambda **kw: checkpoint.restore(str(tmp_path), tc, **kw),
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


def test_speculative_caches_follow_the_prompt_device(no_card):
    """The speculative functions take no device: their caches and output
    lie on the prompt's device, so CPU tensors run on the CPU without a
    card (and CUDA tensors would run on the card)."""
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.models.speculative import (
        paged_speculative_generate,
        speculative_generate,
    )

    mc = _moe_config()
    params = moe.init_params(mc, 0, device="cpu")
    prompt = torch.tensor([[1, 2, 3]])
    for out in (
        speculative_generate(params, params, prompt, mc, max_new_tokens=4,
                             gamma=2),
        paged_speculative_generate(params, params, prompt, mc, num_blocks=2,
                                   block_size=4, max_new_tokens=4, gamma=2),
    ):
        assert out.device.type == "cpu" and out.shape == (1, 4)


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
