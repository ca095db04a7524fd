"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the same params and inputs go through the JAX package and the PyTorch
port, as numpy arrays in between."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_composer.models.moe import MoEConfig as JaxMoEConfig
from tpu_composer.models.moe import init_params as jax_moe_init_params
from tpu_composer.models.transformer import ModelConfig as JaxConfig
from tpu_composer.models.transformer import init_params as jax_init_params
from tpu_composer_torch.convert import params_from_jax
from tpu_composer_torch.models.moe import MoEConfig as TorchMoEConfig
from tpu_composer_torch.models.transformer import ModelConfig as TorchConfig

# The serving tests' scale (tests/test_serving.py).
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=128)
# tests/test_moe.py's tiny MoE: layer 1 of 2 routes over 4 experts, top-2.
MOE_SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq=64, n_experts=4, top_k=2, capacity_factor=2.0,
                 moe_period=2)


def configs(dtype: str = "float32", **kw):
    """(JAX config, port config) with the same fields."""
    fields = {**SMALL, **kw}
    return (JaxConfig(dtype=getattr(jnp, dtype), **fields),
            TorchConfig(dtype=getattr(torch, dtype), **fields))


def moe_configs(dtype: str = "float32", **kw):
    """(JAX MoEConfig, port MoEConfig) with the same fields."""
    fields = {**MOE_SMALL, **kw}
    return (JaxMoEConfig(dtype=getattr(jnp, dtype), **fields),
            TorchMoEConfig(dtype=getattr(torch, dtype), **fields))


def moe_world(seed: int = 0, dtype: str = "float32", **kw):
    """(jax config, jax params, port config, port params on the CPU) for
    the MoE family."""
    jc, tc = moe_configs(dtype, **kw)
    jp = jax_moe_init_params(jc, jax.random.key(seed))
    return jc, jp, tc, params_from_jax(to_numpy(jp), tc, device="cpu")


def to_numpy(tree):
    """A JAX pytree as numpy, each leaf in its own dtype: a bf16 leaf is an
    ``ml_dtypes`` bfloat16 array, which ``convert.params_from_jax`` reads
    as bf16 (use :func:`n` for float32 values to compare)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def world(seed: int = 0, dtype: str = "float32", **kw):
    """(jax config, jax params, port config, port params on the CPU)."""
    jc, tc = configs(dtype, **kw)
    jp = jax_init_params(jc, jax.random.key(seed))
    return jc, jp, tc, params_from_jax(to_numpy(jp), tc, device="cpu")


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor (floats via float32)."""
    x = torch.from_numpy(np.array(n(a)))
    return x if dtype is None else x.to(dtype)


def n(x) -> np.ndarray:
    """tensor (or JAX array) -> float32-or-int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    a = np.asarray(x)  # a JAX bf16 array arrives as an ml_dtypes array
    return a if a.dtype.kind in "iub" else a.astype(np.float32)


class JaxGreedy:
    """Greedy solo runs of the JAX package's ``decode.generate``, many per
    call. Prompts are right-padded into one fixed (ROWS, WIDTH) batch with
    ``prompt_lens``: each row of a ragged dense batch decodes exactly as
    its solo run (tests/test_decode.py::test_ragged_equals_per_row_
    generation), and the fixed shape lets one jit per ``kv_quant`` serve
    a whole test module. A request asking for n tokens gets the first n
    of NEW (greedy decoding is prefix-stable)."""

    ROWS, WIDTH, NEW = 8, 80, 12

    def __init__(self, config, params):
        self.config, self.params = config, params
        self._fns = {}

    def _fn(self, kv_quant: bool):
        if kv_quant not in self._fns:
            from tpu_composer.models.decode import generate

            c, new = self.config, self.NEW
            self._fns[kv_quant] = jax.jit(
                lambda p, toks, lens: generate(p, toks, c, new,
                                               kv_quant=kv_quant,
                                               prompt_lens=lens))
        return self._fns[kv_quant]

    def __call__(self, prompts, n_new, kv_quant: bool = False):
        """Token lists for ``prompts`` (lists of ints); ``n_new`` is one
        count for all or one per prompt."""
        if isinstance(n_new, int):
            n_new = [n_new] * len(prompts)
        assert max(n_new) <= self.NEW
        assert max(len(p) for p in prompts) <= self.WIDTH
        out = []
        for i in range(0, len(prompts), self.ROWS):
            part = prompts[i:i + self.ROWS]
            toks = np.zeros((self.ROWS, self.WIDTH), np.int32)
            lens = np.ones(self.ROWS, np.int32)
            for r, p in enumerate(part):
                toks[r, :len(p)] = p
                lens[r] = len(p)
            got = np.asarray(self._fn(kv_quant)(self.params, toks, lens))
            out += [got[r].tolist() for r in range(len(part))]
        return [row[:n] for row, n in zip(out, n_new)]

