"""Slice qualification (port of ``tpu_composer/workload/acceptance.py``).

``qualify_slice`` runs the two north-star probes: the allreduce bus
bandwidth over the mesh (0.0 on one device; its transport, gloo or
NCCL, is reported beside it) and a real train step of the flagship at
its full width over the mesh, returning step time, tokens/s, achieved
TFLOP/s and MFU against the cards' bf16 dense peak. The flagship
qualifies through the flash kernels (K1 with lse, B3, B4); a kernel that
fails raises. There is no retry with reference attention.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.models.transformer import ModelConfig
from tpu_composer_torch.parallel.collectives import (
    allreduce_bandwidth_gbps,
    backend,
)
from tpu_composer_torch.parallel.mesh import make_mesh, solve_mesh_axes
from tpu_composer_torch.parallel.train import (
    TrainConfig,
    make_train_state,
    make_train_step,
)


def _model_flops_per_token(c: ModelConfig) -> float:
    """~6 * params matmul FLOPs per token for fwd+bwd (standard estimate;
    excludes the attention S*d term, so derived MFU is slightly
    conservative at long seq)."""
    per_layer = (
        3 * c.d_model * c.n_heads * c.head_dim  # qkv
        + c.n_heads * c.head_dim * c.d_model  # out proj
        + 3 * c.d_model * c.d_ff  # swiglu
    )
    params = c.n_layers * per_layer + c.vocab_size * c.d_model
    return 6.0 * params


# Per-device dense bf16 peaks (public data sheets), matched against the
# device name's prefix, most specific first. The TPU rows are the JAX
# package's and match no CUDA device name.
_BF16_PEAK_TFLOPS = (
    ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H100 NVL", 835.0),
    ("NVIDIA H100", 989.0),  # SXM
    ("TPU v5 lite", 197.0),  # v5e
    ("TPU v5e", 197.0),
    ("TPU v5p", 459.0),
    ("TPU v5", 459.0),
    ("TPU v4 lite", 137.0),
    ("TPU v4", 275.0),
    ("TPU v6 lite", 918.0),  # Trillium / v6e
    ("TPU v6e", 918.0),
)


def _bf16_peak_tflops(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peak in _BF16_PEAK_TFLOPS:
        if name.startswith(prefix):
            return peak
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def qualify_slice(
    device: DeviceLike = "cuda",
    batch: int = 8,
    seq: int = 512,
    model_config: Optional[ModelConfig] = None,
    allreduce_mb: float = 64.0,
    steps: int = 5,
    mesh: Optional[DeviceMesh] = None,
) -> Dict[str, float]:
    """Qualify the slice this rank belongs to: every rank of the default
    process group calls it. ``mesh`` defaults to ``solve_mesh_axes`` of
    the world size when a group of several ranks is up, else one
    device."""
    dev = resolve_device(device)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh(solve_mesh_axes(dist.get_world_size()), dev.type)
    mc = model_config or ModelConfig(
        vocab_size=8192, d_model=512, n_layers=4, n_heads=8, d_ff=1408,
        max_seq=seq, attn_impl="flash",
    )
    results: Dict[str, float] = {
        "n_devices": float(mesh.size() if mesh is not None else 1),
        "allreduce_gbps": allreduce_bandwidth_gbps(mesh,
                                                   size_mb=allreduce_mb),
        "transport": backend(mesh),  # type: ignore[dict-item]
    }
    tc = TrainConfig(model=mc)
    state = make_train_state(tc, 0, dev, mesh)
    step_fn = make_train_step(tc, mesh)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, mc.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32).to(dev)
    state, metrics = step_fn(state, tokens)  # first step: kernel builds
    _sync(dev)
    results["attn_impl"] = mc.attn_impl  # type: ignore[assignment]
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, tokens)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps

    tokens_per_step = batch * seq
    results["train_step_ms"] = dt * 1e3
    results["train_loss"] = float(metrics["loss"])
    results["tokens_per_s"] = tokens_per_step / dt
    results["tflops"] = _model_flops_per_token(mc) * tokens_per_step / dt / 1e12
    peak = _bf16_peak_tflops(dev)
    if peak:
        results["mfu"] = results["tflops"] / (results["n_devices"] * peak)
    return results
