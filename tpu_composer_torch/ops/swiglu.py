"""SwiGLU's element-wise step, ``bf16(silu(float(gate)) * float(up))``,
between the gate/up products and the down product, through the
hand-written kernel ``csrc/swiglu.cu`` where it can run.

The dense FFN (``models/transformer.swiglu_ffn``) and the MoE experts
(``models/moe._moe_ffn``) both call :func:`swiglu`. It launches the
kernel when both operands are bf16, contiguous and on a CUDA device,
and autograd is not recording through them (the test
``ops/attention._flash`` makes); otherwise it runs :func:`swiglu_plain`,
the eager chain the call sites ran before the kernel: so training keeps
its gradients and the CPU keeps the exact arithmetic the tests hold to
the JAX package. On the card the kernel gives the eager chain's bits
(``csrc/swiglu.cu`` says how), so which one ran never changes a result.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_composer_torch.ops import _build

# gate, up, out; n; stream.
_SWIGLU_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                            ctypes.c_void_p]


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The eager chain: SiLU of the gate and its product with up in
    float32, rounded once to the operands' dtype. Differentiable."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


def swiglu_cuda(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on contiguous bf16 CUDA tensors of one shape.
    Reads nothing back from the card. ``swiglu_cuda.launches`` counts
    the calls."""
    for name, t in (("gate", gate), ("up", up)):
        if not t.is_cuda or t.device != gate.device:
            raise ValueError(f"{name} must be a CUDA tensor on {gate.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if up.shape != gate.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    fn = _build.load("swiglu", _SWIGLU_ARGTYPES)
    with torch.cuda.device(gate.device):
        rc = fn(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
                torch.cuda.current_stream(gate.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swiglu launch failed: CUDA error {rc}")
    swiglu_cuda.launches += 1
    return out


swiglu_cuda.launches = 0


def eager_reason(gate: torch.Tensor, up: torch.Tensor) -> Optional[str]:
    """Why :func:`swiglu` runs the eager chain on these operands
    (``"autograd"``, ``"dtype"``, ``"layout"`` or ``"device"``, the
    first that applies), or None where it launches the kernel."""
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        return "autograd"
    if gate.dtype != torch.bfloat16 or up.dtype != torch.bfloat16:
        return "dtype"
    if not (gate.is_contiguous() and up.is_contiguous()):
        return "layout"
    if not gate.is_cuda:
        return "device"
    return None


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``bf16(silu(float(gate)) * float(up))`` in the operands' dtype:
    the kernel where :func:`eager_reason` finds nothing against it, the
    eager chain otherwise."""
    if eager_reason(gate, up) is None:
        return swiglu_cuda(gate, up)
    return swiglu_plain(gate, up)
