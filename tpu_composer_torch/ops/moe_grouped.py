"""The dropless MoE layer's grouped expert path (``models/moe._grouped_ffn``):
the routed (token, choice) pairs grouped by expert, each expert's
products over its own rows, and the combine, through the hand-written
kernels of ``csrc/moe_grouped.cu`` on the card.

Four steps, each a kernel wrapper (``*_cuda``, with a ``launches``
counter), its plain PyTorch twin (``*_plain``, the grouped path's CPU
version and the kernel's reference) and a dispatcher that takes the
kernel for CUDA tensors and the twin for CPU ones:

- :func:`group`: (T, k) expert ids -> (offsets (E + 1,), tok (T·k,),
  row (T·k,)) int32: expert e's rows are ``offsets[e]:offsets[e + 1]`` of
  the sorted order, sorted row i holds token ``tok[i]``, and (token t,
  choice j) lies at sorted row ``row[t·k + j]``; within an expert the
  rows keep the (token, choice) order.
- :func:`gate_up`: h (T·k, F) = SwiGLU of each row's token through its
  expert's gate and up, ``bf16(silu(bf16(x·w_gate)) · bf16(x·w_up))``.
- :func:`down`: y (T·k, D) = h · w_down of each row's expert.
- :func:`combine`: out (T, D) = Σ_j bf16(gate_j) · y[row(t, j)] in fp32 in
  choice order, plus the shared experts' output, rounded once.

The kernels take bf16 operands that :func:`kernel_reason` accepts; the
wrappers raise on anything else and read nothing back from the card, so
a CUDA graph captures them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpu_composer_torch.ops import _build
from tpu_composer_torch.ops.swiglu import swiglu_plain

#: The widest expert count the grouping kernel takes.
MAX_EXPERTS = 256
#: The products' K slices and column tiles: every K and N must divide by it.
TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# ids, n, k, E, offsets, tok, row, stream.
_GROUP_ARGTYPES = [_P, _LL, _I, _I, _P, _P, _P, _P]
# x, tok, w_gate, w_up, offsets, h, E, K, N, stream.
_GATE_UP_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P]
# h, w_down, offsets, y, E, K, N, stream.
_DOWN_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]
# y, row, gates, shared, out, T, k, D, stream.
_COMBINE_ARGTYPES = [_P] * 5 + [_LL, _I, _I, _P]


def kernel_reason(x: torch.Tensor, w_gate, w_up, w_down) -> Optional[str]:
    """Why the grouped kernels do not take these operands (``"autograd"``,
    ``"dtype"``, ``"layout"``, ``"device"`` or ``"shape"``, the first that
    applies), or None where they do: x (..., D) and the expert stacks
    w_gate, w_up (E, D, F) and w_down (E, F, D), bf16, contiguous and
    16-byte aligned on one CUDA device, outside autograd, E at most
    :data:`MAX_EXPERTS`, D and F multiples of :data:`TILE`. A quantized
    stack (not a tensor) is a dtype the kernels do not take."""
    ops = (x, w_gate, w_up, w_down)
    tensors = [t for t in ops if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd"
    if len(tensors) < len(ops) or any(t.dtype != torch.bfloat16
                                      for t in ops):
        return "dtype"
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops):
        return "layout"
    if not all(t.is_cuda and t.device == x.device for t in ops):
        return "device"
    if w_gate.dim() != 3:
        return "shape"
    e, d, f = w_gate.shape
    if (e > MAX_EXPERTS or d % TILE or f % TILE or x.shape[-1] != d
            or w_up.shape != w_gate.shape or w_down.shape != (e, f, d)):
        return "shape"
    return None


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


# -- group ---------------------------------------------------------------------

def group_plain(experts: torch.Tensor, n_experts: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grouping by a stable sort of the flattened (T, k) ids."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64,
                          device=flat.device)
    offsets[1:] = torch.bincount(flat, minlength=n_experts).cumsum(0)
    row = torch.empty_like(order)
    row[order] = torch.arange(order.numel(), device=flat.device)
    return (offsets.to(torch.int32), (order // k).to(torch.int32),
            row.to(torch.int32))


def group_cuda(experts: torch.Tensor, n_experts: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``moe_group`` on (T, k) int64 ids on the card.
    ``group_cuda.launches`` counts the calls."""
    _check("experts", experts, torch.int64, experts.device)
    if experts.dim() != 2 or not 0 < n_experts <= MAX_EXPERTS:
        raise ValueError(f"experts must be (T, k) with 0 < E <= "
                         f"{MAX_EXPERTS}, got {tuple(experts.shape)}, "
                         f"E = {n_experts}")
    t, k = experts.shape
    dev = experts.device
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    tok = torch.empty(t * k, dtype=torch.int32, device=dev)
    row = torch.empty(t * k, dtype=torch.int32, device=dev)
    fn = _build.load("moe_grouped", _GROUP_ARGTYPES, "moe_group")
    with torch.cuda.device(dev):
        rc = fn(experts.data_ptr(), t * k, k, n_experts, offsets.data_ptr(),
                tok.data_ptr(), row.data_ptr(), _stream(experts))
    _raise_on(rc, "moe_group")
    group_cuda.launches += 1
    return offsets, tok, row


group_cuda.launches = 0


def group(experts: torch.Tensor, n_experts: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`group_cuda` on the card, :func:`group_plain` on the CPU."""
    if experts.is_cuda:
        return group_cuda(experts, n_experts)
    return group_plain(experts, n_experts)


# -- the expert products -------------------------------------------------------

def _expert_rows(offsets: torch.Tensor):
    """(expert, first row, end row) of each expert that holds rows, read
    on the host."""
    off = offsets.tolist()
    return [(e, a, b) for e, (a, b) in enumerate(zip(off, off[1:])) if b > a]


def gate_up_plain(x: torch.Tensor, tok: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Each expert's rows of x through its gate and up, in x's dtype,
    then SwiGLU's step (``ops/swiglu.swiglu_plain``)."""
    h = x.new_empty((tok.numel(), w_gate.shape[-1]))
    for e, a, b in _expert_rows(offsets):
        xe = x[tok[a:b].long()]
        h[a:b] = swiglu_plain(xe @ w_gate[e], xe @ w_up[e])
    return h


def _gemm_shapes(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 k_dim: int) -> Tuple[int, int, int]:
    e, k, n = w.shape
    if k != k_dim or k % TILE or n % TILE or offsets.shape != (e + 1,):
        raise ValueError(f"operands {tuple(a.shape)}, {tuple(w.shape)} and"
                         f" offsets {tuple(offsets.shape)} do not fit the"
                         f" grouped kernels (K and N multiples of {TILE})")
    return e, k, n


def gate_up_cuda(x: torch.Tensor, tok: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Launch ``moe_gate_up``: x (T, D) bf16, tok (T·k,) and offsets
    (E + 1,) int32, w_gate and w_up (E, D, F) bf16 -> h (T·k, F) bf16.
    ``gate_up_cuda.launches`` counts the launches (none for no rows)."""
    dev = x.device
    for name, t, dt in (("x", x, torch.bfloat16), ("tok", tok, torch.int32),
                        ("w_gate", w_gate, torch.bfloat16),
                        ("w_up", w_up, torch.bfloat16),
                        ("offsets", offsets, torch.int32)):
        _check(name, t, dt, dev)
    if x.dim() != 2 or w_up.shape != w_gate.shape:
        raise ValueError(f"x {tuple(x.shape)} must be (T, D); w_gate "
                         f"{tuple(w_gate.shape)} and w_up "
                         f"{tuple(w_up.shape)} must match")
    e, k, n = _gemm_shapes(x, w_gate, offsets, x.shape[1])
    h = torch.empty((tok.numel(), n), dtype=x.dtype, device=dev)
    if tok.numel():
        fn = _build.load("moe_grouped", _GATE_UP_ARGTYPES, "moe_gate_up")
        with torch.cuda.device(dev):
            rc = fn(x.data_ptr(), tok.data_ptr(), w_gate.data_ptr(),
                    w_up.data_ptr(), offsets.data_ptr(), h.data_ptr(), e, k,
                    n, _stream(x))
        _raise_on(rc, "moe_gate_up")
        gate_up_cuda.launches += 1
    return h


gate_up_cuda.launches = 0


def gate_up(x: torch.Tensor, tok: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """:func:`gate_up_cuda` on the card, :func:`gate_up_plain` on the CPU."""
    if x.is_cuda:
        return gate_up_cuda(x, tok, w_gate, w_up, offsets)
    return gate_up_plain(x, tok, w_gate, w_up, offsets)


def down_plain(h: torch.Tensor, w_down: torch.Tensor, offsets: torch.Tensor
               ) -> torch.Tensor:
    """Each expert's rows of h through its down projection."""
    y = h.new_empty((h.shape[0], w_down.shape[-1]))
    for e, a, b in _expert_rows(offsets):
        y[a:b] = h[a:b] @ w_down[e]
    return y


def down_cuda(h: torch.Tensor, w_down: torch.Tensor, offsets: torch.Tensor
              ) -> torch.Tensor:
    """Launch ``moe_down``: h (T·k, F) bf16 in sorted order, w_down
    (E, F, D) bf16, offsets (E + 1,) int32 -> y (T·k, D) bf16.
    ``down_cuda.launches`` counts the launches (none for no rows)."""
    dev = h.device
    for name, t, dt in (("h", h, torch.bfloat16),
                        ("w_down", w_down, torch.bfloat16),
                        ("offsets", offsets, torch.int32)):
        _check(name, t, dt, dev)
    if h.dim() != 2:
        raise ValueError(f"h must be (rows, F), got {tuple(h.shape)}")
    e, k, n = _gemm_shapes(h, w_down, offsets, h.shape[1])
    y = torch.empty((h.shape[0], n), dtype=h.dtype, device=dev)
    if h.shape[0]:
        fn = _build.load("moe_grouped", _DOWN_ARGTYPES, "moe_down")
        with torch.cuda.device(dev):
            rc = fn(h.data_ptr(), w_down.data_ptr(), offsets.data_ptr(),
                    y.data_ptr(), e, k, n, _stream(h))
        _raise_on(rc, "moe_down")
        down_cuda.launches += 1
    return y


down_cuda.launches = 0


def down(h: torch.Tensor, w_down: torch.Tensor, offsets: torch.Tensor
         ) -> torch.Tensor:
    """:func:`down_cuda` on the card, :func:`down_plain` on the CPU."""
    if h.is_cuda:
        return down_cuda(h, w_down, offsets)
    return down_plain(h, w_down, offsets)


# -- combine -------------------------------------------------------------------

def combine_plain(y: torch.Tensor, row: torch.Tensor, gates: torch.Tensor,
                  shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (E, B, C) path's combine: each token's k rows of y, weighted by
    its gates rounded to y's dtype, summed in fp32 in choice order, the
    shared experts' output added, rounded once."""
    t, k = gates.shape
    picked = y[row.long()].reshape(t, k, -1).float()
    weight = gates.to(y.dtype).float()[..., None]
    out = weight[:, 0] * picked[:, 0]
    for j in range(1, k):
        out = out + weight[:, j] * picked[:, j]
    if shared is not None:
        out = out + shared.float()
    return out.to(y.dtype)


def combine_cuda(y: torch.Tensor, row: torch.Tensor, gates: torch.Tensor,
                 shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``moe_combine``: y (T·k, D) bf16, row (T·k,) int32, gates
    (T, k) fp32, shared (T, D) bf16 or None -> out (T, D) bf16.
    ``combine_cuda.launches`` counts the launches (none for T = 0)."""
    dev = y.device
    for name, t, dt in (("y", y, torch.bfloat16), ("row", row, torch.int32),
                        ("gates", gates, torch.float32)):
        _check(name, t, dt, dev)
    t, k = gates.shape
    d = y.shape[-1]
    if y.dim() != 2 or d % 8 or row.numel() != t * k or y.shape[0] != t * k:
        raise ValueError(f"y {tuple(y.shape)}, row {tuple(row.shape)} and "
                         f"gates {tuple(gates.shape)} do not fit (D a "
                         f"multiple of 8)")
    if shared is not None:
        _check("shared", shared, torch.bfloat16, dev)
        if shared.shape != (t, d):
            raise ValueError(f"shared must be {(t, d)}, got "
                             f"{tuple(shared.shape)}")
    out = torch.empty((t, d), dtype=y.dtype, device=dev)
    if t:
        fn = _build.load("moe_grouped", _COMBINE_ARGTYPES, "moe_combine")
        with torch.cuda.device(dev):
            rc = fn(y.data_ptr(), row.data_ptr(), gates.data_ptr(),
                    None if shared is None else shared.data_ptr(),
                    out.data_ptr(), t, k, d, _stream(y))
        _raise_on(rc, "moe_combine")
        combine_cuda.launches += 1
    return out


combine_cuda.launches = 0


def combine(y: torch.Tensor, row: torch.Tensor, gates: torch.Tensor,
            shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`combine_cuda` on the card, :func:`combine_plain` on the
    CPU."""
    if y.is_cuda:
        return combine_cuda(y, row, gates, shared)
    return combine_plain(y, row, gates, shared)
