#!/usr/bin/env python3
"""Drive the PyTorch port's serving, speculative-decoding and training
paths, dense and MoE, one rank and several ranks over a device mesh, on
one NVIDIA GPU and hold every CUDA kernel of those paths against its
plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the ``tpu_composer_torch`` package beside
this file; it exits nonzero without them. Each phase prints one JSON
line and checks its own result; any failure raises and the script exits
nonzero. Phases, in order:

1. ``card``: the card, its power limit, torch and CUDA versions. The
   raw ``nvidia-smi --query-gpu=name,power.limit`` line follows it.
2. ``build``: nvcc seconds per kernel source (all three compile at once)
   and ptxas's report per kernel (registers, spills); a spill in the
   tensor-core B3 or in K2 fails the phase.
3. ``flash_fwd``: kernel K1 against its plain version over B in {1, 2},
   S in {8, 64, 256, 512}, H=8, KV=2, D=64, causal or not, bf16 (at both
   CTA heights, 16 and 64 rows) and fp32, with and without lse; times at
   the serving prefill shape, with the CTA height ``_fwd_rows`` picks
   there and both heights.
4. ``paged_decode``: kernel K2 (split pass and merge) against the gather
   path at the engine's decode shape (B=8, H=8, KV=2, Dh=64, Bs=16,
   MB=32), lengths in 1..512 plus a 0-length row and stale table slots,
   then full rows (every length 512) and rows inside one chunk (lengths
   1..64); fp32, bf16, int8; and at the MoE engine's MHA shape (KV=8,
   G=1, lengths 0..320). Two launches must give the same bits; the
   split geometry (chunk, n_split, CTAs) is printed.
5. ``flash_bwd``: kernels B3 (dQ) and B4 (dK/dV) against
   ``flash_bwd_plain`` over B in {1, 2}, S in {8, 64, 256, 512} at D=64
   and S=100 at D=128, H=8 over KV in {2, 8}, causal or not, fp32 and
   bf16, with and without an lse cotangent, each case checked on its
   own, bf16 GQA cases with B4's group split across CTAs and not; then K1
   with lse, B3 and B4 against their plain versions on the path's own
   inputs: the training shape (8, 512, 8, 2, 64, bf16, causal) and
   ``qualify_slice``'s MHA shape (8, 512, 8, 8, 64); B3 and B4 launched
   twice on the training-shape inputs must each give the same bits; the
   geometry chosen (CTA height, group split, CTA counts) and times at
   the training shape; then the multi-rank path's blocks (bf16): a
   ring block of sp = 2 at seq 512, the causal diagonal and a whole
   off-diagonal block, each with a live lse cotangent, and Ulysses'
   gathered sequence over half the heads, (8, 512, 4, 1, 64).
6. ``serve_exact``: the flagship at full width in fp32, prefill through
   K1 and decode through K2: every request's tokens equal the port's
   solo ``generate`` with reference attention.
7. ``serve``: the flagship in bf16: 16 greedy and sampled requests
   through an 8-slot engine, then an int8-pool engine with chunked
   admission and a shared prefix; tokens/s, step p50, launch counts;
   one mid-flight decode step of each engine through K2 against the
   gather path on copies of the same cache (``k2_midflight``).
8. ``moe_serve_exact``: the MoE flagship (``MoEConfig()``: vocab 32000,
   d_model 512, 4 layers, 8 MHA heads, d_ff 1408, 8 experts top-2 on
   layers 1 and 3) in fp32 with capacity_factor 4.0 (so the solo
   prefill drops nothing), a 4-slot engine with chunked admission and K2
   decode: every request's tokens equal its solo ``generate``.
9. ``moe_serve``: the MoE flagship in bf16, two 8-slot engines with
   chunked admission and a shared 64-token prefix, a bf16 pool (K2 fp)
   and an int8 pool (K2 int8), 16 greedy and sampled requests each;
   first-token logits against the drop-free plain path (an empty dense
   cache, fp or int8 as the pool, and ``decode_chunk`` over the prompt in
   the engine's chunks, reference attention);
   tokens/s, decode step p50, a profile of 8 decode steps with the MoE
   FFN's share; K2 mid-flight against the gather path, as in ``serve``.
10. ``speculative``: the MoE flagship in fp32 (prefill through K1) as
    target, its int8-quantized self as draft, gamma 4, 3 prompts of
    32-200 tokens, 64 new tokens, through ``speculative_generate`` and
    ``paged_speculative_generate``: tokens equal target-only greedy
    ``generate``; acceptance (the drafts accepted, 64 − 1 − rounds, over
    rounds × gamma), tokens/s of each beside ``generate``'s, host syncs
    a round.
11. ``train_exact``: the flagship in fp32, 3 AdamW steps on (4, 256)
   tokens with flash attention (K1 with lse, B3, B4) and 3 with
   reference attention from the same params: losses, grad norms and the
   first step's gradients agree.
12. ``train``: the flagship in bf16 through ``trainer.fit`` on packed
   synthetic Zipf documents (seq 512, batch 8): 20 steps checkpointed
   every 10, then a resumed ``fit`` to 24; tokens/s, step p50, one step
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
   step fails the phase), the device's busy share, and the step's device
   ms with the tied head's two routes in turns (bf16 operands into an
   fp32 output, and both upcast first).
13. ``qualify``: ``qualify_slice()`` at its defaults.
14. ``train_moe``: the MoE flagship in fp32, 3 steps on (4, 256) tokens
    with flash attention (K1 with lse, B3, B4) and 3 with reference
    attention from the same params (the tokens whose top-1 expert
    differs between the two are counted); then bf16 at seq 512, batch 8,
    12 steps on packed Zipf documents: step p50 and tokens/s.
15. ``mesh_train``: a world of 2 ranks and one of 4, spawned on the one
    card over gloo (NCCL refuses two ranks on one GPU, so every
    collective is staged through the host), each rank on the card and
    its kernels built by phase 2. The fp32 flagship (tokens (4, 256), 3
    AdamW steps from the same params) over sp = 2 ring, zigzag and
    Ulysses with the flash inner, ring with the einsum inner, tp = 2,
    dp = 2 and (world 4) sp = 4 zigzag: losses, grad norms and the first
    step's gradients (gathered to rank 0) against ``train_exact``'s
    one-process flash step; the fp32 MoE flagship over ep = 2 and
    (world 4) ep = 2 x sp = 2 Ulysses/flash against ``train_moe``'s
    losses, with the flipped top-1 choices; the bf16 flagship at seq
    512, global batch 8, 12 steps over sp = 2 ring/flash: the loss
    falls, per rank its step p50 and K1-with-lse, B3 and B4 launches a
    step. Ranks print nothing to stdout and send the parent their
    results; a rank's failure or a world past its deadline fails the
    phase, and no rank is left running.
16. ``mesh_nccl``: one rank over NCCL: ``fit`` 3 steps over
    ``make_mesh`` of the card gives the meshless ``fit``'s losses bit
    for bit; ``allreduce_bandwidth_gbps`` reports 0.0.
17. ``timing`` (the whole run's seconds, builds included, and each
    phase's) and ``launches`` (per path: serving is phases 6-7,
    moe_serving 8-9, speculative 10, training 11-13, moe_training 14,
    mesh_training 15-16, its ranks' counts summed in); then the kernels
    line ``{"kernels": [...]}``: per kernel its launches summed over
    every path, max error, kernel / plain / library ms (device time),
    the kernel's issue ms, and the bound.
18. the last line: ``{"ok": true, "device": {...}}``.

Times (``timed``): ``ms`` is device time, the calls queued behind a
spin kernel that outlasts the host's issue of all of them, so the CUDA
events bracket back-to-back device work; ``issue_ms`` is the same calls
bracketed as the host issues them, which is the host's pace once a call
takes less device time than its validation, allocation and ctypes call.
Every kernel, plain and library time is printed in both measures.

Tolerances (absolute unless said): K1 fp32 1e-4, bf16 2e-2, lse 1e-4.
K2 fp32 1e-4; bf16 2e-2 (the kernel keeps P in fp32, the gather path
rounds P to bf16 first). B3/B4 relative to each gradient's own max|ref|
in each case (printed beside the worst error): fp32 1e-4 (other
summation order); bf16 3e-2 (dS is rounded to bf16 before two
products). First-token logits of the bf16 engine against the plain path
5e-2; of the int8-pool engine against an unquantized prefill 1e-1 (the
same for the MoE engines, against the drop-free plain path).
``train_exact``: losses 1e-4, grad norms 1e-3 relative, gradients 1e-4
relative to max(1, max|ref|) (flash against reference attention, fp32).
``train_moe``: losses 1e-3 relative (one flipped routing choice moves
one token's FFN). ``mesh_train``: the dense checks as ``train_exact``,
against the one-process flash step; MoE losses 1e-3 relative. K2
mid-flight against the gather path: 5e-2 (bf16 pool), 1e-1 (int8). Token streams (``serve_exact``, ``moe_serve_exact``,
``speculative``): equal; on a mismatch the target's top-2 logit gap at
the first diverging token is printed (under 1e-4 names float drift).
fp32 matmuls run in full fp32 (TF32 off, below).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int8: 1979e12}

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LSE_TOL = 1e-4
LOGIT_TOL_BF16 = 5e-2
LOGIT_TOL_INT8 = 1e-1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per device millisecond."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(2_000_000)
    b.record()
    b.synchronize()
    return 2_000_000 / a.elapsed_time(b)


def timed(fn, iters: int = 50, warmup: int = 5) -> tuple:
    """(device ms, issue ms) per call of ``fn`` over ``iters`` back-to-back
    calls, CUDA events around them, inputs warm in L2.

    issue ms: the events bracket the calls as the host issues them, so a
    call that takes less device time than the host's work to issue it
    (validation, allocation, ctypes) is timed at the host's pace.
    device ms: the same calls queued behind a spin kernel
    (``torch.cuda._sleep``) that outlasts the host's issue of all of them
    by a margin, the start event recorded after the spin, so the events
    bracket back-to-back device work. The start event must still be
    pending when the last call is queued (the queue was full when the
    device reached it); if not, the spin doubles and the run repeats.
    The host blocks once about a thousand launches wait on the stream, so
    ``iters`` times the launches of one call stays well under that."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    issue_ms = start.elapsed_time(end) / iters
    spin_ms, cycles_per_ms = 2 * host_ms + 1.0, _spin_cycles_per_ms()
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        filled = not start.query()
        end.synchronize()
        if filled:
            return start.elapsed_time(end) / iters, issue_ms
        spin_ms *= 2
    raise RuntimeError("the host never got ahead of the device")


def timings(kernel, plain, library=None) -> dict:
    """Both measures of :func:`timed` for a kernel (one or two launches a
    call), its plain version (tens of launches a call) and, where there is
    one, its library yardstick (up to about ten)."""
    t = {}
    t["ms"], t["issue_ms"] = timed(kernel)
    t["plain_ms"], t["plain_issue_ms"] = timed(plain, iters=10)
    t["library_ms"], t["library_issue_ms"] = (
        timed(library, iters=20) if library is not None else (None, None))
    return t


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("card", **card)
    print(smi, flush=True)
    return card


# Kernels that must compile without spills: the tensor-core B3 and K2's
# two kernels (every instantiation).
NO_SPILL = ("flash_bwd_dq_tc_kernel", "paged_decode_split_kernel",
            "paged_decode_merge_kernel")


def _ptxas_report(log: str) -> list:
    """[kernel, template arguments, registers, spill bytes] per kernel
    from ``nvcc -Xptxas=-v`` output; the names are read from the mangled
    symbol, its template arguments left mangled."""
    import re

    rows, current = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", ln)
        if m:
            name = re.search(r"\d+([a-z][a-z_]*_kernel)(I\w*?E)?E?v",
                             m.group(1))
            current = ([name.group(1), name.group(2) or "", None, 0]
                       if name else [m.group(1)[:60], "", None, 0])
            if not rows or rows[-1][:2] != current[:2]:
                rows.append(current)
            else:
                current = rows[-1]
        elif current is not None and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes spill", ln)]
            current[3] = max([current[3]] + nums)
        elif current is not None and "Used" in ln:
            current[2] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return rows


def phase_build() -> None:
    from tpu_composer_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build(["flash_fwd", "paged_decode", "flash_bwd"])
    ptxas = {name: _ptxas_report(log)
             for name, (_, log) in _build.build_log.items()}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         ptxas=ptxas)
    for name, rows in ptxas.items():
        for kernel, targs, regs, spill in rows:
            check(not (kernel in NO_SPILL and spill),
                  f"{name}: {kernel}{targs} spills {spill} bytes")


TRAIN_SHAPE = (8, 512, 8, 2, 64)  # B, S, H, KV, D of the training path
QUALIFY_SHAPE = (8, 512, 8, 8, 64)  # qualify_slice's default model: MHA


def _attn_inputs(gen, shape, dtype):
    b, s, h, kv, d = shape
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    do = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    return q, k, v, do


def _attn_bounds(shape, dtype, causal: bool = True) -> dict:
    """Bytes and operations of K1 (without and with lse), B3 and B4 on
    ``shape``: each input read once, each output written once; 2·D
    operations per (q, k) pair per product (2 in K1, 3 in B3, 4 in B4),
    live pairs only."""
    b, s, h, kv, d = shape
    e = torch.tensor([], dtype=dtype).element_size()
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    q_bytes, kv_bytes, row_bytes = b * s * h * d * e, b * s * kv * d * e, \
        b * h * s * 4
    work = {
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes, 2),
        "flash_fwd_lse": (2 * q_bytes + 2 * kv_bytes + row_bytes, 2),
        "flash_bwd_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 3),
        "flash_bwd_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 4),
    }
    out = {}
    for name, (n_bytes, products) in work.items():
        ms, by = bound_ms(n_bytes, products * 2 * d * pairs, dtype)
        out[name] = {"bound_ms": ms, "bound_by": by, "bytes": n_bytes,
                     "operations": products * 2 * d * pairs}
    return out


def phase_flash(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.attention import (
        _fwd_rows,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    h, kv, d = 8, 2, 64
    errs = {}
    # The flagship's head_dim 64 at every shape, and the kernel's other
    # head_dim, 128, at one ragged length; bf16 at both CTA heights.
    shapes = [(b, s, d) for b in (1, 2) for s in (8, 64, 256, 512)]
    shapes.append((1, 100, 128))
    for dtype in (torch.float32, torch.bfloat16):
        worst = worst_lse = worst_with_lse = 0.0
        geometries = (16, 64) if dtype == torch.bfloat16 else (None,)
        for b, s, dd in shapes:
            q = torch.randn(b, s, h, dd, generator=gen).to("cuda", dtype)
            k = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            v = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            for causal in (False, True):
                for with_lse in (False, True):
                    want, lse_w = flash_fwd_plain(q, k, v, causal,
                                                  with_lse)
                    for rows in geometries:
                        got, lse = flash_fwd_cuda(q, k, v, causal, with_lse,
                                                  rows=rows)
                        torch.cuda.synchronize()
                        err = max_err(got, want)
                        worst = max(worst, err)
                        if with_lse:
                            worst_with_lse = max(worst_with_lse, err)
                            worst_lse = max(worst_lse, max_err(lse, lse_w))
        name = str(dtype).replace("torch.", "")
        errs[name] = {"out": worst, "lse": worst_lse,
                      "out_with_lse": worst_with_lse}
        check(worst <= TOL[dtype], f"flash_fwd {name} error {worst}")
        check(worst_lse <= LSE_TOL, f"flash_fwd {name} lse error {worst_lse}")

    # The serving prefill shape: one prompt padded to its 256 bucket.
    b, s, dtype = 1, 256, torch.bfloat16
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = _fwd_rows(b, h, s)
    timing = {
        "shape": [b, s, h, kv, d], "dtype": "bfloat16", "causal": True,
        "rows": rows, "ctas": b * h * -(-s // rows),
        **timings(lambda: flash_fwd_cuda(q, k, v, True),
                  lambda: flash_fwd_plain(q, k, v, True),
                  lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    # Both CTA heights at this shape, device time and issue time.
    timing["by_rows"] = {
        str(r): dict(zip(("ms", "issue_ms"), timed(
            lambda r=r: flash_fwd_cuda(q, k, v, True, rows=r))))
        for r in (16, 64)}
    bound = _attn_bounds((b, s, h, kv, d), dtype)["flash_fwd"]
    timing["bound_ms"], timing["bound_by"] = bound["bound_ms"], \
        bound["bound_by"]
    timing["max_abs_err"] = errs["bfloat16"]["out"]
    emit("flash_fwd", errors=errs, tol={"fp32": 1e-4, "bf16": 2e-2,
                                       "lse": LSE_TOL}, **timing)
    return timing


def _paged_inputs(gen: torch.Generator, dtype, quant: bool, dh: int = 64,
                  max_len: int = 512, full: bool = False, kv: int = 2):
    """Engine decode shape: 8 rows over a 256-block pool of 16 positions,
    32 table slots per row, 8 query heads over ``kv`` KV heads (2 for the
    dense flagship, 8 for the MHA MoE flagship). Row 0 has length 0; the
    rest draw lengths in 1..max_len; with ``full`` every row has length
    512. Owned slots hold distinct ids; the slots past each row's blocks
    hold stale ids that may name other rows' blocks."""
    from tpu_composer_torch.models.decode import quantize_kv

    b, h, bs, mb, n = 8, 8, 16, 32, 256
    if full:
        lengths = torch.full((b,), mb * bs)
    else:
        lengths = torch.randint(1, max_len + 1, (b,), generator=gen)
        lengths[0] = 0
    owned = -(-lengths // bs)
    perm = torch.randperm(n, generator=gen)
    tables = torch.randint(0, n, (b, mb), generator=gen)
    used = 0
    for r in range(b):
        # 8 rows x <= 32 blocks = 256: the pool covers every row.
        tables[r, :owned[r]] = perm[used:used + owned[r]]
        used += int(owned[r])
    q = torch.randn(b, h, dh, generator=gen)
    kf = torch.randn(n, bs, kv, dh, generator=gen)
    vf = torch.randn(n, bs, kv, dh, generator=gen)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kf), quantize_kv(vf)
        scales = (ks.cuda(), vs.cuda())
    else:
        kp, vp, scales = kf.to(dtype), vf.to(dtype), (None, None)
    return (q.to("cuda", dtype), kp.cuda(), vp.cuda(),
            tables.to("cuda", torch.int32), lengths.to("cuda", torch.int32),
            *scales)


def _paged_bound(args) -> tuple:
    q, kp, vp, tables, lengths, ks, vs = args
    bs, mb = kp.shape[1], tables.shape[1]
    live = lengths.clamp(max=mb * bs).long()
    positions = int(live.sum())
    per_pos = kp.shape[2] * kp.shape[3] * kp.element_size() * 2  # K and V
    if ks is not None:
        per_pos += kp.shape[2] * 4 * 2
    n_bytes = (2 * q.numel() * q.element_size() + positions * per_pos
               + int((-(-live // bs)).sum()) * 4 + lengths.numel() * 4)
    n_ops = 4 * q.shape[1] * q.shape[2] * positions
    return bound_ms(n_bytes, n_ops, kp.dtype)


def phase_paged(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.paged_attention import (
        _decode_split,
        paged_decode_cuda,
        paged_decode_plain,
    )

    # The flagship's head_dim 64, and the kernel's other head_dim, 128;
    # random lengths (0..512), then full rows and rows inside one chunk.
    cases = {"fp32": (torch.float32, False, 64, {}),
             "bf16": (torch.bfloat16, False, 64, {}),
             "int8_q_fp32": (torch.float32, True, 64, {}),
             "int8_q_bf16": (torch.bfloat16, True, 64, {}),
             "bf16_dh128": (torch.bfloat16, False, 128, {}),
             "int8_q_fp32_dh128": (torch.float32, True, 128, {}),
             "bf16_full": (torch.bfloat16, False, 64, {"full": True}),
             "int8_q_fp32_full": (torch.float32, True, 64, {"full": True}),
             "fp32_one_chunk": (torch.float32, False, 64, {"max_len": 64}),
             "bf16_one_chunk": (torch.bfloat16, False, 64, {"max_len": 64}),
             # The MoE engine's shape: MHA, G = 1, lengths 0..320.
             "fp32_mha": (torch.float32, False, 64, {"kv": 8, "max_len": 320}),
             "bf16_mha": (torch.bfloat16, False, 64,
                          {"kv": 8, "max_len": 320}),
             "int8_q_bf16_mha": (torch.bfloat16, True, 64,
                                 {"kv": 8, "max_len": 320})}
    errs, timing = {}, {}
    for name, (dtype, quant, dh, kw) in cases.items():
        worst = 0.0
        for _ in range(3):
            args = _paged_inputs(gen, dtype, quant, dh, **kw)
            got = paged_decode_cuda(*args)
            want = paged_decode_plain(*args)
            torch.cuda.synchronize()
            if not kw.get("full"):
                check(bool((got[0] == 0).all()),
                      f"paged {name}: 0-length row")
            worst = max(worst, max_err(got, want))
        errs[name] = worst
        check(worst <= TOL[dtype], f"paged_decode {name} error {worst}")
        # Two launches on the same inputs: the same bits (the partials
        # merge in a fixed order, no atomics).
        again = paged_decode_cuda(*args)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.uint8), again.view(torch.uint8)),
              f"paged_decode {name}: two launches differ")
        if name in ("bf16", "int8_q_bf16", "bf16_mha", "int8_q_bf16_mha"):
            t = {**timings(lambda: paged_decode_cuda(*args),
                           lambda: paged_decode_plain(*args)),
                 "max_abs_err": worst, "lengths": args[4].tolist()}
            t["bound_ms"], t["bound_by"] = _paged_bound(args)
            timing[name] = t
    b, kv, bs, mb = 8, 2, 16, 32
    chunk, n_split = _decode_split(bs, mb)
    emit("paged_decode", errors=errs,
         tol={"fp32": 1e-4, "bf16": 2e-2}, shape=[8, 8, 2, 64, 16, 32, 256],
         mha_shape=[8, 8, 8, 64, 16, 32, 256],
         geometry={"chunk": chunk, "n_split": n_split,
                   "split_ctas": b * kv * n_split,
                   "split_ctas_mha": b * 8 * n_split},
         bitwise_repeatable=True, timing=timing)
    return timing


def _bwd_errors(got, want, dtype, case: str, worst: dict) -> None:
    """Check each of dq, dk, dv of one case against its plain value,
    relative to that gradient's own max|ref|, and keep in ``worst`` the
    worst case of each gradient with its error and scale, and the
    smallest scale seen."""
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err, scale = max_err(a, w), float(w.float().abs().max())
        check(0 < scale and err <= BWD_TOL[dtype] * scale,
              f"flash_bwd {case} {name}: error {err} against max|ref|"
              f" {scale} (tolerance {BWD_TOL[dtype]} x max|ref|)")
        least = min(scale, worst.get(name, {}).get("least_max_ref", scale))
        if name not in worst or err / scale > worst[name]["relative"]:
            worst[name] = {"relative": err / scale, "abs": err,
                           "max_ref": scale, "case": case}
        worst[name]["least_max_ref"] = least


def phase_flash_bwd(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.attention import (
        _delta,
        _dkv_split,
        _fwd_rows,
        flash_bwd_cuda,
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_bwd_plain,
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    h = 8
    shapes = [(b, s, 64) for b in (1, 2) for s in (8, 64, 256, 512)]
    shapes.append((1, 100, 128))  # ragged length, the other head_dim
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst: dict = {}
        for b, s, d in shapes:
            for kv in (2, 8):
                q, k, v, do = _attn_inputs(gen, (b, s, h, kv, d), dtype)
                for causal in (False, True):
                    out, lse = flash_fwd_cuda(q, k, v, causal, with_lse=True)
                    for with_g in (False, True):
                        g_lse = (torch.randn(b, h, s, generator=gen).cuda()
                                 if with_g else None)
                        got = flash_bwd_cuda(q, k, v, out, lse, do, g_lse,
                                             causal)
                        torch.cuda.synchronize()
                        want = flash_bwd_plain(q, k, v, out, lse, do, g_lse,
                                               causal)
                        case = (f"B{b} S{s} D{d} KV{kv} causal={causal}"
                                f" g_lse={with_g}")
                        _bwd_errors(got, want, dtype, case, worst)
                        if dtype == torch.bfloat16 and kv < h:
                            # B4 with its GQA group in one CTA too (the
                            # default splits it at these sizes).
                            delta = _delta(out, do, g_lse)
                            one = flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                     causal, split=1)
                            torch.cuda.synchronize()
                            _bwd_errors((got[0], *one), want, dtype,
                                        case + " split=1", worst)
        errs[str(dtype).replace("torch.", "")] = worst

    # The path's own inputs: the train step's GQA shape and qualify_slice's
    # MHA shape, bf16, causal, no lse cotangent. K1 with lse against its
    # plain version, then B3 and B4 on K1's out and lse.
    dtype = torch.bfloat16
    path = {}
    for label, shape in (("qualify", QUALIFY_SHAPE), ("train", TRAIN_SHAPE)):
        q, k, v, do = _attn_inputs(gen, shape, dtype)
        out, lse = flash_fwd_cuda(q, k, v, True, with_lse=True)
        out_w, lse_w = flash_fwd_plain(q, k, v, True, with_lse=True)
        got = flash_bwd_cuda(q, k, v, out, lse, do, None, True)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, out_w), max_err(lse, lse_w)
        check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
        check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse error {e_lse}")
        worst = {}
        _bwd_errors(got, flash_bwd_plain(q, k, v, out, lse, do, None, True),
                    dtype, f"{label} {list(shape)}", worst)
        path[label] = {"shape": list(shape), "out": e_out, "lse": e_lse,
                       **worst}
    errs["bfloat16_path"] = path

    # B3 and B4 twice on the training-shape inputs: the same bits (each
    # B3 CTA owns its dQ rows; B4's split partials are summed in a fixed
    # order; no atomics).
    delta = _delta(out, do)
    b, s, h, kv, d = shape
    split = _dkv_split(b, kv, h // kv, s)
    twice = [flash_bwd_dq_cuda(q, k, v, do, lse, delta, True)
             for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(twice[0].view(torch.int16), twice[1].view(torch.int16)),
          "flash_bwd_dq: two launches on the same inputs differ")
    twice = [flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
             for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(x.view(torch.int16), y.view(torch.int16))
              for x, y in zip(*twice)),
          "flash_bwd_dkv: two launches on the same inputs differ")

    # Times at the training shape, on the inputs left by the loop above.
    # The library yardsticks, timed only: SDPA's forward, and SDPA's
    # backward on one recorded forward.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    recorded = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(recorded, (qt, kt, vt), dot,
                                   retain_graph=True)

    # The plain backward computes dq, dk and dv (and δ) in one pass, and
    # SDPA's backward all three: both kernel rows carry their times.
    def plain_bwd():
        return flash_bwd_plain(q, k, v, out, lse, do, None, True)

    timing = {
        "flash_fwd_lse": timings(
            lambda: flash_fwd_cuda(q, k, v, True, True),
            lambda: flash_fwd_plain(q, k, v, True, True), sdpa_fwd),
        "flash_bwd_dq": timings(
            lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
            plain_bwd, sdpa_bwd),
        "flash_bwd_dkv": timings(
            lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True),
            plain_bwd, sdpa_bwd),
    }
    bounds = _attn_bounds(shape, dtype)
    for name in timing:
        timing[name].update(bounds[name])
    # The kernels rows carry the errors on the path's own inputs.
    runs = path.values()
    timing["flash_fwd_lse"]["max_abs_err"] = max(r["out"] for r in runs)
    timing["flash_bwd_dq"]["max_abs_err"] = max(r["dq"]["abs"] for r in runs)
    timing["flash_bwd_dkv"]["max_abs_err"] = max(
        r[g]["abs"] for r in runs for g in ("dk", "dv"))

    # The multi-rank training path's blocks (phase mesh_train's run,
    # bf16): a ring block of sp = 2 at seq 512 (the causal diagonal and a
    # whole off-diagonal block, each with the lse cotangent the ring's
    # merge sends) and Ulysses' gathered sequence over half the heads.
    mesh_path = {}
    for label, mshape, causal, with_g in (
            ("ring_diagonal", (8, 256, 8, 2, 64), True, True),
            ("ring_offdiagonal", (8, 256, 8, 2, 64), False, True),
            ("ulysses", (8, 512, 4, 1, 64), True, False)):
        q, k, v, do = _attn_inputs(gen, mshape, dtype)
        out, lse = flash_fwd_cuda(q, k, v, causal, with_lse=True)
        out_w, lse_w = flash_fwd_plain(q, k, v, causal, with_lse=True)
        g_lse = (torch.randn(mshape[0], mshape[2], mshape[1],
                             generator=gen).cuda() if with_g else None)
        got = flash_bwd_cuda(q, k, v, out, lse, do, g_lse, causal)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, out_w), max_err(lse, lse_w)
        check(e_out <= TOL[dtype], f"flash_fwd_lse {label} error {e_out}")
        check(e_lse <= LSE_TOL, f"flash_fwd_lse {label} lse error {e_lse}")
        worst = {}
        _bwd_errors(got, flash_bwd_plain(q, k, v, out, lse, do, g_lse,
                                         causal),
                    dtype, f"{label} {list(mshape)}", worst)
        bq, sq, hq, kvq, _ = mshape
        mesh_path[label] = {
            "shape": list(mshape), "causal": causal, "g_lse": with_g,
            "out": e_out, "lse": e_lse, **worst,
            "flash_fwd_rows": _fwd_rows(bq, hq, sq),
            "flash_bwd_dkv_split": _dkv_split(bq, kvq, hq // kvq, sq)}
    errs["bfloat16_mesh_path"] = mesh_path
    rows = _fwd_rows(b, h, s)
    emit("flash_bwd", errors=errs, tol={"fp32": 1e-4, "bf16": 3e-2,
                                        "relative_to": "max|ref| per gradient",
                                        "flash_fwd_lse": [TOL[dtype], LSE_TOL]},
         shape=list(shape), dtype="bfloat16", causal=True,
         geometry={"flash_fwd_rows": rows,
                   "flash_fwd_ctas": b * h * -(-s // rows),
                   "flash_bwd_dq_ctas": b * h * -(-s // 64),
                   "flash_bwd_dkv_split": split,
                   "flash_bwd_dkv_ctas": b * kv * -(-s // 64) * split},
         dq_bitwise_repeatable=True, dkv_bitwise_repeatable=True,
         timing=timing)
    return timing


FLAGSHIP = dict(vocab_size=8192, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=2, d_ff=1408, max_seq=512)


# The full-width MoE flagship: MoEConfig()'s defaults, bf16 and a fp32
# router unless a phase says otherwise.
MOE_FLAGSHIP = dict(vocab_size=32000, d_model=512, n_layers=4, n_heads=8,
                    d_ff=1408, max_seq=2048, n_experts=8, top_k=2,
                    capacity_factor=1.25, moe_period=2)
DEVICE = "cuda"


def _counts() -> dict:
    """Every kernel wrapper's launch count, by kernel row."""
    from tpu_composer_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    return {"flash_fwd": flash_fwd_cuda.launches,
            "flash_fwd_lse": flash_fwd_cuda.launches_lse,
            "flash_bwd_dq": flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": flash_bwd_dkv_cuda.launches,
            "paged_decode": paged_decode_cuda.launches,
            "paged_decode_int8": paged_decode_cuda.launches_int8}


def _set_counts(counts: dict) -> None:
    """Set every kernel wrapper's launch count (``_counts``' keys)."""
    from tpu_composer_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    flash_fwd_cuda.launches = counts["flash_fwd"]
    flash_fwd_cuda.launches_lse = counts["flash_fwd_lse"]
    flash_bwd_dq_cuda.launches = counts["flash_bwd_dq"]
    flash_bwd_dkv_cuda.launches = counts["flash_bwd_dkv"]
    paged_decode_cuda.launches = counts["paged_decode"]
    paged_decode_cuda.launches_int8 = counts["paged_decode_int8"]


def _reset_counts() -> None:
    _set_counts(dict.fromkeys(_counts(), 0))


class _uncounted:
    """Launches inside this block are put back out of the counts: the
    comparisons of a kernel with its plain version do not count toward a
    path's launches."""

    def __enter__(self):
        self.saved = _counts()

    def __exit__(self, *exc):
        _set_counts(self.saved)
        return False


def _k2_against_gather(eng) -> dict:
    """One mid-flight decode step of ``eng`` through K2 and through the
    gather path, each on its own copy of the engine's cache (the engine
    itself does not move): the live rows' logits and their distance."""
    from tpu_composer_torch.models.paged import paged_decode_step

    admitting = {st["slot"] for st in eng._admitting}
    active = np.array([r is not None and s not in admitting
                       for s, r in enumerate(eng._slot_req)], bool)
    token = torch.as_tensor(eng._next_token, device=eng.device)
    lengths = eng.cache.length.cpu().numpy()[active]
    logits = {}
    with _uncounted():
        for impl in ("kernel", "gather"):
            cache = eng.cache._replace(**{
                f: v.clone() for f, v in eng.cache._asdict().items()
                if torch.is_tensor(v)})
            out, _, ok = paged_decode_step(eng.params, cache, token,
                                           eng.config, attn_impl=impl,
                                           active=active)
            check(bool(ok), "K2 check: the pool copy ran out of blocks")
            logits[impl] = out[torch.from_numpy(active).to(out.device)]
    return {"rows": int(active.sum()), "lengths": lengths.tolist(),
            "err": max_err(logits["kernel"], logits["gather"])}


def _launched(before: dict, kernels) -> dict:
    """Launches of ``kernels`` since the counts ``before``."""
    after = _counts()
    return {k: after[k] - before[k] for k in kernels}


def phase_serve_exact(rng: np.random.Generator, seed: int) -> dict:
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device="cuda")
    before = _counts()
    eng = ContinuousBatchingEngine(params, cfg, slots=4, num_blocks=128,
                                   block_size=16, blocks_per_row=32,
                                   attn_impl="kernel")
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 64, 131, 256)]
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run()
    launches = _launched(before, ("flash_fwd", "paged_decode"))
    for req, p in zip(reqs, prompts):
        solo = generate(params, torch.tensor([p], device="cuda"), ref,
                        max_new_tokens=24)[0].tolist()
        check(req.tokens == solo,
              f"serve_exact request {req.req_id} diverged from its solo run")
    check(all(n > 0 for n in launches.values()),
          f"serve_exact did not launch every kernel: {launches}")
    check(int(eng.cache.free_top) == 128, "serve_exact pool did not drain")
    emit("serve_exact", requests=len(reqs), tokens_equal=True,
         launches=launches)
    return launches


def _make_recording_engine():
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine

    class RecordingEngine(ContinuousBatchingEngine):
        """Keeps each request's first-token logits for the plain check."""

        first_logits: dict

        def _pick_first(self, slot, logits_1v):
            self.first_logits[self._slot_req[slot].req_id] = (
                logits_1v[0].float().cpu())
            return super()._pick_first(slot, logits_1v)

    return RecordingEngine


def _submit_all(eng, rng, vocab: int, seed: int, new_tokens: int,
                prefix=None) -> list:
    """16 requests of 16-256 tokens (the even ones after ``prefix`` when
    given), the odd ones sampled (temperature 0.8, top-k 50, top-p
    0.95)."""
    reqs = []
    for i in range(16):
        n = int(rng.integers(16, 257))
        prompt = rng.integers(0, vocab, n).tolist()
        if prefix is not None and i % 2 == 0:
            prompt = prefix.tokens + prompt
            kw = {"prefix": prefix}
        else:
            kw = {}
        if i % 2:
            kw.update(temperature=0.8, top_k=50, top_p=0.95, seed=seed + i)
        reqs.append(eng.submit(prompt, new_tokens, **kw))
    return reqs


def _drive(eng) -> dict:
    """Run the engine to completion, timing every step on the host clock
    (each step ends in a host read of the picked tokens). At the first
    decode-only step after the 10th with two rows or more in flight, K2
    is held against the gather path (untimed: ``k2_midflight``)."""
    steps, decode_only = [], []
    k2 = None
    t0 = time.perf_counter()
    while eng._waiting or any(r is not None for r in eng._slot_req):
        quiet = not eng._waiting and not eng._admitting
        if (k2 is None and quiet and len(steps) >= 10
                and sum(r is not None for r in eng._slot_req) >= 2):
            t_check = time.perf_counter()
            k2 = _k2_against_gather(eng)
            t0 += time.perf_counter() - t_check
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - s0) * 1e3
        steps.append(dt)
        if quiet:
            decode_only.append(dt)
    wall = time.perf_counter() - t0
    check(k2 is not None, "no decode step was in flight for the K2 check")
    return {"wall_s": wall, "steps": len(steps), "k2_midflight": k2,
            "step_ms_p50": float(np.median(steps)),
            "decode_step_ms_p50": (float(np.median(decode_only))
                                   if decode_only else None)}


def _device_share(step, n_steps: int = 8, ranges=()) -> dict:
    """Device busy share over a few calls of ``step`` (torch.profiler):
    summed kernel time over host wall time, and the kernels that take
    it; for each ``record_function`` range named in ``ranges``, its host
    time and the device time of the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # A range shows on the device too (as an annotation spanning its
    # kernels and the gaps between them): kernels only here.
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in events if any(
        n in e.key for n in ("flash_fwd", "flash_bwd", "dkv_reduce",
                             "paged_decode"))]
    return {"steps": n_steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "kernel_launches": sum(e.count for e in events),
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top],
            "port_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in ours],
            "ranges": {e.key: {"host_ms": e.cpu_time_total / 1e3,
                               "device_ms": e.device_time_total / 1e3,
                               "calls": e.count}
                       for e in averages if e.key in ranges
                       and e.device_type == torch.autograd.DeviceType.CPU}}


def phase_serve(rng: np.random.Generator, seed: int) -> dict:
    from tpu_composer_torch.models.decode import prefill
    from tpu_composer_torch.models.serving import _bucket
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device="cuda")
    Engine = _make_recording_engine()
    new_tokens = 64

    def plain_first_logits(prompt):
        pad = _bucket(len(prompt))
        toks = torch.zeros((1, pad), dtype=torch.long, device="cuda")
        toks[0, :len(prompt)] = torch.tensor(prompt)
        logits, _ = prefill(params, toks, ref, prompt_lens=[len(prompt)])
        return logits[0].float().cpu()

    def submit_all(eng, prefix=None):
        return _submit_all(eng, rng, cfg.vocab_size, seed, new_tokens, prefix)

    results = {}
    # Engine A: bucketed admission (prefill through K1), bf16 pool (K2).
    before = _counts()
    eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                 blocks_per_row=32, attn_impl="kernel")
    eng.first_logits = {}
    reqs = submit_all(eng)
    stats = _drive(eng)
    launches = _launched(before, ("flash_fwd", "paged_decode"))
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "bf16 engine left a request unfinished")
    check(int(eng.cache.free_top) == 256, "bf16 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"bf16 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_BF16, f"bf16 first-token logits off by {worst}")
    check(stats["k2_midflight"]["err"] <= LOGIT_TOL_BF16,
          f"bf16 engine: K2 mid-flight logits off the gather path by"
          f" {stats['k2_midflight']['err']}")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    results["bf16"] = dict(stats, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / stats["wall_s"],
                           launches=launches, first_logit_err=worst)
    emit("serve", engine="bf16", **results["bf16"])

    # The device's share of a decode step: 8 requests decoding in 8 slots.
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 128).tolist(), 64)
    while eng._waiting:
        eng.step()  # one admission per step
    results["profile"] = _device_share(eng.step)
    emit("serve_profile", **results["profile"])
    eng.run()

    # Engine B: int8 pool (K2 int8), chunked admission, a shared prefix
    # (registered through a bucketed prefill, so K1 too).
    before = _counts()
    eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                 blocks_per_row=32, attn_impl="kernel", kv_quant=True,
                 prefill_chunk=64)
    eng.first_logits = {}
    handle = eng.register_prefix(rng.integers(0, cfg.vocab_size, 64).tolist())
    reqs = submit_all(eng, prefix=handle)
    stats = _drive(eng)
    launches = _launched(before, ("flash_fwd", "paged_decode_int8"))
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "int8 engine left a request unfinished")
    eng.close_prefix(handle)
    check(int(eng.cache.free_top) == 256, "int8 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"int8 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_INT8, f"int8 first-token logits off by {worst}")
    check(stats["k2_midflight"]["err"] <= LOGIT_TOL_INT8,
          f"int8 engine: K2 mid-flight logits off the gather path by"
          f" {stats['k2_midflight']['err']}")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    results["int8"] = dict(stats, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / stats["wall_s"],
                           launches=launches, first_logit_err=worst)
    emit("serve", engine="int8_chunked_prefix", **results["int8"])
    return results


def _grads(params, tokens, cfg):
    from tpu_composer_torch.models.transformer import loss_fn
    from tpu_composer_torch.parallel.train import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    return torch.autograd.grad(loss_fn(live, tokens, cfg), tree_leaves(live))


def phase_train_exact(seed: int) -> dict:
    """fp32 flagship: flash attention (K1 with lse, B3, B4) against
    reference attention through 3 train steps from the same params."""
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, FLAGSHIP["vocab_size"], (4, 256),
                             generator=gen, dtype=torch.int32).cuda()
               for _ in range(3)]
    runs = {}
    for impl in ("flash", "reference"):
        cfg = ModelConfig(dtype=torch.float32, attn_impl=impl, **FLAGSHIP)
        tc = TrainConfig(model=cfg)
        state = make_train_state(tc, seed, "cuda")
        grads = _grads(state["params"], batches[0], cfg)
        step = make_train_step(tc)
        metrics = []
        for toks in batches:
            state, m = step(state, toks)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[impl] = (grads, metrics)
    (g_f, m_f), (g_r, m_r) = runs["flash"], runs["reference"]
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(m_f, m_r))
    norm_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                   for a, b in zip(m_f, m_r))
    grad_err = max(max_err(a, b) / max(1.0, float(b.abs().max()))
                   for a, b in zip(g_f, g_r))
    check(loss_err <= 1e-4, f"train_exact losses differ by {loss_err}")
    check(norm_err <= 1e-3, f"train_exact grad norms differ by {norm_err}")
    check(grad_err <= 1e-4, f"train_exact gradients differ by {grad_err}")
    out = {"losses_flash": [m["loss"] for m in m_f],
           "losses_reference": [m["loss"] for m in m_r],
           "grad_norms_flash": [m["grad_norm"] for m in m_f],
           "max_loss_err": loss_err, "max_grad_norm_rel_err": norm_err,
           "max_grad_rel_err": grad_err}
    emit("train_exact", tokens=[4, 256], steps=3, **out)
    # The one-process flash step is the mesh phase's reference.
    out["ref_grads"] = [g.cpu() for g in g_f]
    return out


def phase_train(seed: int) -> dict:
    """bf16 flagship through trainer.fit: 20 steps checkpointed every 10,
    then a resumed fit to 24; step timing, a step that must make no host
    sync, and the device's busy share."""
    import tempfile

    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.train import TrainConfig, make_train_step
    from tpu_composer_torch.workload.trainer import fit

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg)
    seq, batch = 512, 8
    docs = zipf_documents(seed, vocab=FLAGSHIP["vocab_size"])
    dataset = PackedLMDataset(docs, seq_len=seq, seed=seed)
    with tempfile.TemporaryDirectory() as cdir:
        t0 = time.perf_counter()
        first = fit(tc, dataset, total_steps=20, global_batch=batch,
                    checkpoint_dir=cdir, checkpoint_every=10, log_every=10,
                    seed=seed)
        fit_s = time.perf_counter() - t0
        second = fit(tc, dataset, total_steps=24, global_batch=batch,
                     checkpoint_dir=cdir, checkpoint_every=10, log_every=2,
                     seed=seed)
    losses = {int(r["step"]): r["loss"] for r in first.history}
    losses.update({int(r["step"]): r["loss"] for r in second.history})
    check(second.resumed_from == 20,
          f"train resumed from {second.resumed_from}, not 20")
    check(all(np.isfinite(v) for v in losses.values()),
          f"train losses not finite: {losses}")
    check(losses[20] < losses[10],
          f"train loss did not fall: {losses[10]} -> {losses[20]}")

    # Step time on the host clock, each step synchronised, from the
    # resumed state on the loader's next batches.
    state, step = second.state, make_train_step(tc)
    loader = ShardedLoader(dataset, batch, device="cuda", prefetch=False)
    loader.load_state_dict({"step": 24})
    batches = iter(loader)
    times = []
    for _ in range(8):
        toks = next(batches)
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, _ = step(state, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - s0) * 1e3)
    p50 = float(np.median(times[2:]))
    toks = next(batches)
    # A step only queues work: any op in it that makes the host wait for
    # the card raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    profile = _device_share(lambda: step(state, toks), n_steps=3)
    tied_head = _tied_head_ab(lambda: step(state, toks))
    out = {"losses": losses, "resumed_from": second.resumed_from,
           "tied_head_device_ms_per_step": tied_head,
           "fit_20_steps_s": fit_s,
           "steps_per_s_logged": [r["steps_per_s"] for r in first.history],
           "step_ms_p50": p50, "step_ms": times, "host_syncs_in_step": 0,
           "tokens_per_s": batch * seq / (p50 / 1e3), "profile": profile}
    emit("train", seq=seq, global_batch=batch, **out)
    return out


def _tied_head_ab(step, n_steps: int = 3) -> dict:
    """Device ms of a train step with the tied head's two routes, in
    turns (upcast, bf16, bf16, upcast): the bf16 operands into an fp32
    output (``aten::mm.dtype``, the port's route on the card) and both
    operands upcast to fp32 first (the route before it)."""
    from tpu_composer_torch.models import transformer
    from tpu_composer_torch.models.quant import resolve

    def upcast(x, embed, dtype):
        return torch.einsum("...d,vd->...v", x.float(),
                            resolve(embed, dtype).float())

    route = transformer._tied_logits
    runs = {"bf16_mm_fp32_out": [], "fp32_upcast": []}
    try:
        for name in ("fp32_upcast", "bf16_mm_fp32_out", "bf16_mm_fp32_out",
                     "fp32_upcast"):
            transformer._tied_logits = upcast if name == "fp32_upcast" \
                else route
            prof = _device_share(step, n_steps=n_steps)
            runs[name].append(prof["device_busy_ms"] / n_steps)
    finally:
        transformer._tied_logits = route
    return runs


def phase_qualify() -> dict:
    from tpu_composer_torch.workload.acceptance import qualify_slice

    res = qualify_slice()
    emit("qualify", **res)
    check(res["attn_impl"] == "flash", f"qualify ran {res['attn_impl']}")
    check("attn_fallback" not in res, "qualify fell back")
    check(np.isfinite(res["train_loss"]), "qualify loss not finite")
    return res


def _first_divergence(got: list, want: list) -> int:
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def _top2_gap(params, cfg, seq: list) -> float:
    """The model's top-2 logit gap for the token after ``seq``."""
    from tpu_composer_torch.models.moe import forward

    with torch.no_grad():
        logits, _ = forward(params, torch.tensor([seq], device=DEVICE), cfg)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def _check_tokens(label: str, got: list, want: list, params, cfg,
                  prompt: list) -> None:
    """Tokens equal, or fail naming the first diverging token and the
    target's top-2 logit gap there (under 1e-4: float drift between
    chunked and stepwise sums, not a logic fault)."""
    if got == want:
        return
    i = _first_divergence(got, want)
    gap = _top2_gap(params, cfg, prompt + want[:i])
    print(f"{label}: first diverging token {i}, target top-2 logit gap "
          f"{gap:.3e}", flush=True)
    check(False, f"{label} diverged from target-only greedy at token {i} "
                 f"(top-2 gap {gap:.3e})")


def _recording_routes(fn):
    """(``fn()``, the experts each routing call chose, (B, S, K) each):
    ``moe._route`` is patched for the call."""
    from tpu_composer_torch.models import moe

    route, seen = moe._route, []

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        seen.append(out[0])
        return out

    moe._route = recording
    try:
        return fn(), seen
    finally:
        moe._route = route


def _moved_choices(routes, other) -> int:
    """(token, layer) pairs whose set of chosen experts differs."""
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(routes, other))


def _moe_ffn_ranged():
    """Patch ``moe._moe_ffn`` to run inside a ``record_function`` range
    named "moe_ffn" (for a profile); returns the restore function."""
    from tpu_composer_torch.models import moe

    inner = moe._moe_ffn

    def ranged(*args, **kw):
        with torch.profiler.record_function("moe_ffn"):
            return inner(*args, **kw)

    moe._moe_ffn = ranged
    return lambda: setattr(moe, "_moe_ffn", inner)


def phase_moe_serve_exact(rng: np.random.Generator, seed: int) -> dict:
    """fp32 MoE flagship, capacity_factor 4.0: the engine (chunked
    admission, K2 decode) against each request's solo generate with
    reference attention."""
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.moe import MoEConfig, init_params
    from tpu_composer_torch.models.serving import ContinuousBatchingEngine

    cfg = MoEConfig(dtype=torch.float32, attn_impl="flash",
                    **{**MOE_FLAGSHIP, "capacity_factor": 4.0})
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device=DEVICE)
    before = _counts()
    eng = ContinuousBatchingEngine(params, cfg, slots=4, num_blocks=128,
                                   block_size=16, blocks_per_row=32,
                                   attn_impl="kernel", prefill_chunk=64)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 64, 131, 256)]
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run()
    launches = _launched(before, ("paged_decode",))
    for req, p in zip(reqs, prompts):
        solo = generate(params, torch.tensor([p], device=DEVICE), ref,
                        max_new_tokens=24)[0].tolist()
        _check_tokens(f"moe_serve_exact request {req.req_id}", req.tokens,
                      solo, params, ref, p)
    check(launches["paged_decode"] > 0,
          f"moe_serve_exact did not launch K2: {launches}")
    check(int(eng.cache.free_top) == 128, "moe_serve_exact pool did not drain")
    emit("moe_serve_exact", requests=len(reqs), tokens_equal=True,
         launches=launches)
    return launches


def phase_moe_serve(rng: np.random.Generator, seed: int) -> dict:
    """bf16 MoE flagship through two chunked-admission engines with a
    shared prefix: a bf16 pool (K2 fp) and an int8 pool (K2 int8)."""
    from tpu_composer_torch.models.decode import decode_chunk, init_kv_cache
    from tpu_composer_torch.models.moe import MoEConfig, init_params

    cfg = MoEConfig(dtype=torch.bfloat16, attn_impl="flash", **MOE_FLAGSHIP)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = init_params(cfg, seed=seed, device=DEVICE)
    Engine = _make_recording_engine()
    new_tokens = 64

    def plain_first_logits(req, kv_quant):
        # Drop-free routing, as the engine's chunks route: an empty dense
        # cache and decode_chunk over the prompt (not prefill, whose
        # capacity rule may drop tokens the chunks keep). The cache is as
        # long as an engine row and the chunks are the engine's (the
        # prefix, then 64 tokens at a time), so the sums run over the
        # same lengths: a router near-tie then resolves the same way.
        start = req.prefix.n_tokens if req.prefix is not None else 0
        cuts = ([0] if start else []) + list(range(start, len(req.prompt),
                                                   64)) + [len(req.prompt)]
        cache = init_kv_cache(ref, 1, max_seq=512, quant=kv_quant,
                              device=DEVICE)
        toks = torch.tensor([req.prompt], device=DEVICE)
        for a, b in zip(cuts, cuts[1:]):
            logits, cache = decode_chunk(params, cache, toks[:, a:b], ref)
        return logits[0, -1].float().cpu()

    results = {}
    for name, kv_quant, kernel, tol in (
            ("bf16", False, "paged_decode", LOGIT_TOL_BF16),
            ("int8", True, "paged_decode_int8", LOGIT_TOL_INT8)):
        before = _counts()
        eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                     blocks_per_row=32, attn_impl="kernel",
                     kv_quant=kv_quant, prefill_chunk=64)
        eng.first_logits = {}
        handle = eng.register_prefix(
            rng.integers(0, cfg.vocab_size, 64).tolist())
        reqs = _submit_all(eng, rng, cfg.vocab_size, seed, new_tokens,
                           prefix=handle)
        stats = _drive(eng)
        launches = _launched(before, (kernel,))
        check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
              f"MoE {name} engine left a request unfinished")
        eng.close_prefix(handle)
        check(int(eng.cache.free_top) == 256,
              f"MoE {name} engine pool did not drain")
        check(launches[kernel] > 0,
              f"MoE {name} engine did not launch {kernel}: {launches}")
        # The int8 pool is held to the plain path over an int8 dense
        # cache (the same quantized K/V). Beside it: its distance from an
        # fp cache, and how many (token, layer) routing choices the int8
        # K/V moved.
        plain = {r.req_id: _recording_routes(
            lambda r=r: plain_first_logits(r, kv_quant)) for r in reqs}
        worst = max(max_err(eng.first_logits[i], logits)
                    for i, (logits, _) in plain.items())
        check(worst <= tol, f"MoE {name} first-token logits off by {worst}")
        check(stats["k2_midflight"]["err"] <= tol,
              f"MoE {name} engine: K2 mid-flight logits off the gather"
              f" path by {stats['k2_midflight']['err']}")
        extra = {}
        if kv_quant:
            fp = {r.req_id: _recording_routes(
                lambda r=r: plain_first_logits(r, False)) for r in reqs}
            extra["first_logit_err_vs_fp_cache"] = max(
                max_err(eng.first_logits[i], fp[i][0]) for i in fp)
            extra["routing_moved_vs_fp_cache"] = sum(
                _moved_choices(plain[i][1], fp[i][1]) for i in fp)
            extra["routing_token_layers"] = sum(
                x.shape[0] * x.shape[1] for _, routes in plain.values()
                for x in routes)
        gen_tokens = sum(len(r.tokens) for r in reqs)
        results[name] = dict(stats, tokens=gen_tokens,
                             tokens_per_s=gen_tokens / stats["wall_s"],
                             launches=launches, first_logit_err=worst,
                             tol=tol, **extra)
        emit("moe_serve", engine=name, **results[name])
        if name != "bf16":
            continue
        # The device's share of a decode step, 8 requests in 8 slots, and
        # the MoE FFN's part of it.
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab_size, 128).tolist(), 64)
        while eng._waiting or eng._admitting:
            eng.step()
        restore = _moe_ffn_ranged()
        try:
            results["profile"] = _device_share(eng.step, ranges=("moe_ffn",))
        finally:
            restore()
        emit("moe_serve_profile", **results["profile"])
        eng.run()
    return results


def phase_speculative(rng: np.random.Generator, seed: int) -> dict:
    """fp32 MoE flagship (prefill through K1) verified against its
    int8-quantized self, dense and paged caches, against target-only
    greedy generate."""
    import warnings

    from tpu_composer_torch.models import speculative as spec
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.moe import MoEConfig, init_params
    from tpu_composer_torch.models.quant import quantize_decode_params

    cfg = MoEConfig(dtype=torch.float32, attn_impl="flash", **MOE_FLAGSHIP)
    params = init_params(cfg, seed=seed, device=DEVICE)
    draft = quantize_decode_params(params)
    gamma, new, max_seq = 4, 64, 512

    # Count verify rounds per call (the loop is the port's own).
    loop, rounds = spec._speculative_loop, []

    def counted(*args, verify, **kw):
        calls = [0]

        def counting_verify(cache, chunk):
            calls[0] += 1
            return verify(cache, chunk)

        out = loop(*args, verify=counting_verify, **kw)
        rounds.append(calls[0])
        return out

    runs = {
        "generate": lambda p: generate(params, p, cfg, max_new_tokens=new,
                                       max_seq=max_seq),
        "dense": lambda p: spec.speculative_generate(
            params, draft, p, cfg, max_new_tokens=new, gamma=gamma,
            max_seq=max_seq),
        "paged": lambda p: spec.paged_speculative_generate(
            params, draft, p, cfg, num_blocks=32, block_size=16,
            max_new_tokens=new, gamma=gamma),
    }
    seconds = {k: 0.0 for k in runs}
    per_round = {"dense": [], "paged": []}
    before = _counts()
    spec._speculative_loop = counted
    try:
        for n in (32, 100, 200):
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            p = torch.tensor([prompt], device=DEVICE)
            out = {}
            for name, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = run(p)[0].tolist()
                torch.cuda.synchronize()
                seconds[name] += time.perf_counter() - t0
                if name != "generate":
                    per_round[name].append(rounds[-1])
            for name in ("dense", "paged"):
                _check_tokens(f"speculative {name} (prompt {n})", out[name],
                              out["generate"], params, cfg, prompt)
        # Host syncs of one call each, on the shortest prompt: every one
        # the sync debug mode reports.
        syncs = {}
        p = torch.tensor([rng.integers(0, cfg.vocab_size, 32).tolist()],
                         device=DEVICE)
        for name in ("dense", "paged"):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    runs[name](p)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs[name] = {"syncs": sum("synchroniz" in str(w.message)
                                        for w in seen),
                           "rounds": rounds[-1]}
    finally:
        spec._speculative_loop = loop
    launches = _launched(before, ("flash_fwd",))
    check(launches["flash_fwd"] > 0, "speculative did not launch K1")
    tokens = 3 * new
    out = {"gamma": gamma, "prompts": [32, 100, 200], "new_tokens": new,
           "tokens_equal": True, "launches": launches,
           "rounds": per_round,
           # Each round accepts a drafts and adds a + 1 tokens: the
           # drafts accepted are new − 1 − rounds (the last round's
           # overshoot aside), over rounds × gamma proposed.
           "acceptance": {k: sum(new - 1 - r for r in v) / (gamma * sum(v))
                          for k, v in per_round.items()},
           "tokens_per_s": {k: tokens / v for k, v in seconds.items()},
           "host_syncs": syncs}
    emit("speculative", **out)
    return out


def phase_train_moe(seed: int) -> dict:
    """fp32 MoE flagship, flash against reference attention over 3 steps;
    then bf16 at seq 512, batch 8, 12 steps on packed Zipf documents."""
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
        tree_leaves,
    )

    vocab = MOE_FLAGSHIP["vocab_size"]
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, vocab, (4, 256), generator=gen,
                             dtype=torch.int32).to(DEVICE)
               for _ in range(3)]
    losses, top1 = {}, {}
    for impl in ("flash", "reference"):
        cfg = moe.MoEConfig(dtype=torch.float32, attn_impl=impl,
                            **MOE_FLAGSHIP)
        tc = TrainConfig(model=cfg)
        state = make_train_state(tc, seed, DEVICE)
        with torch.no_grad():  # the first batch's top-1 experts
            _, seen = _recording_routes(
                lambda: moe.forward(state["params"], batches[0], cfg))
        top1[impl] = [x[..., 0] for x in seen]
        step = make_train_step(tc)
        losses[impl] = [float(step(state, toks)[1]["loss"])
                        for toks in batches]
    flips = sum(int((a != b).sum())
                for a, b in zip(top1["flash"], top1["reference"]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["flash"], losses["reference"]))
    check(rel <= 1e-3, f"train_moe fp32 losses differ by {rel} relative")
    exact = {"ref_top1": [x.cpu() for x in top1["flash"]],
             "losses_flash": losses["flash"],
             "losses_reference": losses["reference"],
             "max_loss_rel_err": rel, "top1_expert_flips": flips,
             "routed_tokens": 4 * 256 * len(top1["flash"])}

    cfg = moe.MoEConfig(dtype=torch.bfloat16, attn_impl="flash",
                        **MOE_FLAGSHIP)
    tc = TrainConfig(model=cfg)
    seq, batch = 512, 8
    dataset = PackedLMDataset(zipf_documents(seed, vocab=vocab), seq_len=seq,
                              seed=seed)
    loader = iter(ShardedLoader(dataset, batch, device=DEVICE,
                                prefetch=False))
    state, step = make_train_state(tc, seed, DEVICE), make_train_step(tc)
    bf16_losses, times = [], []
    for _ in range(12):
        toks = next(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bf16_losses.append(float(m["loss"]))
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(state["params"]))
    check(finite and all(np.isfinite(bf16_losses)),
          f"train_moe bf16 not finite: {bf16_losses}")
    check(bf16_losses[-1] < bf16_losses[0],
          f"train_moe loss did not fall: {bf16_losses[0]} -> "
          f"{bf16_losses[-1]}")
    p50 = float(np.median(times[2:]))
    ref_top1 = exact.pop("ref_top1")
    out = {"exact": exact, "losses_bf16": bf16_losses, "step_ms": times,
           "step_ms_p50": p50, "tokens_per_s": batch * seq / (p50 / 1e3)}
    emit("train_moe", seq=seq, global_batch=batch, **out)
    out["ref_top1"] = ref_top1
    return out


# The multi-rank phase (mesh_train): worlds of ranks spawned on the one
# card, over gloo (NCCL refuses two ranks on one GPU), every collective
# staged through the host. A collective that waits longer than the
# group's timeout raises; a world that has not reported by its deadline
# is killed and fails the phase.
MESH_GROUP_TIMEOUT_S = 120
MESH_DEADLINE_S = 600
# (label, task, mesh axes, sp_impl, sp_inner) per world.
MESH_WORLD_2 = (
    ("sp2_ring_flash", "dense_exact", {"sp": 2}, "ring", "flash"),
    ("sp2_zigzag_flash", "dense_exact", {"sp": 2}, "zigzag", "flash"),
    ("sp2_ulysses_flash", "dense_exact", {"sp": 2}, "ulysses", "flash"),
    ("sp2_ring_einsum", "dense_exact", {"sp": 2}, "ring", "einsum"),
    ("tp2", "dense_exact", {"tp": 2}, "ring", "einsum"),
    ("dp2", "dense_exact", {"dp": 2}, "ring", "einsum"),
    ("moe_ep2", "moe_exact", {"ep": 2}, "ring", "einsum"),
    ("run_sp2_ring_flash", "run", {"sp": 2}, "ring", "flash"),
)
MESH_WORLD_4 = (
    ("sp4_zigzag_flash", "dense_exact", {"sp": 4}, "zigzag", "flash"),
    ("moe_ep2_sp2_ulysses_flash", "moe_exact", {"ep": 2, "sp": 2},
     "ulysses", "flash"),
)


def _mesh_dense_exact(dev, ref, axes, sp_impl, sp_inner) -> dict:
    """The fp32 flagship over ``axes``: the first batch's gradients,
    gathered to rank 0 and held there against the one-process flash
    step's, then 3 AdamW steps from the same params."""
    import torch.distributed as dist

    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        gather_params,
        make_grad_fn,
        make_train_state,
        make_train_step,
        tree_leaves,
        tree_unflatten,
    )

    cfg = ModelConfig(dtype=torch.float32, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner)
    mesh = make_mesh(axes, dev.type)
    batches = [b.to(dev) for b in ref["batches"]]
    state = make_train_state(tc, ref["seed"], dev, mesh)
    _, grads, _ = make_grad_fn(tc, mesh)(state["params"], batches[0])
    full = gather_params(tc, tree_unflatten(state["params"], grads), mesh)
    grad_err = None
    if dist.get_rank() == 0:
        grad_err = max(max_err(g, r.to(dev)) / max(1.0, float(r.abs().max()))
                       for g, r in zip(tree_leaves(full), ref["grads"]))
    del full, grads
    step = make_train_step(tc, mesh)
    losses, norms = [], []
    for toks in batches:
        state, m = step(state, toks)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "grad_err": grad_err}


def _mesh_moe_exact(dev, ref, axes, sp_impl, sp_inner) -> dict:
    """The fp32 MoE flagship over ``axes``: the top-1 experts of this
    rank's rows of the first batch, against the one-process model's, and
    3 AdamW steps from the same params."""
    from tpu_composer_torch.models import moe
    from tpu_composer_torch.parallel import train
    from tpu_composer_torch.parallel.mesh import axis_size, make_mesh

    cfg = moe.MoEConfig(dtype=torch.float32, attn_impl="flash",
                        **MOE_FLAGSHIP)
    tc = train.TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner)
    mesh = make_mesh(axes, dev.type)
    batches = [b.to(dev) for b in ref["moe_batches"]]
    state = train.make_train_state(tc, ref["seed"], dev, mesh)
    attn = (train._sp_attn_fn(mesh, sp_impl, sp_inner, cfg.n_heads)
            if axis_size(mesh, "sp") > 1 else None)
    rows = train.local_batch(tc, batches[0], mesh)
    with torch.no_grad():
        _, seen = _recording_routes(
            lambda: moe.forward(state["params"], rows, cfg, attn, mesh))
    n, index = train.data_shards(tc, mesh), train.data_index(tc, mesh)
    want = [t.chunk(n)[index].to(dev) for t in ref["moe_top1"]]
    flips = sum(int((x[..., 0] != w).sum()) for x, w in zip(seen, want))
    step = train.make_train_step(tc, mesh)
    losses = [float(step(state, toks)[1]["loss"]) for toks in batches]
    return {"losses": losses, "rows": index, "top1_flips": flips}


def _mesh_run(dev, ref, axes, sp_impl, sp_inner, steps: int = 12) -> dict:
    """The bf16 flagship over ``axes`` at seq 512, global batch 8, on
    packed Zipf documents: losses, step times on the host clock (each
    step synchronised), kernel launches a step."""
    from tpu_composer_torch.data import PackedLMDataset, ShardedLoader
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.mesh import make_mesh
    from tpu_composer_torch.parallel.train import (
        TrainConfig,
        make_train_state,
        make_train_step,
    )

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg, sp_impl=sp_impl, sp_inner=sp_inner)
    mesh = make_mesh(axes, dev.type)
    seq, batch = 512, 8
    dataset = PackedLMDataset(zipf_documents(ref["seed"],
                                             vocab=FLAGSHIP["vocab_size"]),
                              seq_len=seq, seed=ref["seed"])
    loader = iter(ShardedLoader(dataset, batch, device=dev, prefetch=False))
    state = make_train_state(tc, ref["seed"], dev, mesh)
    step = make_train_step(tc, mesh)
    before = _counts()
    losses, times = [], []
    for _ in range(steps):
        toks = next(loader)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, toks)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    after = _counts()
    return {"losses": losses, "step_ms": times,
            "step_ms_p50": float(np.median(times[2:])),
            "launches_per_step": {k: (after[k] - before[k]) / steps
                                  for k in after},
            "seq": seq, "global_batch": batch}


_MESH_TASKS = {"dense_exact": _mesh_dense_exact,
               "moe_exact": _mesh_moe_exact, "run": _mesh_run}


def _mesh_rank(rank, world, init, device, tasks, ref_path, go,
               results) -> None:
    """One rank of a spawned world: joins the gloo group, waits for
    ``go``, runs ``tasks`` and sends the parent its results (or its
    traceback). It prints nothing to stdout."""
    import traceback

    import torch.distributed as dist

    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        sys.path.insert(0, HERE)
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from tpu_composer_torch.parallel.mesh import init_world

        dev = init_world("gloo", rank, world, init, device,
                         timeout_s=MESH_GROUP_TIMEOUT_S)
        if not go.wait(MESH_DEADLINE_S):
            raise RuntimeError("the parent never started this world")
        ref = torch.load(ref_path, weights_only=True)
        _reset_counts()
        out = {}
        for label, kind, axes, sp_impl, sp_inner in tasks:
            t0 = time.perf_counter()
            out[label] = _MESH_TASKS[kind](dev, ref, axes, sp_impl, sp_inner)
            out[label]["s"] = time.perf_counter() - t0
            out[label]["transport"] = dist.get_backend()
        out["launches"] = _counts()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _World:
    """``n`` spawned ranks of ``_mesh_rank``, started at once; ``join``
    collects their results or fails, and never leaves one running."""

    def __init__(self, n: int, tasks, ref_path: str, workdir: str):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.go, self.results = n, ctx.Event(), ctx.Queue()
        init = f"file://{workdir}/world{n}"
        self.procs = [ctx.Process(target=_mesh_rank, args=(
            r, n, init, DEVICE, tasks, ref_path, self.go, self.results))
            for r in range(n)]
        for p in self.procs:
            p.start()

    def join(self, deadline_s: float = MESH_DEADLINE_S) -> list:
        import queue

        self.go.set()
        got, deadline, dead_since = {}, time.monotonic() + deadline_s, None
        try:
            while len(got) < self.n:
                missing = sorted(set(range(self.n)) - set(got))
                check(time.monotonic() < deadline,
                      f"world of {self.n}: ranks {missing} did not report"
                      f" within {deadline_s} s")
                try:
                    rank, err, out = self.results.get(timeout=2)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if not p.is_alive() and r not in got]
                    if dead and dead_since is None:
                        dead_since = time.monotonic()
                    check(not dead or time.monotonic() - dead_since < 10,
                          f"world of {self.n}: ranks {dead} exited without"
                          " a result")
                    continue
                check(err is None,
                      f"world of {self.n}: rank {rank} failed:\n{err}")
                got[rank] = out
        finally:
            for p in self.procs:
                p.join(timeout=30 if len(got) == self.n else 0)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [got[r] for r in range(self.n)]


def phase_mesh_train(seed: int, exact: dict, moe_exact: dict) -> dict:
    """The multi-rank training step on the one card: a world of 2 ranks
    and one of 4 over gloo, each rank on the card. The fp32 flagship over
    each mesh of ``MESH_WORLD_2``/``MESH_WORLD_4`` against the
    one-process flash step (``train_exact``), the fp32 MoE flagship
    against ``train_moe``'s, and a bf16 run. Returns the worlds' launch
    counts, summed over ranks."""
    import tempfile

    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randint(0, FLAGSHIP["vocab_size"], (4, 256),
                             generator=gen, dtype=torch.int32)
               for _ in range(3)]
    gen = torch.Generator().manual_seed(seed)
    moe_batches = [torch.randint(0, MOE_FLAGSHIP["vocab_size"], (4, 256),
                                 generator=gen, dtype=torch.int32)
                   for _ in range(3)]
    with tempfile.TemporaryDirectory() as workdir:
        ref_path = os.path.join(workdir, "ref.pt")
        torch.save({"seed": seed, "batches": batches,
                    "grads": exact["ref_grads"], "moe_batches": moe_batches,
                    "moe_top1": moe_exact["ref_top1"]}, ref_path)
        t0 = time.perf_counter()
        worlds = {2: _World(2, MESH_WORLD_2, ref_path, workdir),
                  4: _World(4, MESH_WORLD_4, ref_path, workdir)}
        # The world of 4 starts up beside the world of 2 and waits for it.
        results = {n: worlds[n].join() for n in (2, 4)}
        wall = time.perf_counter() - t0

    out, counts = {"wall_s": wall}, {}
    for n, tasks in ((2, MESH_WORLD_2), (4, MESH_WORLD_4)):
        ranks = results[n]
        for r in ranks:
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v
        for label, kind, axes, sp_impl, sp_inner in tasks:
            per_rank = [r[label] for r in ranks]
            rec = {"world": n, "mesh": axes, "sp_impl": sp_impl,
                   "sp_inner": sp_inner, "s": max(x["s"] for x in per_rank),
                   "transport": per_rank[0]["transport"] + " (host-staged)"}
            if kind == "dense_exact":
                got = per_rank[0]
                rec["losses"], rec["grad_norms"] = got["losses"], \
                    got["grad_norms"]
                rec["loss_rel_err"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(got["losses"], exact["losses_flash"]))
                rec["grad_norm_rel_err"] = max(
                    abs(a - b) / b for a, b in zip(got["grad_norms"],
                                                   exact["grad_norms_flash"]))
                rec["grad_rel_err"] = got["grad_err"]
                check(rec["loss_rel_err"] <= 1e-4,
                      f"mesh {label}: losses off by {rec['loss_rel_err']}")
                check(rec["grad_norm_rel_err"] <= 1e-3,
                      f"mesh {label}: grad norms off by"
                      f" {rec['grad_norm_rel_err']}")
                check(rec["grad_rel_err"] <= 1e-4,
                      f"mesh {label}: step-1 gradients off by"
                      f" {rec['grad_rel_err']}")
            elif kind == "moe_exact":
                got = per_rank[0]
                rec["losses"] = got["losses"]
                rec["loss_rel_err"] = max(
                    abs(a - b) / abs(b)
                    for a, b in zip(got["losses"],
                                    moe_exact["exact"]["losses_flash"]))
                # Ranks that share rows (sp, tp) route them alike: count
                # each row block once.
                rec["top1_flips"] = sum(
                    {x["rows"]: x["top1_flips"] for x in per_rank}.values())
                check(rec["loss_rel_err"] <= 1e-3,
                      f"mesh {label}: MoE losses off by"
                      f" {rec['loss_rel_err']}")
            else:
                losses = per_rank[0]["losses"]
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      f"mesh {label}: losses {losses}")
                rec["losses"] = losses
                rec["per_rank"] = [
                    {"step_ms_p50": x["step_ms_p50"],
                     "launches_per_step": {
                         k: x["launches_per_step"][k]
                         for k in ("flash_fwd_lse", "flash_bwd_dq",
                                   "flash_bwd_dkv")}} for x in per_rank]
                check(all(v > 0 for x in rec["per_rank"]
                          for v in x["launches_per_step"].values()),
                      f"mesh {label}: a rank launched no flash kernel")
            out[label] = rec
            emit("mesh_train", check=label, **rec)
    out["launches"] = counts
    return out


def phase_mesh_nccl(seed: int) -> dict:
    """A world of one rank over NCCL: ``make_mesh`` over the card and
    ``fit`` 3 steps with it give the meshless ``fit``'s losses bit for
    bit; the allreduce probe over one device reports 0.0."""
    import tempfile

    import torch.distributed as dist

    from tpu_composer_torch.data import PackedLMDataset
    from tpu_composer_torch.examples.train_lm import zipf_documents
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.parallel.collectives import (
        allreduce_bandwidth_gbps,
    )
    from tpu_composer_torch.parallel.mesh import init_world, make_mesh
    from tpu_composer_torch.parallel.train import TrainConfig
    from tpu_composer_torch.workload.trainer import fit

    cfg = ModelConfig(dtype=torch.bfloat16, attn_impl="flash", **FLAGSHIP)
    tc = TrainConfig(model=cfg)
    dataset = PackedLMDataset(zipf_documents(seed,
                                             vocab=FLAGSHIP["vocab_size"]),
                              seq_len=512, seed=seed)
    with tempfile.TemporaryDirectory() as workdir:
        init_world("nccl", 0, 1, f"file://{workdir}/nccl", DEVICE)
        try:
            mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, "cuda")
            backend = dist.get_backend()
            meshed = fit(tc, dataset, total_steps=3, global_batch=8,
                         log_every=1, seed=seed, device=DEVICE, mesh=mesh)
            busbw = allreduce_bandwidth_gbps(mesh)
        finally:
            dist.destroy_process_group()
    plain = fit(tc, dataset, total_steps=3, global_batch=8, log_every=1,
                seed=seed, device=DEVICE)
    got = [r["loss"] for r in meshed.history]
    want = [r["loss"] for r in plain.history]
    check(got == want, f"NCCL world-1 fit losses {got} != meshless {want}")
    check(busbw == 0.0, f"allreduce probe on one device: {busbw}")
    out = {"transport": backend, "losses": got, "losses_meshless": want,
           "allreduce_gbps": busbw}
    emit("mesh_nccl", **out)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpu_composer_torch")):
        print("chip_smoke: tpu_composer_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # fp32 reference matmuls in full fp32, on both library paths.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    seconds = {}

    def timed_phase(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed_phase("card", phase_card)
    timed_phase("build", phase_build)
    flash = timed_phase("flash_fwd", phase_flash, gen)
    paged = timed_phase("paged_decode", phase_paged, gen)
    bwd = timed_phase("flash_bwd", phase_flash_bwd, gen)

    # Each main path: every count is set to 0 just before its phases run
    # and read just after; each of the path's kernels must have launched.
    # The multi-rank path's kernels run in its spawned ranks, which count
    # their own launches from 0 and report them.
    done, paths = {}, {}
    seed = args.seed
    train_kernels = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    for name, kernels, phases in (
            ("serving", ("flash_fwd", "paged_decode", "paged_decode_int8"),
             (("serve_exact", lambda: phase_serve_exact(rng, seed)),
              ("serve", lambda: phase_serve(rng, seed)))),
            ("moe_serving", ("paged_decode", "paged_decode_int8"),
             (("moe_serve_exact", lambda: phase_moe_serve_exact(rng, seed)),
              ("moe_serve", lambda: phase_moe_serve(rng, seed)))),
            ("speculative", ("flash_fwd",),
             (("speculative", lambda: phase_speculative(rng, seed)),)),
            ("training", train_kernels,
             (("train_exact", lambda: phase_train_exact(seed)),
              ("train", lambda: phase_train(seed)),
              ("qualify", phase_qualify))),
            ("moe_training", train_kernels,
             (("train_moe", lambda: phase_train_moe(seed)),)),
            ("mesh_training", train_kernels,
             (("mesh_train", lambda: phase_mesh_train(
                 seed, done["train_exact"], done["train_moe"])),
              ("mesh_nccl", lambda: phase_mesh_nccl(seed))))):
        _reset_counts()
        for phase_name, fn in phases:
            done[phase_name] = timed_phase(phase_name, fn)
        paths[name] = _counts()
        if name == "mesh_training":
            for k, v in done["mesh_train"]["launches"].items():
                paths[name][k] += v
        check(all(paths[name][k] > 0 for k in kernels),
              f"a kernel of the {name} path was never launched:"
              f" {paths[name]}")
    emit("timing", wall_s=time.perf_counter() - t_start, phase_s=seconds)
    emit("launches", **paths)

    def row(name, source, replaces, function, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "function": function,
                "launches": sum(c[name] for c in paths.values()),
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "issue_ms": t["issue_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("flash_fwd", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:189",
            "attention.py::_fwd_kernel_nolse", flash),
        row("flash_fwd_lse", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:83",
            "attention.py::_fwd_kernel", bwd["flash_fwd_lse"]),
        row("flash_bwd_dq", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:285",
            "attention.py::_dq_kernel", bwd["flash_bwd_dq"]),
        row("flash_bwd_dkv", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:324",
            "attention.py::_dkv_kernel", bwd["flash_bwd_dkv"]),
        row("paged_decode", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:49",
            "paged_attention.py::_kernel", paged["bf16"]),
        row("paged_decode_int8", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:41",
            "paged_attention.py::_kernel_quant", paged["int8_q_bf16"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
