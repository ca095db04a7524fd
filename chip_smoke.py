#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and hold every CUDA kernel of those paths against its plain PyTorch
version.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the ``tpu_composer_torch`` package beside
this file; it exits nonzero without them. Each phase prints one JSON
line and checks its own result; any failure raises and the script exits
nonzero. Phases, in order:

1. ``card``: the card, its power limit, torch and CUDA versions. The
   raw ``nvidia-smi --query-gpu=name,power.limit`` line follows it.
2. ``build``: nvcc seconds per kernel source (all three compile at once)
   and ptxas's register / shared-memory report.
3. ``flash_fwd``: kernel K1 against its plain version over B in {1, 2},
   S in {8, 64, 256, 512}, H=8, KV=2, D=64, causal or not, bf16 (at both
   CTA heights, 16 and 64 rows) and fp32, with and without lse; times at
   the serving prefill shape, with the CTA height ``_fwd_rows`` picks
   there and both heights.
4. ``paged_decode``: kernel K2 against the gather path at the engine's
   decode shape (B=8, H=8, KV=2, Dh=64, Bs=16, MB=32), lengths in
   1..512 plus a 0-length row and stale table slots; fp32, bf16, int8.
5. ``flash_bwd``: kernels B3 (dQ) and B4 (dK/dV) against
   ``flash_bwd_plain`` over B in {1, 2}, S in {8, 64, 256, 512} at D=64
   and S=100 at D=128, H=8 over KV in {2, 8}, causal or not, fp32 and
   bf16, with and without an lse cotangent, each case checked on its
   own, bf16 GQA cases with B4's group split across CTAs and not; then K1
   with lse, B3 and B4 against their plain versions on the path's own
   inputs: the training shape (8, 512, 8, 2, 64, bf16, causal) and
   ``qualify_slice``'s MHA shape (8, 512, 8, 8, 64); B4 launched twice
   on the training-shape inputs must give the same bits; the geometry
   chosen (CTA height, group split, CTA counts) and times at the
   training shape.
6. ``serve_exact``: the flagship at full width in fp32, prefill through
   K1 and decode through K2: every request's tokens equal the port's
   solo ``generate`` with reference attention.
7. ``serve``: the flagship in bf16: 16 greedy and sampled requests
   through an 8-slot engine, then an int8-pool engine with chunked
   admission and a shared prefix; tokens/s, step p50, launch counts.
8. ``train_exact``: the flagship in fp32, 3 AdamW steps on (4, 256)
   tokens with flash attention (K1 with lse, B3, B4) and 3 with
   reference attention from the same params: losses, grad norms and the
   first step's gradients agree.
9. ``train``: the flagship in bf16 through ``trainer.fit`` on packed
   synthetic Zipf documents (seq 512, batch 8): 20 steps checkpointed
   every 10, then a resumed ``fit`` to 24; tokens/s, step p50, one step
   under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the
   step fails the phase) and the device's busy share.
10. ``qualify``: ``qualify_slice()`` at its defaults.
11. ``timing`` (the whole run's seconds, builds included) and
    ``launches`` (per path); then the kernels line ``{"kernels": [...]}``:
    per kernel its launches on its main path (serving: phases 6-7;
    training: phases 8-10), max error, kernel / plain / library ms
    (device time), the kernel's issue ms, and the bound.
12. the last line: ``{"ok": true, "device": {...}}``.

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
5e-2; of the int8-pool engine against an unquantized prefill 1e-1.
``train_exact``: losses 1e-4, grad norms 1e-3 relative, gradients 1e-4
relative to max(1, max|ref|) (flash against reference attention, fp32).
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


def phase_build() -> None:
    from tpu_composer_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build(["flash_fwd", "paged_decode", "flash_bwd"])
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for name, (_, log) in _build.build_log.items()}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         ptxas=ptxas)


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


def _paged_inputs(gen: torch.Generator, dtype, quant: bool, dh: int = 64):
    """Engine decode shape: 8 rows over a 256-block pool of 16 positions,
    32 table slots per row. Row 0 has length 0; the rest draw lengths in
    1..512. Owned slots hold distinct ids; the slots past each row's
    blocks hold stale ids that may name other rows' blocks."""
    from tpu_composer_torch.models.decode import quantize_kv

    b, h, kv, bs, mb, n = 8, 8, 2, 16, 32, 256
    lengths = torch.randint(1, mb * bs + 1, (b,), generator=gen)
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
        paged_decode_cuda,
        paged_decode_plain,
    )

    # The flagship's head_dim 64, and the kernel's other head_dim, 128.
    cases = {"fp32": (torch.float32, False, 64),
             "bf16": (torch.bfloat16, False, 64),
             "int8_q_fp32": (torch.float32, True, 64),
             "int8_q_bf16": (torch.bfloat16, True, 64),
             "bf16_dh128": (torch.bfloat16, False, 128),
             "int8_q_fp32_dh128": (torch.float32, True, 128)}
    errs, timing = {}, {}
    for name, (dtype, quant, dh) in cases.items():
        worst = 0.0
        for _ in range(3):
            args = _paged_inputs(gen, dtype, quant, dh)
            got = paged_decode_cuda(*args)
            want = paged_decode_plain(*args)
            torch.cuda.synchronize()
            check(bool((got[0] == 0).all()), f"paged {name}: 0-length row")
            worst = max(worst, max_err(got, want))
        errs[name] = worst
        check(worst <= TOL[dtype], f"paged_decode {name} error {worst}")
        if name in ("bf16", "int8_q_bf16"):
            t = {**timings(lambda: paged_decode_cuda(*args),
                           lambda: paged_decode_plain(*args)),
                 "max_abs_err": worst, "lengths": args[4].tolist()}
            t["bound_ms"], t["bound_by"] = _paged_bound(args)
            timing[name] = t
    emit("paged_decode", errors=errs,
         tol={"fp32": 1e-4, "bf16": 2e-2}, shape=[8, 8, 2, 64, 16, 32, 256],
         timing=timing)
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

    # B4 twice on the training-shape inputs: the same bits (the split
    # partials are summed in a fixed order, no atomics).
    delta = _delta(out, do)
    b, s, h, kv, d = shape
    split = _dkv_split(b, kv, h // kv, s)
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
    rows = _fwd_rows(b, h, s)
    emit("flash_bwd", errors=errs, tol={"fp32": 1e-4, "bf16": 3e-2,
                                        "relative_to": "max|ref| per gradient",
                                        "flash_fwd_lse": [TOL[dtype], LSE_TOL]},
         shape=list(shape), dtype="bfloat16", causal=True,
         geometry={"flash_fwd_rows": rows,
                   "flash_fwd_ctas": b * h * -(-s // rows),
                   "flash_bwd_dkv_split": split,
                   "flash_bwd_dkv_ctas": b * kv * -(-s // 64) * split},
         dkv_bitwise_repeatable=True, timing=timing)
    return timing


FLAGSHIP = dict(vocab_size=8192, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=2, d_ff=1408, max_seq=512)


def _counts() -> dict:
    from tpu_composer_torch.ops.attention import flash_fwd_cuda
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    return {"flash_fwd": flash_fwd_cuda.launches,
            "paged_decode": paged_decode_cuda.launches}


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
    after = _counts()
    launches = {k: after[k] - before[k] for k in after}
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


def _drive(eng) -> dict:
    """Run the engine to completion, timing every step on the host clock
    (each step ends in a host read of the picked tokens)."""
    steps, decode_only = [], []
    t0 = time.perf_counter()
    while eng._waiting or any(r is not None for r in eng._slot_req):
        quiet = not eng._waiting and not eng._admitting
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - s0) * 1e3
        steps.append(dt)
        if quiet:
            decode_only.append(dt)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "steps": len(steps),
            "step_ms_p50": float(np.median(steps)),
            "decode_step_ms_p50": (float(np.median(decode_only))
                                   if decode_only else None)}


def _device_share(step, n_steps: int = 8) -> dict:
    """Device busy share over a few calls of ``step`` (torch.profiler):
    summed kernel time over host wall time, and the kernels that take
    it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
                              e.count] for e in ours]}


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
        reqs = []
        for i in range(16):
            n = int(rng.integers(16, 257))
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            if prefix is not None and i % 2 == 0:
                prompt = prefix.tokens + prompt
                kw = {"prefix": prefix}
            else:
                kw = {}
            if i % 2:
                kw.update(temperature=0.8, top_k=50, top_p=0.95, seed=seed + i)
            reqs.append(eng.submit(prompt, new_tokens, **kw))
        return reqs

    results = {}
    # Engine A: bucketed admission (prefill through K1), bf16 pool (K2).
    before = _counts()
    eng = Engine(params, cfg, slots=8, num_blocks=256, block_size=16,
                 blocks_per_row=32, attn_impl="kernel")
    eng.first_logits = {}
    reqs = submit_all(eng)
    stats = _drive(eng)
    after = _counts()
    launches = {k: after[k] - before[k] for k in after}
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "bf16 engine left a request unfinished")
    check(int(eng.cache.free_top) == 256, "bf16 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"bf16 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_BF16, f"bf16 first-token logits off by {worst}")
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
    after = _counts()
    launches = {k: after[k] - before[k] for k in after}
    check(all(r.done and len(r.tokens) == new_tokens for r in reqs),
          "int8 engine left a request unfinished")
    eng.close_prefix(handle)
    check(int(eng.cache.free_top) == 256, "int8 engine pool did not drain")
    check(all(n > 0 for n in launches.values()),
          f"int8 engine did not launch every kernel: {launches}")
    worst = max(max_err(eng.first_logits[r.req_id],
                        plain_first_logits(r.prompt)) for r in reqs)
    check(worst <= LOGIT_TOL_INT8, f"int8 first-token logits off by {worst}")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    results["int8"] = dict(stats, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / stats["wall_s"],
                           launches=launches, first_logit_err=worst)
    emit("serve", engine="int8_chunked_prefix", **results["int8"])
    return results


def _train_counts() -> dict:
    from tpu_composer_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )

    return {"flash_fwd_lse": flash_fwd_cuda.launches_lse,
            "flash_bwd_dq": flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": flash_bwd_dkv_cuda.launches}


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
    out = {"losses": losses, "resumed_from": second.resumed_from,
           "fit_20_steps_s": fit_s,
           "steps_per_s_logged": [r["steps_per_s"] for r in first.history],
           "step_ms_p50": p50, "step_ms": times, "host_syncs_in_step": 0,
           "tokens_per_s": batch * seq / (p50 / 1e3), "profile": profile}
    emit("train", seq=seq, global_batch=batch, **out)
    return out


def phase_qualify() -> dict:
    from tpu_composer_torch.workload.acceptance import qualify_slice

    res = qualify_slice()
    emit("qualify", **res)
    check(res["attn_impl"] == "flash", f"qualify ran {res['attn_impl']}")
    check("attn_fallback" not in res, "qualify fell back")
    check(np.isfinite(res["train_loss"]), "qualify loss not finite")
    return res


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
    card = phase_card()
    phase_build()
    flash = phase_flash(gen)
    paged = phase_paged(gen)
    bwd = phase_flash_bwd(gen)

    from tpu_composer_torch.ops.attention import (
        flash_bwd_dkv_cuda,
        flash_bwd_dq_cuda,
        flash_fwd_cuda,
    )
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    def reset_counts():
        flash_fwd_cuda.launches = flash_fwd_cuda.launches_lse = 0
        paged_decode_cuda.launches = 0
        flash_bwd_dq_cuda.launches = flash_bwd_dkv_cuda.launches = 0

    # The serving path: every count starts at 0 here and is read after it.
    reset_counts()
    phase_serve_exact(rng, args.seed)
    serve = phase_serve(rng, args.seed)
    flash_launches = flash_fwd_cuda.launches
    paged_int8 = serve["int8"]["launches"]["paged_decode"]
    paged_fp = paged_decode_cuda.launches - paged_int8
    check(flash_launches > 0 and paged_fp > 0 and paged_int8 > 0,
          "a kernel of the serving path was never launched")

    # The training path, counted the same way.
    reset_counts()
    phase_train_exact(args.seed)
    phase_train(args.seed)
    phase_qualify()
    train_launches = _train_counts()
    check(all(n > 0 for n in train_launches.values()),
          f"a kernel of the training path was never launched:"
          f" {train_launches}")
    emit("timing", wall_s=time.perf_counter() - t_start)
    emit("launches", serving={"flash_fwd": flash_launches,
                              "paged_decode": paged_fp,
                              "paged_decode_int8": paged_int8},
         training=train_launches)

    def row(name, source, replaces, function, launches, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "function": function,
                "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "issue_ms": t["issue_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("flash_fwd", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:189",
            "attention.py::_fwd_kernel_nolse", flash_launches, flash),
        row("flash_fwd_lse", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:83",
            "attention.py::_fwd_kernel", train_launches["flash_fwd_lse"],
            bwd["flash_fwd_lse"]),
        row("flash_bwd_dq", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:285",
            "attention.py::_dq_kernel", train_launches["flash_bwd_dq"],
            bwd["flash_bwd_dq"]),
        row("flash_bwd_dkv", "tpu_composer_torch/csrc/flash_bwd.cu",
            "tpu_composer/ops/attention.py:324",
            "attention.py::_dkv_kernel", train_launches["flash_bwd_dkv"],
            bwd["flash_bwd_dkv"]),
        row("paged_decode", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:49",
            "paged_attention.py::_kernel", paged_fp, paged["bf16"]),
        row("paged_decode_int8", "tpu_composer_torch/csrc/paged_decode.cu",
            "tpu_composer/ops/paged_attention.py:41",
            "paged_attention.py::_kernel_quant", paged_int8,
            paged["int8_q_bf16"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
