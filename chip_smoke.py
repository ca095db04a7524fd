#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold every
CUDA kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the ``tpu_composer_torch`` package beside
this file; it exits nonzero without them. Each phase prints one JSON
line and checks its own result; any failure raises and the script exits
nonzero. Phases, in order:

1. ``card``: the card, its power limit, torch and CUDA versions. The
   raw ``nvidia-smi --query-gpu=name,power.limit`` line follows it.
2. ``build``: nvcc seconds per kernel source (both compile at once) and
   ptxas's register / shared-memory report.
3. ``flash_fwd``: kernel K1 against its plain version over B in {1, 2},
   S in {8, 64, 256, 512}, H=8, KV=2, D=64, causal or not, bf16 and fp32,
   with and without lse; times at the serving prefill shape.
4. ``paged_decode``: kernel K2 against the gather path at the engine's
   decode shape (B=8, H=8, KV=2, Dh=64, Bs=16, MB=32), lengths in
   1..512 plus a 0-length row and stale table slots; fp32, bf16, int8.
5. ``serve_exact``: the flagship at full width in fp32, prefill through
   K1 and decode through K2: every request's tokens equal the port's
   solo ``generate`` with reference attention.
6. ``serve``: the flagship in bf16: 16 greedy and sampled requests
   through an 8-slot engine, then an int8-pool engine with chunked
   admission and a shared prefix; tokens/s, step p50, launch counts.
7. the kernels line ``{"kernels": [...]}``: per kernel its launches on
   the main path (phases 5-6), max error, kernel / plain / library ms and
   the bound.
8. the last line: ``{"ok": true, "device": {...}}``.

Tolerances (absolute): K1 fp32 1e-4, bf16 2e-2, lse 1e-4. K2 fp32 1e-4;
bf16 2e-2 (the kernel keeps P in fp32, the gather path rounds P to bf16
first). First-token logits of the bf16 engine against the plain path
5e-2; of the int8-pool engine against an unquantized prefill 1e-1.
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
LSE_TOL = 1e-4
LOGIT_TOL_BF16 = 5e-2
LOGIT_TOL_INT8 = 1e-1


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events; inputs stay warm in L2 between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    seconds = _build.build(["flash_fwd", "paged_decode"])
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for name, (_, log) in _build.build_log.items()}
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0,
         ptxas=ptxas)


def phase_flash(gen: torch.Generator) -> dict:
    from tpu_composer_torch.ops.attention import (
        flash_fwd_cuda,
        flash_fwd_plain,
    )

    h, kv, d = 8, 2, 64
    errs = {}
    # The flagship's head_dim 64 at every shape, and the kernel's other
    # head_dim, 128, at one ragged length.
    shapes = [(b, s, d) for b in (1, 2) for s in (8, 64, 256, 512)]
    shapes.append((1, 100, 128))
    for dtype in (torch.float32, torch.bfloat16):
        worst = worst_lse = 0.0
        for b, s, dd in shapes:
            q = torch.randn(b, s, h, dd, generator=gen).to("cuda", dtype)
            k = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            v = torch.randn(b, s, kv, dd, generator=gen).to("cuda", dtype)
            for causal in (False, True):
                for with_lse in (False, True):
                    got, lse = flash_fwd_cuda(q, k, v, causal, with_lse)
                    want, lse_w = flash_fwd_plain(q, k, v, causal,
                                                  with_lse)
                    torch.cuda.synchronize()
                    worst = max(worst, max_err(got, want))
                    if with_lse:
                        worst_lse = max(worst_lse, max_err(lse, lse_w))
        name = str(dtype).replace("torch.", "")
        errs[name] = {"out": worst, "lse": worst_lse}
        check(worst <= TOL[dtype], f"flash_fwd {name} error {worst}")
        check(worst_lse <= LSE_TOL, f"flash_fwd {name} lse error {worst_lse}")

    # The serving prefill shape: one prompt padded to its 256 bucket.
    b, s, dtype = 1, 256, torch.bfloat16
    q = torch.randn(b, s, h, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, s, kv, d, generator=gen).to("cuda", dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {
        "shape": [b, s, h, kv, d], "dtype": "bfloat16", "causal": True,
        "ms": cuda_ms(lambda: flash_fwd_cuda(q, k, v, True)),
        "plain_ms": cuda_ms(lambda: flash_fwd_plain(q, k, v, True)),
        "library_ms": cuda_ms(
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    pairs = s * (s + 1) // 2  # causal (q, k) pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    timing["bound_ms"], timing["bound_by"] = bound_ms(
        n_bytes, 4 * b * h * pairs * d, dtype)
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
            t = {"ms": cuda_ms(lambda: paged_decode_cuda(*args)),
                 "plain_ms": cuda_ms(lambda: paged_decode_plain(*args)),
                 "library_ms": None, "max_abs_err": worst,
                 "lengths": args[4].tolist()}
            t["bound_ms"], t["bound_by"] = _paged_bound(args)
            timing[name] = t
    emit("paged_decode", errors=errs,
         tol={"fp32": 1e-4, "bf16": 2e-2}, shape=[8, 8, 2, 64, 16, 32, 256],
         timing=timing)
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


def _device_share(eng, n_steps: int = 8) -> dict:
    """Device busy share over a few decode steps (torch.profiler): summed
    kernel time over host wall time, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": n_steps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if busy else None,
            "kernel_launches": sum(e.count for e in events),
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3,
                             e.count] for e in top]}


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
    results["profile"] = _device_share(eng)
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

    gen = torch.Generator().manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    card = phase_card()
    phase_build()
    flash = phase_flash(gen)
    paged = phase_paged(gen)

    from tpu_composer_torch.ops.attention import flash_fwd_cuda
    from tpu_composer_torch.ops.paged_attention import paged_decode_cuda

    # The main path: every count starts at 0 here and is read after it.
    flash_fwd_cuda.launches = 0
    paged_decode_cuda.launches = 0
    exact = phase_serve_exact(rng, args.seed)
    serve = phase_serve(rng, args.seed)
    flash_launches = flash_fwd_cuda.launches
    paged_int8 = serve["int8"]["launches"]["paged_decode"]
    paged_fp = paged_decode_cuda.launches - paged_int8
    check(flash_launches > 0 and paged_fp > 0 and paged_int8 > 0,
          "a kernel of the main path was never launched")

    def row(name, source, replaces, function, launches, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "function": function,
                "launches": launches, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("flash_fwd", "tpu_composer_torch/csrc/flash_fwd.cu",
            "tpu_composer/ops/attention.py:189",
            "attention.py::_fwd_kernel_nolse (and ::_fwd_kernel, with lse)",
            flash_launches, flash),
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
