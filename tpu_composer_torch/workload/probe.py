"""Staged accelerator probe: numbers, or a named-stage diagnosis (port of
``tpu_composer/workload/probe.py``).

The probe qualifies a card in ordered stages, each reported the moment it
completes:

  devnodes       ``/dev/nvidia*``, CUDA/NCCL/torch env, the NVIDIA kernel
                 module's version and the rendezvous endpoint (pure os,
                 in-process)
  backend_init   ``torch.cuda`` init: device name and count, CUDA and torch
  matmul         one 512² bf16 matmul
  flash_attn     the flash kernels (K1, B3, B4) against ``mha_reference``,
                 fwd and fwd+bwd, at head_dim 128 and seq 1k-8k
  qualify        ``qualify_slice`` (allreduce busbw + train-step TFLOP/s)
  qualify_large  the same on a 335M-parameter model at seq 2048
  decode         KV-cached decode tokens/s: bf16, int8, speculative, paged
                 over 128-token blocks (K2)

Stages after ``devnodes`` run in ONE subprocess that prints a
``STAGE_RESULT <json>`` line per completed stage; the parent tails the pipe
with a per-stage deadline. A hang therefore costs only the hanging stage's
timeout and still yields every earlier stage's numbers plus the name of the
stage that died and the subprocess's stderr tail, where the child's
watchdog has dumped every thread's stack.

Each stage record past ``matmul`` carries the stage's kernel launches
(``launches``, by kernel row) and the kernel sources the child had to
compile (``built``: empty when an earlier build in the same checkout is
loaded).

Left out of the JAX package's probe, with no H100 counterpart: the tunnel
short circuit and the loopback clamp (a card is local: there is no PJRT
tunnel or relay to preflight), the CPU fallback rerun (a card that does not
come up yields the diagnosis, never numbers from the CPU) and the TPU AOT
compile (kernels build from source on the card; there is no device-less
compile target). With ``device="cpu"`` asked for explicitly, the
card-only stages report ``skipped``, as JAX's do on a CPU backend.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tpu_composer_torch.device import DeviceLike, resolve_device
from tpu_composer_torch.workload.acceptance import _sync

# Each stage gets its own deadline, measured from the previous stage's
# completion. flash_attn may first build the kernels (nvcc, some tens of
# seconds when no earlier build is there) and runs the reference attention
# at seq 8192; decode runs seven generations of 128 tokens.
STAGE_TIMEOUTS_S: Dict[str, float] = {
    "backend_init": 120.0,
    "matmul": 60.0,
    "flash_attn": 600.0,
    "qualify": 300.0,
    "qualify_large": 420.0,
    "decode": 600.0,
}
STAGES = ("backend_init", "matmul", "flash_attn", "qualify",
          "qualify_large", "decode")

_CHILD = r"""
import faulthandler, json, os, sys, time

# Armed BEFORE torch is imported: if any stage wedges (a driver or CUDA
# init that never returns, a kernel that never ends), the blocking stack
# of every thread is dumped to stderr ~10 s before the parent's deadline,
# then the child exits, so the parent gets a failed-stage record with the
# evidence instead of a kill with none.
_budget = float(os.environ.get("TPUC_PROBE_STAGE_BUDGET_S", "120"))
faulthandler.dump_traceback_later(max(_budget - 10.0, 5.0), exit=True)

def emit(stage, t0, **kv):
    kv["stage"] = stage
    kv["seconds"] = time.time() - t0
    print("STAGE_RESULT " + json.dumps(kv), flush=True)

def rearm(budget):
    faulthandler.cancel_dump_traceback_later()
    faulthandler.dump_traceback_later(max(budget - 10.0, 5.0), exit=True)

_timeouts = json.loads(os.environ.get("TPUC_PROBE_TIMEOUTS", "{}"))
_device = os.environ.get("TPUC_PROBE_DEVICE", "cuda")

t0 = time.time()
from tpu_composer_torch.workload import probe
emit("backend_init", t0, **probe.backend_info(_device))

rearm(_timeouts.get("matmul", 60.0))
t0 = time.time()
emit("matmul", t0, **probe.matmul_on_device(_device))

def card_stage(stage, fn):
    # An enhancement pass: its error becomes the stage's record, so the
    # stages before it keep their evidence.
    rearm(_timeouts.get(stage, 600.0))
    t0 = time.time()
    if _device == "cpu":
        emit(stage, t0, skipped="meaningful on the card only")
        return
    before = probe.kernel_launches()
    try:
        rec = fn()
    except Exception as e:  # noqa: BLE001 - diagnosis, not control flow
        rec = {"error": f"{type(e).__name__}: {e}"}
    emit(stage, t0, **rec, **probe.launch_record(before))

card_stage("flash_attn", lambda: probe.flash_sweep_on_chip(_device))

rearm(_timeouts.get("qualify", 300.0))
t0 = time.time()
before = probe.kernel_launches()
from tpu_composer_torch.workload.acceptance import qualify_slice
results = qualify_slice(device=_device, batch=4, seq=512, allreduce_mb=16.0,
                        steps=5)
emit("qualify", t0, **results, **probe.launch_record(before))

card_stage("qualify_large", lambda: probe.qualify_large_on_chip(_device))
card_stage("decode", lambda: probe.decode_throughput_on_chip(device=_device))
faulthandler.cancel_dump_traceback_later()
"""


def kernel_launches() -> Dict[str, int]:
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


def launch_record(before: Dict[str, int]) -> Dict[str, Any]:
    """The launches since the counts ``before``, and the kernel sources
    this process compiled (``ops/_build.build_log``)."""
    from tpu_composer_torch.ops import _build

    after = kernel_launches()
    return {"launches": {k: after[k] - before[k] for k in after},
            "built": sorted(_build.build_log)}


def probe_rendezvous(env: Optional[Dict[str, str]] = None,
                     timeout_s: float = 1.0) -> List[Dict[str, Any]]:
    """TCP-preflight the rendezvous endpoint of the coordinate env
    (``MASTER_ADDR:MASTER_PORT``, ``admission/coordinates.slice_env``):
    when a multi-host bootstrap hangs, the first question is whether
    worker 0's host accepts connections there. Worker 0's own port is
    closed until its process listens. Empty without a ``MASTER_ADDR``.
    Bounded by ``timeout_s``: cannot wedge the probe."""
    e = os.environ if env is None else env
    host, port = e.get("MASTER_ADDR", ""), e.get("MASTER_PORT", "")
    if not host or not port.isdigit():
        return []
    rec: Dict[str, Any] = {"endpoint": f"{host}:{port}"}
    t0 = time.perf_counter()
    try:
        with socket.create_connection((host, int(port)), timeout=timeout_s):
            rec["reachable"] = True
            rec["connect_ms"] = (time.perf_counter() - t0) * 1e3
    except OSError as err:
        rec["reachable"] = False
        rec["error"] = f"{type(err).__name__}: {err}"
    return [rec]


def _driver_version() -> Optional[str]:
    try:
        with open("/proc/driver/nvidia/version") as f:
            return f.readline().strip()
    except OSError:
        return None


def probe_devnodes(env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Stage a: what does the host itself say about its GPUs?

    Pure filesystem/env enumeration, in-process, cannot hang: the NVIDIA
    device nodes, the CUDA, NCCL and torch env that decides what the
    child will bring up, the NVIDIA kernel module's version, and the
    rendezvous endpoint of the coordinate env ``env`` (default: this
    process's).
    """
    return {
        "nvidia_nodes": sorted(glob.glob("/dev/nvidia*")),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("CUDA_", "NCCL_", "TORCH_"))},
        "driver_version": _driver_version(),
        "rendezvous": probe_rendezvous(env),
    }


def backend_info(device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Bring up the device: the backend, device count and kind, and the
    CUDA and torch versions. Raises when the card does not come up."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {"torch_version": torch.__version__}
    if dev.type != "cuda":
        return {"backend": "cpu", "n_devices": 1, "device_kind": "cpu", **out}
    torch.cuda.init()
    return {"backend": "cuda", "n_devices": torch.cuda.device_count(),
            "device_kind": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0)),
            "cuda_version": torch.version.cuda, **out}


def matmul_on_device(device: DeviceLike = "cuda") -> Dict[str, Any]:
    """One 512² bf16 matmul of ones (every entry is 512, exact in bf16)."""
    dev = resolve_device(device)
    x = torch.ones((512, 512), dtype=torch.bfloat16, device=dev)
    y = x @ x
    return {"ok": bool((y == 512).all()),
            "result_dtype": str(y.dtype).replace("torch.", "")}


def _ms_per_call(fn: Callable, iters: int, dev: torch.device) -> float:
    """ms per call of ``fn`` over ``iters`` back-to-back calls: CUDA
    events around them on the card (device time, the work queued behind
    the first event), the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_attention_on_chip(
    batch: int = 2, heads: int = 8, seq: int = 1024, head_dim: int = 128,
    kv_heads: Optional[int] = None, check_numerics: bool = True,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """The flash kernels on the device: fwd and fwd+bwd through the
    flash path (K1 without lse for the forward; K1 with lse, B3 and B4
    under autograd) and through ``mha_reference``, bf16, causal; the
    numerics checked and both timed at the given shape. Inputs are
    (B, S, H, D), as the attention APIs take them.

    Times are ms a call over 8 back-to-back calls, the best of 2, with
    CUDA events on the card (host clock on the CPU). The backward is
    timed as forward + backward of all three gradients, as JAX keeps all
    of them live."""
    from tpu_composer_torch.ops.attention import flash_attention, mha_reference

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    hk = kv_heads or heads
    q, k, v = (torch.randn((batch, seq, h, head_dim), generator=gen)
               .to(dev, torch.bfloat16) for h in (heads, hk, hk))

    def f_fwd():
        return flash_attention(q, k, v, causal=True)

    def r_fwd():
        return mha_reference(q, k, v, causal=True)

    def grads(attn):
        def run():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attn(*leaves, causal=True).float().sum()
            return torch.autograd.grad(out, leaves)
        return run

    f_grad, r_grad = grads(flash_attention), grads(mha_reference)

    fwd_err = bwd_err = None
    if check_numerics:
        fwd_err = float((f_fwd().float() - r_fwd().float()).abs().max())
        bwd_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(f_grad(), r_grad()))

    def bench(fn, iters: int = 8, reps: int = 2) -> float:
        fn()  # warm: kernel loads, allocator
        _sync(dev)
        return min(_ms_per_call(fn, iters, dev) for _ in range(reps))

    flash_ms, ref_ms = bench(f_fwd), bench(r_fwd)
    flash_bwd_ms, ref_bwd_ms = bench(f_grad), bench(r_grad)
    rec: Dict[str, Any] = {
        "seq": seq,
        "batch": batch,
        "heads": heads,
        "kv_heads": hk,
        "flash_fwd_ms": flash_ms,
        "ref_fwd_ms": ref_ms,
        "flash_bwd_ms": flash_bwd_ms,
        "ref_bwd_ms": ref_bwd_ms,
        "fwd_speedup": ref_ms / flash_ms,
        "bwd_speedup": ref_bwd_ms / flash_bwd_ms,
    }
    if check_numerics:
        # The JAX package's bf16 envelope: rounding error over seq-length
        # dot products grows ~sqrt(S), anchored at S = 2048.
        tol = max(1.0, (seq / 2048.0) ** 0.5)
        rec["numerics_ok"] = fwd_err < 0.1 * tol and bwd_err < 0.5 * tol
        rec["fwd_max_err"] = fwd_err
        rec["bwd_max_err"] = bwd_err
    return rec


# The flash kernels' operating envelope (the JAX package's sweep): seq
# 1k-8k, MHA, GQA and MQA fan-in; numerics asserted up to seq 4096, the
# 8192 config timing-only.
FLASH_SWEEP = (
    dict(batch=2, heads=8, seq=1024, check_numerics=True),
    dict(batch=2, heads=8, kv_heads=2, seq=2048, check_numerics=True),
    dict(batch=1, heads=8, kv_heads=2, seq=4096, check_numerics=True),
    dict(batch=1, heads=4, kv_heads=1, seq=8192, check_numerics=False),
)


def flash_sweep_on_chip(device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The flash kernels' report card across :data:`FLASH_SWEEP` on the
    card. Headline fields summarize the long-seq regime (>= 4096) by the
    worst config, so one winning config cannot mask a losing one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"skipped": f"device is {dev.type}, not cuda"}
    out: Dict[str, Any] = {"configs": []}
    for c in FLASH_SWEEP:
        try:
            rec = flash_attention_on_chip(**c, device=dev)
        except Exception as e:  # noqa: BLE001 - keep earlier configs' data
            rec = {"seq": c["seq"], "error": f"{type(e).__name__}: {e}"}
        out["configs"].append(rec)
    longs = [r for r in out["configs"]
             if r.get("seq", 0) >= 4096 and "fwd_speedup" in r]
    if longs:
        out["fwd_speedup_long"] = min(r["fwd_speedup"] for r in longs)
        out["bwd_speedup_long"] = min(r["bwd_speedup"] for r in longs)
    nums = [r for r in out["configs"] if "numerics_ok" in r]
    if nums:
        out["numerics_ok"] = all(r["numerics_ok"] for r in nums)
    return out


# The qualification model sized for the card's tensor cores: d_model
# 2048, d_ff 8192, 16 heads of 128, vocab 32768, seq 2048, bf16 flash.
QUALIFY_LARGE = dict(vocab_size=32768, d_model=2048, n_layers=4,
                     n_heads=16, d_ff=8192, max_seq=2048)


def qualify_large_on_chip(device: DeviceLike = "cuda") -> Dict[str, Any]:
    """``qualify_slice`` on :data:`QUALIFY_LARGE` at batch 8, seq 2048,
    3 steps, a 64 MB allreduce."""
    from tpu_composer_torch.models.transformer import ModelConfig
    from tpu_composer_torch.workload.acceptance import qualify_slice

    big = ModelConfig(dtype=torch.bfloat16, attn_impl="flash",
                      **QUALIFY_LARGE)
    return qualify_slice(device=device, batch=8, seq=2048, model_config=big,
                         allreduce_mb=64.0, steps=3)


def _best_wall_s(fn: Callable, dev: torch.device, reps: int = 3) -> float:
    """Warm once, then the best of ``reps`` wall seconds around ``fn()``
    and a device synchronize: a generation is a host-driven loop of
    launches, so its wall time is what a caller waits."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def decode_throughput_on_chip(
    batch: int = 8,
    prompt_len: int = 128,
    new_tokens: int = 128,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """KV-cached greedy decode tokens/s: bf16 against the fully quantized
    path (int8 weights + int8 KV cache), speculative decoding at batch 1
    (an int8 self-draft, gamma 4) against greedy at batch 1, and the
    paged cache over 128-token blocks through K2. A mid-size config
    (d_model 1024, 8 layers, 16 heads over 4 KV heads) so that weight
    streaming dominates. Each later part first prints the record so far
    as ``STAGE_PARTIAL decode``, so that a watchdog exit inside it keeps
    the earlier numbers."""
    from tpu_composer_torch.models.decode import generate
    from tpu_composer_torch.models.paged import paged_generate
    from tpu_composer_torch.models.quant import quantize_decode_params
    from tpu_composer_torch.models.speculative import speculative_generate
    from tpu_composer_torch.models.transformer import ModelConfig, init_params

    dev = resolve_device(device)
    c = ModelConfig(vocab_size=32768, d_model=1024, n_layers=8, n_heads=16,
                    n_kv_heads=4, d_ff=4096,
                    max_seq=prompt_len + new_tokens, dtype=torch.bfloat16)
    params = init_params(c, 0, device=dev)
    qparams = quantize_decode_params(params)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, c.vocab_size, (batch, prompt_len),
                           generator=gen, dtype=torch.int32).to(dev)

    out: Dict[str, Any] = {
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
        "model": "d1024 L8 H16 kv4 ff4096 bf16",
    }
    for tag, p, quant in (("bf16", params, False),
                          ("int8_w_int8_kv", qparams, True)):
        best = _best_wall_s(lambda p=p, quant=quant: generate(
            p, prompt, c, max_new_tokens=new_tokens, kv_quant=quant), dev)
        out[f"{tag}_tokens_per_s"] = batch * new_tokens / best
        out[f"{tag}_ms_per_token"] = best / new_tokens * 1e3
    out["quant_speedup"] = (out["int8_w_int8_kv_tokens_per_s"]
                            / out["bf16_tokens_per_s"])

    print("STAGE_PARTIAL decode " + json.dumps(out), flush=True)
    try:
        gamma = 4
        p1 = prompt[:1]

        def base():
            return generate(params, p1, c, max_new_tokens=new_tokens)

        def spec():
            # The verify chunk can write up to gamma past the last kept
            # token; the cache must hold it.
            return speculative_generate(
                params, qparams, p1, c, max_new_tokens=new_tokens,
                gamma=gamma, max_seq=prompt_len + new_tokens + gamma)

        base()
        spec()
        _sync(dev)
        best_b = best_s = float("inf")
        # In turns, so that drift hits both alike.
        for _ in range(3):
            t0 = time.perf_counter()
            base()
            _sync(dev)
            best_b = min(best_b, time.perf_counter() - t0)
            t0 = time.perf_counter()
            spec()
            _sync(dev)
            best_s = min(best_s, time.perf_counter() - t0)
        out["greedy_b1_tokens_per_s"] = new_tokens / best_b
        out["spec_b1_tokens_per_s"] = new_tokens / best_s
        out["spec_speedup"] = best_b / best_s
    except Exception as e:  # noqa: BLE001 - keep the quant evidence
        out["spec_error"] = f"{type(e).__name__}: {e}"

    print("STAGE_PARTIAL decode " + json.dumps(out), flush=True)
    try:
        blocks_needed = -(-(prompt_len + new_tokens) // 128) * batch
        best_p = _best_wall_s(lambda: paged_generate(
            params, prompt, c, max_new_tokens=new_tokens,
            num_blocks=blocks_needed, block_size=128,
            attn_impl="kernel"), dev)
        out["paged_kernel_tokens_per_s"] = batch * new_tokens / best_p
        out["paged_vs_dense"] = (out["paged_kernel_tokens_per_s"]
                                 / out["bf16_tokens_per_s"])
    except Exception as e:  # noqa: BLE001 - keep the earlier evidence
        out["paged_error"] = f"{type(e).__name__}: {e}"
    return out


def staged_accelerator_probe(
    repo_root: Optional[str] = None,
    timeouts: Optional[Dict[str, float]] = None,
    retries: int = 1,
    device: DeviceLike = "cuda",
    env: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Run all stages; return {stages: {...}, completed: [...], failed_stage,
    diagnosis}. Never raises, never hangs past the per-stage deadlines.

    ``env`` (a worker's coordinate env) is added to the child's
    environment and names the rendezvous ``devnodes`` checks.
    backend_init gets ``retries`` extra attempts, a fresh subprocess each;
    each attempt's evidence is kept under ``diagnosis``. A card that does
    not come up yields the diagnosis, never a rerun on the CPU."""
    timeouts = {**STAGE_TIMEOUTS_S, **(timeouts or {})}
    dev = torch.device(device)
    devnodes = probe_devnodes(env)

    child_env = {**os.environ, **(env or {})}
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    child_env["PYTHONPATH"] = root + os.pathsep + child_env.get("PYTHONPATH", "")
    child_env["TPUC_PROBE_STAGE_BUDGET_S"] = str(timeouts["backend_init"])
    child_env["TPUC_PROBE_TIMEOUTS"] = json.dumps(timeouts)
    child_env["TPUC_PROBE_DEVICE"] = dev.type

    failed_attempts: List[Dict[str, Any]] = []
    for attempt in range(retries + 1):
        stages, completed, failed_stage, stderr_tail = _drive_child(
            child_env, timeouts, list(STAGES)
        )
        if failed_stage != "backend_init" or attempt == retries:
            break
        failed_attempts.append(
            {"failed_stage": failed_stage, "stderr_tail": stderr_tail}
        )

    stages["devnodes"] = devnodes
    completed = ["devnodes"] + completed
    result: Dict[str, Any] = {"stages": stages, "completed": completed}
    if failed_stage:
        result["failed_stage"] = failed_stage
        result["diagnosis"] = {
            "timeout_s": timeouts.get(failed_stage),
            "stderr_tail": stderr_tail,
            "nvidia_nodes_present": bool(devnodes["nvidia_nodes"]),
            "driver_version": _driver_version(),
            "rendezvous": probe_rendezvous(env),
            "attempts": len(failed_attempts) + 1,
        }
        if failed_attempts:
            result["diagnosis"]["earlier_attempts"] = failed_attempts
    return result


def _drive_child(
    env: Dict[str, str], timeouts: Dict[str, float], order: List[str]
) -> Tuple[Dict[str, Any], List[str], Optional[str], List[str]]:
    """One subprocess pass over the post-devnodes stages: returns
    (stages, completed, failed_stage, stderr_tail)."""
    stages: Dict[str, Any] = {}
    completed: List[str] = []

    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", _CHILD],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
    )

    stderr_buf: List[str] = []
    t_err = threading.Thread(
        target=lambda: stderr_buf.extend(proc.stderr),  # type: ignore[arg-type]
        name="probe-stderr-reader", daemon=True,
    )
    t_err.start()

    lines: List[str] = []
    done = threading.Event()

    def reader():
        for line in proc.stdout:  # type: ignore[union-attr]
            lines.append(line)
        done.set()

    t_out = threading.Thread(
        target=reader, name="probe-stdout-reader", daemon=True
    )
    t_out.start()

    failed_stage: Optional[str] = None
    idx = 0
    partials: Dict[str, Any] = {}

    def drain() -> None:
        nonlocal idx
        while idx < len(lines):
            line = lines[idx]
            idx += 1
            if line.startswith("STAGE_RESULT "):
                rec = json.loads(line[len("STAGE_RESULT "):])
                stages[rec.pop("stage")] = rec
            elif line.startswith("STAGE_PARTIAL "):
                # Provisional evidence a stage emits before entering a
                # risky section: kept if the stage later dies in a way no
                # in-child except can catch (watchdog exit, parent kill);
                # superseded by the stage's final record.
                name, _, payload = line[len("STAGE_PARTIAL "):].partition(" ")
                try:
                    partials[name] = json.loads(payload)
                except ValueError:
                    pass

    try:
        for stage in order:
            deadline = time.monotonic() + timeouts[stage]
            while time.monotonic() < deadline:
                drain()
                if stage in stages or done.is_set():
                    break
                time.sleep(0.2)
            # The reader may have appended final lines between the last
            # drain and observing done: drain once more before declaring a
            # stage failed.
            drain()
            if stage in stages:
                completed.append(stage)
            else:
                failed_stage = stage
                break

        if failed_stage is None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            if proc.returncode not in (0, None) and order[-1] not in stages:
                failed_stage = next(s for s in order if s not in stages)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()

    # Fold in partials for stages that never produced a final record,
    # marked so consumers know the stage died after these numbers.
    for name, rec in partials.items():
        if name not in stages:
            stages[name] = {**rec, "partial": True}

    t_err.join(timeout=5)
    # 40 lines of tail: enough to keep a full faulthandler thread dump.
    tail = "".join(stderr_buf).strip().splitlines()[-40:]
    return stages, completed, failed_stage, tail
